// K4 window_dw: the weight gradient of a windowed sparse convolution whose
// input takes no gradient (the stem conv, input_grad=False).
//
// Replaces the Pallas TPU kernel window_dw_pallas
// (nerf_downstream_tpu/ops/pallas/window_gather.py:590, body _dw_kernel
// :565):
//
//   d_w[g, m] = sum over (t, i) of feats[starts[g, t] + idx[g, t, m, i]]^T
//               (x) g_out[t*T + i]                      -> [G, M, C, Cout] f32
//
// over the forward plan; absent entries and ranks past the table add
// nothing (so the reference's blocks * window padding rows are not needed).
// Inputs are float32 or bfloat16 (the compute type); products and sums are
// f32.
//
// Bound on the H100 at its one call per training step (conv0a of the 64k
// batch: 65,536 rows, C = 27, Cout = 32, G x M = 27, ~1.2M present
// entries): bytes. Its 2 C Cout = 1.7 kFLOP per present entry take ~2 us
// at the bf16 tensor-core peak; reading the features, the output gradient
// and idx once (~15 MB) takes ~4.5 us at 3.35 TB/s. This first version is
// far from either: products run on the f32 CUDA cores, C = 27 and
// Cout = 32 fill a quarter of each 64 x 64 block tile, and absent entries
// are skipped only 64 rows at a time.
//
// Design: window_dw.cuh (gathered features, direct output gradient), with
// the fixed-order reduction over row chunks described there.

#include <cstdint>

#include "window_dw.cuh"

// feats [n_in, c], g_out [n_tiles * tile, cout] share the type (bf16: 1 for
// bfloat16, 0 for float32); part holds [chunks, G, M, c, cout] f32 with
// chunks = ceil(n_tiles * tile / chunk_rows); d_w [G, M, c, cout] f32.
extern "C" int window_dw_launch(const void* feats, int n_in, int c,
                                const int32_t* starts, const int32_t* idx,
                                const void* g_out, int cout, int groups,
                                int n_tiles, int members, int tile,
                                int chunk_rows, float* part, float* d_w,
                                int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ndt::launch_dw<__nv_bfloat16, true>(
        feats, c, g_out, cout, n_in, starts, idx, groups, n_tiles, members,
        tile, chunk_rows, part, d_w, s);
  return ndt::launch_dw<float, true>(feats, c, g_out, cout, n_in, starts,
                                     idx, groups, n_tiles, members, tile,
                                     chunk_rows, part, d_w, s);
}
