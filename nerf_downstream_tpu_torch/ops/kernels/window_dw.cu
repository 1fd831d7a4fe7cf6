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
// and idx once (~15 MB) takes ~4.5 us at 3.35 TB/s.
//
// The input type picks the kernel, and nothing else does (the wrapper,
// dw.py, picks the tiles, the row chunks and the scratch from it):
// - bfloat16 (the training path): window_dw_tc.cuh's tensor-core d_w with
//   the features as the gathered side (kGatherX): rows are the mma's k
//   dimension, 32-row steps with no present entry are skipped, gathered
//   feature rows and direct gradient rows staged by cp.async with zero
//   fill (element by element at the stem's C = 27), tiles of 32-96 per
//   width (32 x 32 at the stem) and row chunks for about 2,048 warps
//   (ops/kernels/tc.py), K3's d_w kernel with the sides swapped.
// - float32: window_dw.cuh's CUDA-core kernel (64 x 64 tiles of f32 fmaf,
//   at most 16 row chunks).
// Both write one f32 partial per row chunk, added in a fixed order by
// dw_reduce_kernel: d_w is bit-identical from run to run.

#include <cstdint>

#include "window_dw_tc.cuh"

// feats [n_in, c], g_out [n_tiles * tile, cout] share the type (bf16: 1 for
// bfloat16, 0 for float32); part holds [chunks, G, M, c, cout] f32 with
// chunks = ceil(n_tiles * tile / chunk_rows); d_w [G, M, c, cout] f32.
// bf16 only: bc, bo are the tiles.
extern "C" int window_dw_launch(const void* feats, int n_in, int c,
                                const int32_t* starts, const int32_t* idx,
                                const void* g_out, int cout, int groups,
                                int n_tiles, int members, int tile,
                                int chunk_rows, float* part, float* d_w,
                                int bf16, int bc, int bo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ndt::tc::launch_dw<true>(feats, c, g_out, cout, n_in, starts, idx,
                                    groups, n_tiles, members, tile,
                                    chunk_rows, bc, bo, part, d_w, s);
  return ndt::launch_dw<float, true>(feats, c, g_out, cout, n_in, starts,
                                     idx, groups, n_tiles, members, tile,
                                     chunk_rows, part, d_w, s);
}
