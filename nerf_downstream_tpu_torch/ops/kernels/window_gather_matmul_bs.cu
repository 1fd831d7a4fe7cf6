// K5 window_gather_matmul_bs: the block-sparse forward of a windowed sparse
// convolution, for pruned checkpoints.
//
// Replaces the Pallas TPU kernel window_gather_matmul_pallas_bs
// (nerf_downstream_tpu/ops/pallas/window_gather.py:284, body _fwd_kernel_bs
// :211 and _gather_members_subset :189): K2's sum restricted to the live
// (Cin-block, Cout-block) pairs of each member (g, m) at granularity
// `block`,
//
//   out[t*T + i] = sum over (g, m) of feats[starts[g, t] + idx[g, t, m, i]]
//                  @ (w[g, m] * live[g, m] expanded to [C, Cout])
//
// accumulated in f32 and rounded once into the output type (the input
// type). A dead pair contributes nothing even where its weights are not
// zero: the weights reach the kernel zero on every dead block (the wrapper
// multiplies them by the expanded liveness, one elementwise pass, unless
// the caller keeps them so between calls), so the kernel may skip work
// but never has to mask.
//
// The TPU kernel bakes the liveness into the compiled kernel as a nested
// tuple, gathers with a one-hot matmul over a packed copy of the live
// input columns of the window, and runs one matmul per live pair, all
// because Mosaic cannot gather rows. Here the liveness is data, a
// uint8[G, M, nbi, nbo] tensor, so one build serves every layer and every
// granularity, and the kernel is K2's core (window_gather.cuh) with a
// liveness policy: for its 64-column output tile a block skips
//   - a member with no live pair in that tile (no gather at all), and
//   - a 16-channel input chunk whose blocks are all dead in that tile.
// Both tests are cooperative (each thread reads a few liveness bytes, then
// one __syncthreads_or), so they cost one barrier per member and chunk.
// At granularity 128 the skipped work is whole chunks; at granularities
// below 16 a chunk is live when any block it overlaps is, and the
// multiplied weights zero the rest.
//
// Bound on the H100: the live work only, 2 x (live channel pairs) per
// present plan entry at the bf16 tensor-core peak, against the features,
// the plan, the live weights and the output moved once. Like K2 this first
// version multiplies on the f32 CUDA cores, so it reaches neither bound;
// what it keeps is K2's time scaled by the share of live chunks.

#include <cstdint>

#include "window_gather.cuh"

namespace ndt {

struct BlockLive {
  static constexpr bool kAlways = false;
  const uint8_t* live;  // [terms, nbi, nbo]
  int nbi, nbo, block, c, cout;

  // this thread's share of "any live (bi, bo) with bi in [bi0, bi1] and
  // bo in the blocks of output columns [col0, col0 + kBN)"
  __device__ bool any(int q, int bi0, int bi1, int col0, int tid) const {
    const int bo0 = col0 / block;
    const int bo1 = (min(col0 + kBN, cout) - 1) / block;
    const int n_bo = bo1 - bo0 + 1;
    const int total = (bi1 - bi0 + 1) * n_bo;
    const uint8_t* l = live + static_cast<long long>(q) * nbi * nbo;
    for (int p = tid; p < total; p += kThreads) {
      const int bi = bi0 + p / n_bo;
      if (l[bi * nbo + bo0 + p % n_bo]) return true;
    }
    return false;
  }
  __device__ bool term(int q, int col0, int tid) const {
    return any(q, 0, nbi - 1, col0, tid);
  }
  __device__ bool chunk(int q, int k0, int col0, int tid) const {
    return any(q, k0 / block, (min(k0 + kBK, c) - 1) / block, col0, tid);
  }
};

}  // namespace ndt

// feats [n_rows, c], w [G, M, c, cout] (already multiplied by the expanded
// liveness) and out [n_tiles * tile, cout] share the type (bf16: 1 for
// bfloat16, 0 for float32); live uint8[G, M, nbi, nbo] with
// nbi = ceil(c / block), nbo = ceil(cout / block).
extern "C" int window_gather_matmul_bs_launch(
    const void* feats, int n_rows, int c, const int32_t* starts,
    const int32_t* idx, const void* w, const uint8_t* live, int nbi, int nbo,
    int block, int groups, int n_tiles, int members, int tile, int cout,
    void* out, int bf16, void* stream) {
  if (n_tiles <= 0 || tile <= 0 || cout <= 0 || block <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ndt::PlanRows rows{starts, idx, n_tiles, members, tile, n_rows};
  const ndt::BlockLive lv{live, nbi, nbo, block, c, cout};
  const long long n_out = static_cast<long long>(n_tiles) * tile;
  if (bf16)
    return ndt::launch_core<__nv_bfloat16, __nv_bfloat16>(
        feats, c, rows, lv, w, groups * members, n_out, cout, out, s);
  return ndt::launch_core<float, float>(feats, c, rows, lv, w,
                                        groups * members, n_out, cout, out,
                                        s);
}
