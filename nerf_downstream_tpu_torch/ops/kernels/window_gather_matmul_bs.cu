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
// granularity, and the kernel is K2's with a liveness policy (BlockLive).
//
// Bound on the H100: the live work only (chip_smoke.py::k5_work), 2 x (live
// channel pairs of the member) FLOP per present plan entry at the bf16
// tensor-core peak (989 TFLOP/s), against the features, the plan, the
// liveness, the live weights and the output moved once at 3.35 TB/s. At
// the csr-32 forward of the 64k eval batch that is operations at the fine
// levels and about 0.07 ms in all.
//
// Two cores, chosen by the input type alone, as for K2:
// - bfloat16 (the pruned-eval path): K2's tensor-core core
//   (window_gather_tc.cuh) with K2's column tile and term split
//   (ops/kernels/tc.py). In the pass that resolves the rows of up to 32
//   terms, each warp ballots, per term, one bit per 32-channel chunk that
//   has a live block under the block's column tile; the loop then steps
//   over (live term, live chunk) only, with no barrier beyond K2's. A
//   skipped step would have added exact zeros, and the terms are added in
//   K2's order with K2's split, so on finite inputs the output equals K2's
//   bf16 output on the masked weights, bit for bit.
// - float32: window_gather.cuh's CUDA-core core with the cooperative
//   BlockLive tests: a block skips a member with no live pair under its
//   64-column tile and a 16-channel chunk whose blocks are all dead there,
//   one __syncthreads_or each; equal to K2's f32 output on the masked
//   weights, bit for bit, on finite inputs.
// At granularities below a step's depth a step runs when any block it
// overlaps is live, and the zero weights of the rest add nothing.
//
// NaN: a NaN in a present input row reaches every output that a live
// block multiplies it into, and nothing through a skipped step, as in the
// reference, which skips dead pairs. Inside a step that runs, a dead
// block's zero weights carry it (0 x NaN) to the other columns of the
// block's column tile; where the granularity is a multiple of 32 and of
// the column tile (csr at 128 on the 128- and 256-wide convs), the steps
// are the blocks and NaN reaches exactly the live blocks' outputs.

#include <cstdint>

#include "window_gather_tc.cuh"

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
  // CUDA-core core: cooperative tests per 64-column tile
  __device__ bool term(int q, int col0, int tid) const {
    return any(q, 0, nbi - 1, col0, tid);
  }
  __device__ bool chunk(int q, int k0, int col0, int tid) const {
    return any(q, k0 / block, (min(k0 + kBK, c) - 1) / block, col0, tid);
  }
  // tensor-core core: one thread's test of channels [k0, k1) x columns
  // [col0, col1), both clipped to the matrix
  __device__ bool live_under(int q, int k0, int k1, int col0,
                             int col1) const {
    const int bi1 = (min(k1, c) - 1) / block;
    const int bo0 = col0 / block, bo1 = (min(col1, cout) - 1) / block;
    const uint8_t* l = live + static_cast<long long>(q) * nbi * nbo;
    for (int bi = k0 / block; bi <= bi1; ++bi)
      for (int bo = bo0; bo <= bo1; ++bo)
        if (l[bi * nbo + bo]) return true;
    return false;
  }
};

}  // namespace ndt

// feats [n_rows, c], w [G, M, c, cout] (already multiplied by the expanded
// liveness) and out [n_tiles * tile, cout] share the type (bf16: 1 for
// bfloat16, 0 for float32); live uint8[G, M, nbi, nbo] with
// nbi = ceil(c / block), nbo = ceil(cout / block). bf16 only (as K2's
// launch): bn the column tile, parts and per the term split, part f32
// scratch [parts, n_tiles * tile, cout] when parts > 1; c <= 1,024.
extern "C" int window_gather_matmul_bs_launch(
    const void* feats, int n_rows, int c, const int32_t* starts,
    const int32_t* idx, const void* w, const uint8_t* live, int nbi, int nbo,
    int block, int groups, int n_tiles, int members, int tile, int cout,
    void* out, int bf16, int bn, int parts, int per, float* part,
    void* stream) {
  if (n_tiles <= 0 || tile <= 0 || cout <= 0 || block <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ndt::BlockLive lv{live, nbi, nbo, block, c, cout};
  if (bf16)
    return ndt::tc::launch_gather_matmul(feats, n_rows, c, starts, idx, w,
                                         groups, n_tiles, members, tile,
                                         cout, bn, parts, per, part, out, s,
                                         lv);
  const ndt::PlanRows rows{starts, idx, n_tiles, members, tile, n_rows};
  const long long n_out = static_cast<long long>(n_tiles) * tile;
  return ndt::launch_core<float, float>(feats, c, rows, lv, w,
                                        groups * members, n_out, cout, out,
                                        s);
}
