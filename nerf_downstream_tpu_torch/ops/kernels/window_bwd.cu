// K3 window_bwd: the backward of a windowed sparse convolution, d_feats and
// d_w over the inverse plan.
//
// Replaces the Pallas TPU kernel window_bwd_pallas
// (nerf_downstream_tpu/ops/pallas/window_gather.py:504, body _bwd_kernel
// :459). With parts[g, m][j] = g_out[inv_starts[g, t] + inv_idx[g, t, m, i]]
// for input row j = t*T + i (nothing when the entry is absent or its rank
// lands past the n_out rows of g_out):
//
//   d_feats[j] = sum over (g, m) of parts[g, m][j] @ w_t[g, m]
//                                          -> [N_in, C] in the input type
//   d_w[g, m]  = sum over j of feats[j]^T (x) parts[g, m][j]
//                                          -> [G, M, C, Cout] f32
//
// The inverse plan pairs the same (input, output) rows as the forward
// plan, so this d_w equals K4's over the forward plan (the windowed pair
// sets of a plan and its transpose are the same; escaped pairs ride the
// side list, differentiated by autograd).
//
// Bound on the H100: operations at the wide fine-level convs. The heaviest
// calls of a 64k training step (65,536 rows, C = 96..128, Cout = 96,
// G x M = 27, ~1.2M present entries) need 4 C Cout FLOP per present entry
// (both halves), ~45 us at the bf16 tensor-core peak, against ~14 us to
// move g_out, feats, inv_idx and the outputs once at 3.35 TB/s. At the
// coarse levels (512-3,584 rows) the work is a few microseconds; there the
// limit is how many SMs get a block.
//
// Design: the Pallas kernel fuses both halves into one sweep so the window
// DMA is paid once. On Hopper the halves want different block layouts:
// d_feats is a row-parallel gather-matmul (K2's core run on g_out with the
// inverse plan and the channel-transposed weights), while d_w is a
// reduction over rows (blocks own a (row chunk, g, m, C tile, Cout tile)
// slice). So K3 launches the two one after the other on the stream, and
// the gathered g_out rows are read twice, mostly from L2. One fused sweep
// is later work. d_w is reduced across row chunks in a fixed order: it is
// bit-identical from run to run.
//
// The input type picks the cores, and nothing else does:
// - bfloat16 (the training path): both halves on the tensor cores.
//   d_feats through window_gather_tc.cuh (mma.sync, cp.async ring, column
//   tile per width, and the split of the G x M terms over several blocks
//   at coarse levels, exactly as K2); d_w through window_dw_tc.cuh (rows
//   are the mma's k dimension: the direct feature rows and the gathered
//   g_out rows staged by cp.async with zero fill, both operands read by
//   ldmatrix.trans, f32 partial per row chunk, the same fixed-order
//   reduction).
// - float32: K2's CUDA-core core of window_gather.cuh and window_dw.cuh's
//   CUDA-core d_w kernel, unchanged.

#include <cstdint>

#include "window_dw_tc.cuh"

// g_out [n_out, cout], feats [n_tiles * tile, c], w_t [G, M, cout, c] and
// d_feats [n_tiles * tile, c] share the type (bf16: 1 for bfloat16, 0 for
// float32); inv_starts int32[G, n_tiles], inv_idx int32[G, n_tiles, M,
// tile]; part holds [chunks, G, M, c, cout] f32 with chunks =
// ceil(n_tiles * tile / chunk_rows); d_w [G, M, c, cout] f32. bf16 only:
// bn, parts, per and fpart are d_feats' column tile, term split and f32
// scratch [parts, n_tiles * tile, c] (as K2's launch), bc and bo d_w's
// tiles.
extern "C" int window_bwd_launch(const void* g_out, int n_out, int cout,
                                 const void* feats, int c,
                                 const int32_t* inv_starts,
                                 const int32_t* inv_idx, const void* w_t,
                                 int groups, int n_tiles, int members,
                                 int tile, int chunk_rows, void* d_feats,
                                 float* part, float* d_w, int bf16, int bn,
                                 int parts, int per, float* fpart, int bc,
                                 int bo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (bf16) {
    if (n_tiles > 0 && tile > 0 && c > 0)
      err = ndt::tc::launch_gather_matmul(
          g_out, n_out, cout, inv_starts, inv_idx, w_t, groups, n_tiles,
          members, tile, c, bn, parts, per, fpart, d_feats, s);
    if (err != 0) return err;
    return ndt::tc::launch_dw(feats, c, g_out, cout, n_out, inv_starts,
                              inv_idx, groups, n_tiles, members, tile,
                              chunk_rows, bc, bo, part, d_w, s);
  }
  if (n_tiles > 0 && tile > 0 && c > 0)
    err = ndt::launch_gather_matmul<float>(g_out, n_out, cout, inv_starts,
                                           inv_idx, w_t, groups, n_tiles,
                                           members, tile, c, d_feats, s);
  if (err != 0) return err;
  return ndt::launch_dw<float, false>(feats, c, g_out, cout, n_out,
                                      inv_starts, inv_idx, groups, n_tiles,
                                      members, tile, chunk_rows, part, d_w,
                                      s);
}
