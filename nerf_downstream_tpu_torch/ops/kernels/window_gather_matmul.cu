// K2 window_gather_matmul: the forward of a windowed sparse convolution.
//
// Replaces the Pallas TPU kernel window_gather_matmul_pallas
// (nerf_downstream_tpu/ops/pallas/window_gather.py:131, body _fwd_kernel
// :108 and _gather_members :71):
//
//   out[t*T + i] = sum over (g, m) of feats[starts[g, t] + idx[g, t, m, i]]
//                  @ w[g, m]                       (absent entries, -1, add 0)
//
// accumulated in f32 and rounded once into the output type, which is the
// input type (float32 or bfloat16).
//
// The TPU kernel streams each group's whole coverage window ([cov, C],
// up to 12 x 128 rows) into VMEM and gathers with a one-hot matmul,
// because Mosaic cannot index rows in VMEM. A Hopper block has at most
// 227 KB of shared memory, less than one such window at C = 128..256, and
// it can index rows directly. So this kernel gathers only the rows that
// idx names, straight from global memory (they sit inside the window,
// so neighbouring tiles hit L2), in K-chunks of 16 channels.
//
// Bound on the H100 at the model's shapes: operations at the wide,
// dense levels, bytes elsewhere. The heaviest calls of the 64k eval batch
// are the C = Cout = 96 convs at the finest level (65,536 rows, G = 9,
// M = 3, ~1.2M present entries): 2 C Cout = 18.4 kFLOP per present entry,
// 22 us per call at the bf16 tensor-core peak (989 TFLOP/s), against
// ~10 us to move their features, idx and output once at 3.35 TB/s. Coarse
// levels (512 rows at C = 256) need well under a microsecond either way.
// This first version reaches neither bound: it multiplies on the f32 CUDA
// cores (67 TFLOP/s peak), spends the work of absent entries within a
// 64-row block, and at coarse levels launches only (rows / 64) x
// (Cout / 64) blocks (32 for 512 rows x 256 channels), too few to fill
// 132 SMs.
// Tensor cores (mma.sync / wgmma on bf16) and a split over (g, m) for
// small levels are the next steps.
//
// Design (the kernel is in window_gather.cuh, shared with K3, K5 and K6): a
// block owns 64 output rows x 64 output channels; 256 threads
// each hold a 4 x 4 f32 accumulator in registers across all (g, m) and all
// channel chunks. Per (g, m) the block resolves its 64 source rows once
// (skipping the member entirely when none is present), then per chunk
// stages the gathered [64 x 16] feature slice and the [16 x 64] weight
// slice in shared memory as f32. Ragged edges (C = 27, Cout not a
// multiple of 64, the last tile) are masked with zero fills, so no
// padding of the inputs is needed.

#include <cstdint>

#include "window_gather.cuh"

// bf16: 1 for bfloat16, 0 for float32 (feats, w and out share the type).
extern "C" int window_gather_matmul_launch(
    const void* feats, int n_rows, int c, const int32_t* starts,
    const int32_t* idx, const void* w, int groups, int n_tiles, int members,
    int tile, int cout, void* out, int bf16, void* stream) {
  if (n_tiles <= 0 || tile <= 0 || cout <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ndt::launch_gather_matmul<__nv_bfloat16>(
        feats, n_rows, c, starts, idx, w, groups, n_tiles, members, tile,
        cout, out, s);
  return ndt::launch_gather_matmul<float>(feats, n_rows, c, starts, idx, w,
                                          groups, n_tiles, members, tile,
                                          cout, out, s);
}
