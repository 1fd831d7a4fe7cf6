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
// so neighbouring tiles hit L2), in channel chunks (16 channels on the
// CUDA-core core, 32 on the tensor-core one).
//
// Bound on the H100 at the model's shapes: operations at the wide,
// dense levels, bytes elsewhere. The heaviest calls of the 64k eval batch
// are the C = Cout = 96 convs at the finest level (65,536 rows, G = 9,
// M = 3, ~1.2M present entries): 2 C Cout = 18.4 kFLOP per present entry,
// 22 us per call at the bf16 tensor-core peak (989 TFLOP/s), against
// ~10 us to move their features, idx and output once at 3.35 TB/s. Coarse
// levels (512 rows at C = 256) need well under a microsecond either way;
// there the limit is how many of the 132 SMs get a block.
//
// Two cores, chosen by the input type alone:
// - bfloat16 (the serving, training and pruned-eval paths):
//   window_gather_tc.cuh. mma.sync m16n8k16 on the tensor cores with f32
//   accumulators, gathered rows and weights copied into a 4-stage
//   shared-memory ring by cp.async in 16-byte pieces (element by element
//   when C or Cout is not a multiple of 8, as for the C = 27 stem), a
//   column tile of 32, 64, 96 or 128 chosen per Cout by the wrapper, and at
//   coarse levels the G x M terms split over several blocks whose f32
//   partials a second kernel adds in a fixed order (the wrapper picks the
//   split from the shapes: ops/kernels/tc.py). The header's note has the
//   details.
// - float32: window_gather.cuh's CUDA-core core, unchanged (its gates hold
//   it to 1e-5 of the f32 sum, which TF32 would not meet). A block owns 64
//   output rows x 64 output channels; 256 threads each hold a 4 x 4 f32
//   accumulator across all (g, m) and 16-channel chunks, staged in shared
//   memory as f32; ragged edges are masked with zero fills.

#include <cstdint>

#include "window_gather_tc.cuh"

// bf16: 1 for bfloat16, 0 for float32 (feats, w and out share the type).
// bf16 only: bn is the column tile, parts and per the term split (parts
// runs of per terms), part f32 scratch [parts, n_tiles * tile, cout] when
// parts > 1.
extern "C" int window_gather_matmul_launch(
    const void* feats, int n_rows, int c, const int32_t* starts,
    const int32_t* idx, const void* w, int groups, int n_tiles, int members,
    int tile, int cout, void* out, int bf16, int bn, int parts, int per,
    float* part, void* stream) {
  if (n_tiles <= 0 || tile <= 0 || cout <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ndt::tc::launch_gather_matmul(feats, n_rows, c, starts, idx, w,
                                         groups, n_tiles, members, tile,
                                         cout, bn, parts, per, part, out, s);
  return ndt::launch_gather_matmul<float>(feats, n_rows, c, starts, idx, w,
                                          groups, n_tiles, members, tile,
                                          cout, out, s);
}
