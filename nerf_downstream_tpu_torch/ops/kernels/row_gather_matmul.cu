// K6 row_gather_matmul: the forward of a sparse convolution over a row
// kernel map.
//
// Replaces the Pallas TPU kernel gather_matmul
// (nerf_downstream_tpu/ops/pallas/gather_matmul.py:76, body _kernel :31):
//
//   out[n] = sum over k of x_ext[km[k, n]] @ w[k]      -> [N_out, Cout] f32
//
// where km int32[K, N_out] names input rows and the sentinel N_in (the
// zero row of x_ext) means no neighbour. Products and sums are f32 for
// every input type, and the output is f32, as in the Pallas kernel.
//
// The TPU kernel stages a tile's indices in SMEM and issues one row DMA
// per index into a VMEM buffer that feeds the MXU, with k as a sequential
// grid axis accumulating into VMEM scratch, and needs N_out to be a
// multiple of its tile. Two cores here, chosen by the input type alone:
// - bfloat16 (the pruned-eval path): the tensor-core core of K2, K3 and K5
//   (window_gather_tc.cuh) with the kernel map as its row source
//   (MapRows): mma.sync m16n8k16 with f32 accumulators over 64 output rows
//   x a column tile, gathered rows and weights staged by cp.async in
//   16-byte pieces (element by element when a row width is not a multiple
//   of 8 or an operand is not 16-byte aligned), sentinel rows zero-filled
//   and never read. It stores its f32 sums. The row path has few terms
//   (2 to 8 offsets) over few rows at the coarse levels (512-3,584 output
//   rows: 8-56 blocks for 132 SMs), so the work splits over (term,
//   32-channel chunk) steps: part z of the grid runs the contiguous steps
//   [z * per, (z + 1) * per) (the StepRange policy), writes an f32
//   partial, and a second kernel adds the parts in ascending order. No
//   atomics: repeats are bit-identical. The wrapper chooses the column
//   tile and split (ops/kernels/tc.py, row_choice).
// - float32: window_gather.cuh's CUDA-core core: a block owns 64 output
//   rows x 64 output columns and loops over k, keeping the f32 sum in
//   registers; per k it reads km[k, rows], skips k when every row is a
//   sentinel, and gathers the named rows in 16-channel chunks straight
//   from global memory.
// Ragged N_out, Cin and Cout are masked, so no padding is needed.
//
// Bound on the H100: 2 Cin Cout operations per real pair (km < N_in) at
// the tensor-core peak of the input type, against x_ext, w and km read
// once and the f32 output written once; at the down convs of the
// pruned-eval path (K = 2..8, 512..14,848 output rows) the bytes of the
// output and the gathered features dominate: 0.2-1.9 us per call.

#include <cstdint>

#include "window_gather_tc.cuh"

namespace ndt {

// rows(k, n) of a row kernel map: km[k, n] when it names a real row
struct MapRows {
  const int32_t* km;
  int n_out, n_in;
  __device__ __forceinline__ int operator()(int k, int r) const {
    const int s = km[static_cast<long long>(k) * n_out + r];
    return (s >= 0 && s < n_in) ? s : -1;
  }
};

// K6's split of the tensor-core core: part blockIdx.z runs the flat
// steps s = k * nk + chunk in [z * per, (z + 1) * per), nk 32-channel
// chunks a term; every other step is skipped as a dead one.
struct StepRange {
  static constexpr bool kAlways = false;
  static constexpr bool kStepSplit = true;
  int nk, per;
  __device__ void terms(int n_terms, int& begin, int& end) const {
    const int s0 = static_cast<int>(blockIdx.z) * per;
    begin = s0 / nk;
    end = min(n_terms, (s0 + per + nk - 1) / nk);
  }
  __device__ bool live_under(int q, int k0, int, int, int) const {
    const int s = q * nk + k0 / tc::kBK;
    const int s0 = static_cast<int>(blockIdx.z) * per;
    return s >= s0 && s < s0 + per;
  }
};

}  // namespace ndt

// x_ext [n_in + 1, c] and w [k, c, cout] share the type (bf16: 1 for
// bfloat16, 0 for float32); km int32[k, n_out]; out [n_out, cout] f32.
// bf16 only: bn the column tile, vec 1 for the 16-byte staging (c and
// cout multiples of 8, x_ext and w 16-byte aligned), parts and per the
// step split (parts runs of per (term, chunk) steps), part f32 scratch
// [parts, n_out, cout] when parts > 1.
extern "C" int row_gather_matmul_launch(const void* x_ext, int n_in, int c,
                                        const int32_t* km, int k, int n_out,
                                        const void* w, int cout, float* out,
                                        int bf16, int bn, int vec, int parts,
                                        int per, float* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ndt::MapRows rows{km, n_out, n_in};
  if (bf16) {
    const int nk = (c + ndt::tc::kBK - 1) / ndt::tc::kBK;
    if (parts <= 1)
      return ndt::tc::launch_rows(x_ext, c, rows, w, k, n_out, cout, bn,
                                  vec != 0, 1, k, nullptr, out, s,
                                  ndt::AllLive{});
    if (static_cast<long long>(parts) * per < static_cast<long long>(k) * nk)
      return static_cast<int>(cudaErrorInvalidValue);
    return ndt::tc::launch_rows(x_ext, c, rows, w, k, n_out, cout, bn,
                                vec != 0, parts, per, part, out, s,
                                ndt::StepRange{nk, per});
  }
  return ndt::launch_core<float, float>(x_ext, c, rows, ndt::AllLive{}, w, k,
                                        n_out, cout, out, s);
}
