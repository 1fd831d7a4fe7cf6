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
// multiple of its tile. Here a block owns 64 output rows x 64 output
// columns and loops over k itself, keeping the f32 sum in registers
// (K2's core, window_gather.cuh, with the kernel map as its row source):
// per k it reads km[k, rows], skips k when every row is a sentinel, and
// gathers the named rows in 16-channel chunks straight from global
// memory. Sentinel rows are never read. Ragged N_out, Cin and Cout are
// masked, so no padding is needed.
//
// Bound on the H100: 2 Cin Cout operations per real pair (km < N_in) at
// the tensor-core peak of the input type, against x_ext, w and km read
// once and the f32 output written once; at the down convs of the
// pruned-eval path (K = 2..8, 512..65,536 output rows) the bytes of the
// output and the gathered features dominate. This first version runs on
// the f32 CUDA cores.

#include <cstdint>

#include "window_gather.cuh"

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

}  // namespace ndt

// x_ext [n_in + 1, c] and w [k, c, cout] share the type (bf16: 1 for
// bfloat16, 0 for float32); km int32[k, n_out]; out [n_out, cout] f32.
extern "C" int row_gather_matmul_launch(const void* x_ext, int n_in, int c,
                                        const int32_t* km, int k, int n_out,
                                        const void* w, int cout, float* out,
                                        int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ndt::MapRows rows{km, n_out, n_in};
  if (bf16)
    return ndt::launch_core<__nv_bfloat16, float>(
        x_ext, c, rows, ndt::AllLive{}, w, k, n_out, cout, out, s);
  return ndt::launch_core<float, float>(x_ext, c, rows, ndt::AllLive{}, w, k,
                                        n_out, cout, out, s);
}
