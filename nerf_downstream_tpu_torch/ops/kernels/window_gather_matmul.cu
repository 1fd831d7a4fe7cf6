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
// Design: a block owns 64 output rows x 64 output channels; 256 threads
// each hold a 4 x 4 f32 accumulator in registers across all (g, m) and all
// channel chunks. Per (g, m) the block resolves its 64 source rows once
// (skipping the member entirely when none is present), then per chunk
// stages the gathered [64 x 16] feature slice and the [16 x 64] weight
// slice in shared memory as f32. Ragged edges (C = 27, Cout not a
// multiple of 64, the last tile) are masked with zero fills, so no
// padding of the inputs is needed.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kAStride = kBM + 4;  // keeps float4 alignment, fewer conflicts

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) window_gather_matmul_kernel(
    const T* __restrict__ feats, int n_rows, int c,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ idx,
    const T* __restrict__ w, int groups, int n_tiles, int members,
    int tile, int cout, T* __restrict__ out) {
  __shared__ __align__(16) float a_s[kBK][kAStride];
  __shared__ __align__(16) float b_s[kBK][kBN];
  __shared__ int src_s[kBM];

  const int n_out = n_tiles * tile;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int gm = 0; gm < groups * members; ++gm) {
    const int g = gm / members;
    const int m = gm % members;
    int present = 0;
    if (threadIdx.x < kBM) {
      const int r = row0 + threadIdx.x;
      int src = -1;
      if (r < n_out) {
        const int t = r / tile;
        const int i = r - t * tile;
        const int k =
            idx[((static_cast<long long>(g) * n_tiles + t) * members + m) *
                    tile + i];
        if (k >= 0) {
          const long long s = static_cast<long long>(starts[g * n_tiles + t]) + k;
          src = s < n_rows ? static_cast<int>(s) : -1;
        }
      }
      src_s[threadIdx.x] = src;
      present = src >= 0;
    }
    if (!__syncthreads_or(present)) continue;

    const T* wg = w + static_cast<long long>(gm) * c * cout;
    for (int k0 = 0; k0 < c; k0 += kBK) {
      for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK;
        const int kk = e - r * kBK;
        const int src = src_s[r];
        float v = 0.f;
        if (src >= 0 && k0 + kk < c) {
          v = load_f(feats + static_cast<long long>(src) * c + k0 + kk);
        }
        a_s[kk][r] = v;
      }
      for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
        const int kk = e / kBN;
        const int col = e - kk * kBN;
        float v = 0.f;
        if (k0 + kk < c && col0 + col < cout) {
          v = load_f(wg + static_cast<long long>(k0 + kk) * cout + col0 + col);
        }
        b_s[kk][col] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < cout) {
        store_f(out + static_cast<long long>(r) * cout + col, acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* feats, int n_rows, int c, const int32_t* starts,
           const int32_t* idx, const void* w, int groups, int n_tiles,
           int members, int tile, int cout, void* out, cudaStream_t stream) {
  const long long n_out = static_cast<long long>(n_tiles) * tile;
  dim3 grid(static_cast<unsigned>((n_out + kBM - 1) / kBM),
            static_cast<unsigned>((cout + kBN - 1) / kBN));
  window_gather_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), n_rows, c, starts, idx,
      static_cast<const T*>(w), groups, n_tiles, members, tile, cout,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: 1 for bfloat16, 0 for float32 (feats, w and out share the type).
extern "C" int window_gather_matmul_launch(
    const void* feats, int n_rows, int c, const int32_t* starts,
    const int32_t* idx, const void* w, int groups, int n_tiles, int members,
    int tile, int cout, void* out, int bf16, void* stream) {
  if (n_tiles <= 0 || tile <= 0 || cout <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(feats, n_rows, c, starts, idx, w, groups,
                                 n_tiles, members, tile, cout, out, s);
  return launch<float>(feats, n_rows, c, starts, idx, w, groups, n_tiles,
                       members, tile, cout, out, s);
}
