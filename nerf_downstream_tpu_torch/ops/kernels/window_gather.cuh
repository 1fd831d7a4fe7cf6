// Device code shared by the gather-matmul kernels: typed loads and stores,
// and one CUDA-core gather-matmul core that K6 (row gather-matmul, both
// input types) and the float32 calls of K2 (windowed forward), of K3's
// d_feats half (on the inverse plan) and of K5 (block-sparse windowed
// forward) run; the bfloat16 calls of K2, K3 and K5 run the tensor-core
// core of window_gather_tc.cuh:
//
//   out[r] = sum over terms q of src[rows(q, r)] @ w[q]
//
// where a term is a plan member (g, m) (K2, K3, K5) or a kernel offset k
// (K6), and rows(q, r) is the source row or -1 (nothing to add). For a
// window plan, rows(gm, t*T + i) = starts[g, t] + idx[g, t, m, i]; absent
// entries (-1) and ranks that land past the table add nothing. A liveness
// policy may skip whole terms and 16-channel input chunks per 64-column
// output tile (K5's float32 calls). The design note is in
// window_gather_matmul.cu.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ndt {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Source row of plan entry (g, t, m, i), or -1 when the entry is absent or
// its rank lands past the n_rows rows of the table.
__device__ __forceinline__ int plan_row(const int32_t* __restrict__ starts,
                                        const int32_t* __restrict__ idx,
                                        int g, int t, int m, int i,
                                        int n_tiles, int members, int tile,
                                        int n_rows) {
  const int k =
      idx[((static_cast<long long>(g) * n_tiles + t) * members + m) * tile +
          i];
  if (k < 0) return -1;
  const long long s = static_cast<long long>(starts[g * n_tiles + t]) + k;
  return s < n_rows ? static_cast<int>(s) : -1;
}

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kAStride = kBM + 4;  // keeps float4 alignment, fewer conflicts

// rows(gm, r) of a window plan: term gm = g * members + m.
struct PlanRows {
  const int32_t* starts;
  const int32_t* idx;
  int n_tiles, members, tile, n_rows;
  __device__ __forceinline__ int operator()(int gm, int r) const {
    const int g = gm / members;
    const int t = r / tile;
    return plan_row(starts, idx, g, t, gm - g * members, r - t * tile,
                    n_tiles, members, tile, n_rows);
  }
};

// Liveness policy that keeps every term and every chunk (no test, no
// barrier in the kernel).
struct AllLive {
  static constexpr bool kAlways = true;
  __device__ bool term(int, int, int) const { return true; }
  __device__ bool chunk(int, int, int, int) const { return true; }
};

// The core. A block owns kBM output rows x kBN output columns; each of
// its 256 threads keeps a 4 x 4 f32 accumulator across all terms and
// input chunks. Per term it resolves its kBM source rows once (and skips
// the term when none is present), then per 16-channel chunk stages the
// gathered [kBM x 16] rows and the [16 x kBN] weight slice in shared
// memory as f32. Ragged rows and channels are masked with zero fills.
// Live::term / Live::chunk return this thread's share of a cooperative
// test; the block goes on when any thread's share is true.
template <typename T, typename TOut, typename Rows, typename Live>
__global__ void __launch_bounds__(kThreads) gather_matmul_kernel(
    const T* __restrict__ src, int c, Rows rows, Live live,
    const T* __restrict__ w, int n_terms, int n_out, int cout,
    TOut* __restrict__ out) {
  __shared__ __align__(16) float a_s[kBK][kAStride];
  __shared__ __align__(16) float b_s[kBK][kBN];
  __shared__ int src_s[kBM];

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q = 0; q < n_terms; ++q) {
    if constexpr (!Live::kAlways) {
      if (!__syncthreads_or(live.term(q, col0, threadIdx.x))) continue;
    }
    int present = 0;
    if (threadIdx.x < kBM) {
      const int r = row0 + threadIdx.x;
      const int s = r < n_out ? rows(q, r) : -1;
      src_s[threadIdx.x] = s;
      present = s >= 0;
    }
    if (!__syncthreads_or(present)) continue;

    const T* wq = w + static_cast<long long>(q) * c * cout;
    for (int k0 = 0; k0 < c; k0 += kBK) {
      if constexpr (!Live::kAlways) {
        if (!__syncthreads_or(live.chunk(q, k0, col0, threadIdx.x))) continue;
      }
      for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK;
        const int kk = e - r * kBK;
        const int s = src_s[r];
        float v = 0.f;
        if (s >= 0 && k0 + kk < c) {
          v = load_f(src + static_cast<long long>(s) * c + k0 + kk);
        }
        a_s[kk][r] = v;
      }
      for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
        const int kk = e / kBN;
        const int col = e - kk * kBN;
        float v = 0.f;
        if (k0 + kk < c && col0 + col < cout) {
          v = load_f(wq + static_cast<long long>(k0 + kk) * cout + col0 + col);
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

template <typename T, typename TOut, typename Rows, typename Live>
int launch_core(const void* src, int c, Rows rows, Live live, const void* w,
                int n_terms, long long n_out, int cout, void* out,
                cudaStream_t stream) {
  if (n_out <= 0 || cout <= 0) return 0;
  dim3 grid(static_cast<unsigned>((n_out + kBM - 1) / kBM),
            static_cast<unsigned>((cout + kBN - 1) / kBN));
  gather_matmul_kernel<T, TOut, Rows, Live><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), c, rows, live, static_cast<const T*>(w),
      n_terms, static_cast<int>(n_out), cout, static_cast<TOut*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K2's kernel: the windowed gather-matmul over a plan, output in the
// input type.
template <typename T>
int launch_gather_matmul(const void* feats, int n_rows, int c,
                         const int32_t* starts, const int32_t* idx,
                         const void* w, int groups, int n_tiles, int members,
                         int tile, int cout, void* out, cudaStream_t stream) {
  const PlanRows rows{starts, idx, n_tiles, members, tile, n_rows};
  return launch_core<T, T>(feats, c, rows, AllLive{}, w, groups * members,
                           static_cast<long long>(n_tiles) * tile, cout, out,
                           stream);
}

}  // namespace ndt
