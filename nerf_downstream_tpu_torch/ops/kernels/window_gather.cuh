// Device code shared by the windowed-conv kernels: typed loads and stores,
// and the windowed gather-matmul (K2's kernel, which K3 also runs for its
// d_feats half on the inverse plan).
//
//   out[t*T + i] = sum over (g, m) of src[starts[g, t] + idx[g, t, m, i]]
//                  @ w[g, m]
//
// Absent entries (-1) and ranks that land past the table add nothing. The
// design note is in window_gather_matmul.cu.

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
        src = plan_row(starts, idx, g, t, m, r - t * tile, n_tiles, members,
                       tile, n_rows);
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
int launch_gather_matmul(const void* feats, int n_rows, int c,
                         const int32_t* starts, const int32_t* idx,
                         const void* w, int groups, int n_tiles, int members,
                         int tile, int cout, void* out, cudaStream_t stream) {
  const long long n_out = static_cast<long long>(n_tiles) * tile;
  dim3 grid(static_cast<unsigned>((n_out + kBM - 1) / kBM),
            static_cast<unsigned>((cout + kBN - 1) / kBN));
  window_gather_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), n_rows, c, starts, idx,
      static_cast<const T*>(w), groups, n_tiles, members, tile, cout,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ndt
