// Device code of the weight gradient of a windowed sparse convolution,
// on the CUDA cores, run by the float32 calls of K4 (window_dw.cu, over
// the forward plan) and of K3 (window_bwd.cu, over the inverse plan);
// their bfloat16 calls run window_dw_tc.cuh:
//
//   d_w[g, m][c, o] = sum over rows r of x[row_x(r)][c] * y[row_y(r)][o]
//
// One of x and y is read through the plan (the gathered side: row
// starts[g, t] + idx[g, t, m, i] for r = t*T + i, nothing when the entry is
// absent or lands past the table); the other is read at row r (the direct
// side, n_tiles * tile rows). K4 gathers x (the features) and reads the
// output gradient directly; K3 reads the features directly and gathers the
// output gradient through the inverse plan.
//
// Reduction across blocks: the TPU kernels revisit one [G, M, C, Cout]
// accumulator block from a sequential grid. Here blocks run in parallel,
// so a block owns one (row chunk, g, m, 64-wide C tile, 64-wide Cout tile)
// slice and writes its f32 partial sum to a scratch buffer the wrapper
// allocates ([chunks, G, M, C, Cout]); a second kernel adds the chunks in
// a fixed order. No atomics: the result is bit-identical from run to run.
// The chunk count is a function of the shapes only (at most 16 chunks,
// chosen by the wrapper), which bounds the scratch at 16 x the size of d_w.

#pragma once

#include "window_gather.cuh"

namespace ndt {

constexpr int kDwRows = 64;  // plan rows resolved at once
constexpr int kDwK = 16;     // rows staged in shared memory per step

template <typename T, bool kGatherX>
__global__ void __launch_bounds__(kThreads) window_dw_kernel(
    const T* __restrict__ x, int c, const T* __restrict__ y, int cout,
    int n_gather, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ idx, int groups, int n_tiles, int members,
    int tile, int chunk_rows, float* __restrict__ part) {
  __shared__ __align__(16) float x_s[kDwK][kAStride];
  __shared__ __align__(16) float y_s[kDwK][kBN];
  __shared__ int xr_s[kDwRows];
  __shared__ int yr_s[kDwRows];

  const int n_ct = (c + kBM - 1) / kBM;
  const int c0 = (blockIdx.x % n_ct) * kBM;
  const int o0 = (blockIdx.x / n_ct) * kBN;
  const int gm = blockIdx.y;
  const int g = gm / members;
  const int m = gm % members;
  const int rows = n_tiles * tile;
  const int r_begin = blockIdx.z * chunk_rows;
  const int r_end = min(rows, r_begin + chunk_rows);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int rb = r_begin; rb < r_end; rb += kDwRows) {
    int present = 0;
    if (threadIdx.x < kDwRows) {
      const int r = rb + threadIdx.x;
      int src = -1;
      if (r < r_end) {
        const int t = r / tile;
        src = plan_row(starts, idx, g, t, m, r - t * tile, n_tiles, members,
                       tile, n_gather);
      }
      xr_s[threadIdx.x] = src < 0 ? -1 : (kGatherX ? src : r);
      yr_s[threadIdx.x] = src < 0 ? -1 : (kGatherX ? r : src);
      present = src >= 0;
    }
    if (!__syncthreads_or(present)) continue;

    for (int k0 = 0; k0 < kDwRows; k0 += kDwK) {
      for (int e = threadIdx.x; e < kDwK * kBM; e += kThreads) {
        const int kk = e / kBM;
        const int col = e - kk * kBM;
        const int row = xr_s[k0 + kk];
        float v = 0.f;
        if (row >= 0 && c0 + col < c) {
          v = load_f(x + static_cast<long long>(row) * c + c0 + col);
        }
        x_s[kk][col] = v;
      }
      for (int e = threadIdx.x; e < kDwK * kBN; e += kThreads) {
        const int kk = e / kBN;
        const int col = e - kk * kBN;
        const int row = yr_s[k0 + kk];
        float v = 0.f;
        if (row >= 0 && o0 + col < cout) {
          v = load_f(y + static_cast<long long>(row) * cout + o0 + col);
        }
        y_s[kk][col] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDwK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&x_s[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&y_s[kk][tx * 4]);
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

  float* dst = part + (static_cast<long long>(blockIdx.z) * groups * members +
                       gm) * c * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c0 + ty * 4 + i;
    if (ci >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < cout) dst[static_cast<long long>(ci) * cout + o] = acc[i][j];
    }
  }
}

// out[e] = sum over k < chunks of part[k * n + e], k ascending.
__global__ void dw_reduce_kernel(const float* __restrict__ part, int chunks,
                                 long long n, float* __restrict__ out) {
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[k * n + e];
    out[e] = s;
  }
}

// d_w [G, M, c, cout] f32 over rows split into chunks of chunk_rows; part
// holds [chunks, G, M, c, cout] f32 (unused with one chunk).
template <typename T, bool kGatherX>
int launch_dw(const void* x, int c, const void* y, int cout, int n_gather,
              const int32_t* starts, const int32_t* idx, int groups,
              int n_tiles, int members, int tile, int chunk_rows, float* part,
              float* d_w, cudaStream_t stream) {
  const long long n = static_cast<long long>(groups) * members * c * cout;
  const long long rows = static_cast<long long>(n_tiles) * tile;
  if (n <= 0) return 0;
  if (rows <= 0 || chunk_rows <= 0) {
    return static_cast<int>(
        cudaMemsetAsync(d_w, 0, n * sizeof(float), stream));
  }
  const int chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  float* dst = chunks == 1 ? d_w : part;
  dim3 grid(static_cast<unsigned>(((c + kBM - 1) / kBM) *
                                  ((cout + kBN - 1) / kBN)),
            static_cast<unsigned>(groups * members),
            static_cast<unsigned>(chunks));
  window_dw_kernel<T, kGatherX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), c, static_cast<const T*>(y), cout, n_gather,
      starts, idx, groups, n_tiles, members, tile, chunk_rows, dst);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || chunks == 1) return err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  dw_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                     kThreads, 0, stream>>>(part, chunks, n, d_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ndt
