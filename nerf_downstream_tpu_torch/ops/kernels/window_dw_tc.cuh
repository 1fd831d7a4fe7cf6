// The bf16 tensor-core weight gradient of K3 (window_bwd.cu's d_w half,
// over the inverse plan) and of K4 (window_dw.cu, over the forward plan):
//
//   d_w[g, m][c, o] = sum over rows r of x[row_x(r)][c] * y[row_y(r)][o]
//
// One side is read through the plan (the gathered side: row
// starts[g, t] + idx[g, t, m, i] for r = t*T + i, nothing when the entry is
// absent or lands past the n_gather rows of its table), the other at row
// r (the direct side). kGatherX picks which: K3 reads the features x
// directly and gathers the output gradient y through the inverse plan;
// K4 gathers the features through the forward plan and reads the output
// gradient directly. f32 products and sums; float32 calls stay on
// window_dw.cuh's CUDA-core kernel.
//
// Bound on the H100: operations at the fine levels (2 C Cout FLOP per
// present entry at 989 TFLOP/s), the block count at the coarse ones; K4's
// stem call (C = 27, Cout = 32) is bound by its bytes.
//
// Design. A block owns one (row chunk, g, m, BC-wide C tile, BO-wide Cout
// tile) slice (BC, BO in {32, 64, 96}, chosen per width by the wrapper)
// and each warp a 32 x 32 piece of it. The reduction runs over rows, so
// rows are the k dimension of mma.sync.m16n8k16: x is staged [rows][C]
// and y [rows][Cout] in shared memory, and both operands come out of
// ldmatrix.trans (A = x^T, B = y rows). Rows are resolved 1,024 at a time
// (one bit per 32-row step that has a present row; steps without one are
// skipped); then a ring of cp.async stages (16-byte pieces, zero fill for
// absent rows on both sides, element by element when a width is not a
// multiple of 8) feeds one mma step per barrier. Every 4 steps the
// tensor-core sums are added to the running f32 sum with an ordinary
// rounded add. Each block writes its f32 partial, and window_dw.cuh's
// dw_reduce_kernel adds the row chunks in a fixed order: d_w is
// bit-identical from run to run.

#pragma once

#include "window_dw.cuh"
#include "window_gather_tc.cuh"

namespace ndt {
namespace tc {

constexpr int kDwBK = 32;       // rows per stage
constexpr int kDwGroup = 1024;  // rows resolved at once (32 steps)
constexpr int kDwFlush = 4;     // steps between rounded adds

template <int BC, int BO>
struct DwSmem {
  static constexpr int kXS = BC + kPad;
  static constexpr int kYS = BO + kPad;
  static constexpr int kXBytes = kStages * kDwBK * kXS * 2;
  static constexpr int kYBytes = kStages * kDwBK * kYS * 2;
  static constexpr int kBytes = kXBytes + kYBytes + kDwGroup * 4;
};

// Grid: (ceil(c / BC) * ceil(cout / BO), G * M, chunks). Writes the f32
// partial of its row chunk to part[chunk, g, m] ([c, cout]). kGatherX:
// x is the gathered side (K4), else y is (K3).
template <int BC, int BO, bool kVec, bool kGatherX>
__global__ void __launch_bounds__(BC / 32 * BO)
    dw_mma_kernel(const bf16* __restrict__ x, int c,
                  const bf16* __restrict__ y, int cout, int n_gather,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ idx, int groups, int n_tiles,
                  int members, int tile, int chunk_rows,
                  float* __restrict__ part) {
  using S = DwSmem<BC, BO>;
  constexpr int kWM = BC / 32;
  constexpr int kThreads = kWM * (BO / 32) * 32;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x_s = reinterpret_cast<bf16*>(smem);
  bf16* y_s = reinterpret_cast<bf16*>(smem + S::kXBytes);
  int* src_s = reinterpret_cast<int*>(smem + S::kXBytes + S::kYBytes);
  __shared__ unsigned warp_live[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % kWM;
  const int wn = warp / kWM;
  const int n_ct = (c + BC - 1) / BC;
  const int c0 = (blockIdx.x % n_ct) * BC;
  const int o0 = (blockIdx.x / n_ct) * BO;
  const int gm = blockIdx.y;
  const int g = gm / members;
  const int m = gm - g * members;
  const int rows = n_tiles * tile;
  const int r_begin = blockIdx.z * chunk_rows;
  const int r_end = min(rows, r_begin + chunk_rows);

  float acc[2][4][4], tacc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = tacc[mi][ni][e] = 0.f;

  for (int gb = r_begin; gb < r_end; gb += kDwGroup) {
    // gathered row of each row of the group, and which 32-row steps have
    // any (kThreads is a multiple of 32, so a warp covers whole steps)
    unsigned mine = 0;
    for (int e = tid; e < kDwGroup; e += kThreads) {
      const int r = gb + e;
      int s = -1;
      if (r < r_end) {
        const int t = r / tile;
        s = plan_row(starts, idx, g, t, m, r - t * tile, n_tiles, members,
                     tile, n_gather);
      }
      src_s[e] = s;
      if (__ballot_sync(0xffffffffu, s >= 0)) mine |= 1u << (e / kDwBK);
    }
    if (lane == 0) warp_live[warp] = mine;
    __syncthreads();
    unsigned live = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) live |= warp_live[i];
    const int steps = __popc(live);

    unsigned rest = live;
    auto issue = [&](int slot) {
      const int step = __ffs(rest) - 1;
      rest &= rest - 1;
      const int* srow = src_s + step * kDwBK;
      const int rb = gb + step * kDwBK;
      bf16* xa = x_s + slot * kDwBK * S::kXS;
      bf16* ya = y_s + slot * kDwBK * S::kYS;
      if constexpr (kVec) {
        for (int e = tid; e < kDwBK * (BC / 8); e += kThreads) {
          const int kr = e / (BC / 8);
          const int cc = (e - kr * (BC / 8)) * 8;
          const int s = srow[kr];
          const bool ok = s >= 0 && c0 + cc < c;
          cp_async16(xa + kr * S::kXS + cc,
                     ok ? x + static_cast<long long>(kGatherX ? s : rb + kr) *
                                  c +
                              c0 + cc
                        : x,
                     ok);
        }
        for (int e = tid; e < kDwBK * (BO / 8); e += kThreads) {
          const int kr = e / (BO / 8);
          const int cc = (e - kr * (BO / 8)) * 8;
          const int s = srow[kr];
          const bool ok = s >= 0 && o0 + cc < cout;
          cp_async16(ya + kr * S::kYS + cc,
                     ok ? y + static_cast<long long>(kGatherX ? rb + kr : s) *
                                  cout +
                              o0 + cc
                        : y,
                     ok);
        }
      } else {
        // every load of the stage in flight before the first store
        constexpr int kPerX = kDwBK * BC / kThreads;
        constexpr int kPerY = kDwBK * BO / kThreads;
        static_assert(kPerX * kThreads == kDwBK * BC &&
                      kPerY * kThreads == kDwBK * BO);
        bf16 vx[kPerX], vy[kPerY];
#pragma unroll
        for (int j = 0; j < kPerX; ++j) {
          const int e = tid + j * kThreads;
          const int kr = e / BC;
          const int cc = e - kr * BC;
          const int s = srow[kr];
          vx[j] = (s >= 0 && c0 + cc < c)
                      ? x[static_cast<long long>(kGatherX ? s : rb + kr) * c +
                          c0 + cc]
                      : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int j = 0; j < kPerY; ++j) {
          const int e = tid + j * kThreads;
          const int kr = e / BO;
          const int cc = e - kr * BO;
          const int s = srow[kr];
          vy[j] = (s >= 0 && o0 + cc < cout)
                      ? y[static_cast<long long>(kGatherX ? rb + kr : s) *
                              cout +
                          o0 + cc]
                      : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int j = 0; j < kPerX; ++j) {
          const int e = tid + j * kThreads;
          xa[(e / BC) * S::kXS + e % BC] = vx[j];
        }
#pragma unroll
        for (int j = 0; j < kPerY; ++j) {
          const int e = tid + j * kThreads;
          ya[(e / BO) * S::kYS + e % BO] = vy[j];
        }
      }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (s + kStages - 1 < steps) issue((s + kStages - 1) % kStages);
      cp_async_commit();
      const int slot = s % kStages;
      const bf16* xa = x_s + slot * kDwBK * S::kXS + wm * 32;
      const bf16* ya = y_s + slot * kDwBK * S::kYS + wn * 32;
#pragma unroll
      for (int kk = 0; kk < kDwBK; kk += 16) {
        // A = x^T (stored [k = row][m = channel]), B = y rows
        uint32_t af[2][4], bfr[4][2];
        load_a_trans(af, xa + kk * S::kXS, S::kXS, lane);
        load_b_trans(bfr, ya + kk * S::kYS, S::kYS, lane);
        mma_32x32(tacc, af, bfr);
      }
      if ((s + 1) % kDwFlush == 0) add_and_clear(acc, tacc);
    }
    add_and_clear(acc, tacc);
    cp_async_wait<0>();
    __syncthreads();  // src_s and warp_live are rewritten by the next group
  }

  float* dst = part + (static_cast<long long>(blockIdx.z) * groups * members +
                       gm) * c * cout;
  store_tile(dst, acc, c0 + wm * 32, o0 + wn * 32, c, cout, lane);
}

template <int BC, int BO, bool kVec, bool kGatherX>
int launch_dw_tiles(const bf16* x, int c, const bf16* y, int cout,
                    int n_gather, const int32_t* starts, const int32_t* idx,
                    int groups, int n_tiles, int members, int tile,
                    int chunk_rows, int chunks, float* dst,
                    cudaStream_t stream) {
  auto kernel = dw_mma_kernel<BC, BO, kVec, kGatherX>;
  constexpr int kBytes = DwSmem<BC, BO>::kBytes;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes));
  if (err != 0) return err;
  dim3 grid(static_cast<unsigned>(((c + BC - 1) / BC) *
                                  ((cout + BO - 1) / BO)),
            static_cast<unsigned>(groups * members),
            static_cast<unsigned>(chunks));
  kernel<<<grid, BC / 32 * BO, kBytes, stream>>>(
      x, c, y, cout, n_gather, starts, idx, groups, n_tiles, members, tile,
      chunk_rows, dst);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 d_w [G, M, c, cout] f32 of K3 (kGatherX false: feats
// [n_tiles * tile, c] direct, g_out [n_gather, cout] gathered through the
// inverse plan) and of K4 (kGatherX true: feats [n_gather, c] gathered
// through the forward plan, g_out [n_tiles * tile, cout] direct); bc, bo:
// tiles (32, 64 or 96; 32 and 32 when c or cout is not a multiple of 8);
// part holds [chunks, G, M, c, cout] f32 (unused with one chunk).
template <bool kGatherX = false>
int launch_dw(const void* feats, int c, const void* g_out, int cout,
                     int n_gather, const int32_t* starts, const int32_t* idx,
                     int groups, int n_tiles, int members, int tile,
                     int chunk_rows, int bc, int bo, float* part, float* d_w,
                     cudaStream_t stream) {
  const long long n = static_cast<long long>(groups) * members * c * cout;
  const long long rows = static_cast<long long>(n_tiles) * tile;
  if (n <= 0) return 0;
  if (rows <= 0 || chunk_rows <= 0) {
    return static_cast<int>(
        cudaMemsetAsync(d_w, 0, n * sizeof(float), stream));
  }
  const int chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  float* dst = chunks == 1 ? d_w : part;
  const auto* x = static_cast<const bf16*>(feats);
  const auto* y = static_cast<const bf16*>(g_out);
  const bool vec = c % 8 == 0 && cout % 8 == 0;
  int err = static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto launch) {
    return launch(x, c, y, cout, n_gather, starts, idx, groups, n_tiles,
                  members, tile, chunk_rows, chunks, dst, stream);
  };
  if (!vec) {
    if (bc == 32 && bo == 32)
      err = args(launch_dw_tiles<32, 32, false, kGatherX>);
  } else {
    switch (bc * 1000 + bo) {
      case 32032:
        err = args(launch_dw_tiles<32, 32, true, kGatherX>);
        break;
      case 32064:
        err = args(launch_dw_tiles<32, 64, true, kGatherX>);
        break;
      case 32096:
        err = args(launch_dw_tiles<32, 96, true, kGatherX>);
        break;
      case 64032:
        err = args(launch_dw_tiles<64, 32, true, kGatherX>);
        break;
      case 64064:
        err = args(launch_dw_tiles<64, 64, true, kGatherX>);
        break;
      case 64096:
        err = args(launch_dw_tiles<64, 96, true, kGatherX>);
        break;
      case 96032:
        err = args(launch_dw_tiles<96, 32, true, kGatherX>);
        break;
      case 96064:
        err = args(launch_dw_tiles<96, 64, true, kGatherX>);
        break;
      case 96096:
        err = args(launch_dw_tiles<96, 96, true, kGatherX>);
        break;
      default: break;
    }
  }
  if (err != 0 || chunks == 1) return err;
  const long long blocks = (n + 255) / 256;
  dw_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                     256, 0, stream>>>(part, chunks, n, d_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace ndt
