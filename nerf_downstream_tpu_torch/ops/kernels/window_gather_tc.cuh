// The bf16 tensor-core gather-matmul core of K2 (windowed forward), of
// K3's d_feats half (the same function over the inverse plan), of K5
// (K2 over the live weight blocks) and of K6 (row gather-matmul):
//
//   out[r] = sum over terms q of src[rows(q, r)] @ w[q]
//
// The row source is a template parameter: for a window plan (K2, K3, K5)
// a term is a member (g, m) and rows(gm, t*T + i) = starts[g, t] +
// idx[g, t, m, i], or nothing when the entry is absent (-1) or its rank
// lands past the table (PlanRows); for K6 a term is a kernel offset k and
// rows(k, n) = km[k, n], or nothing at the sentinel (MapRows,
// row_gather_matmul.cu). bf16 in, f32 accumulation, one rounding into
// bf16 (or, when the terms are split over several blocks, f32 partial
// sums that a second kernel adds in a fixed order and rounds once); K6
// writes its sums in f32. float32 calls stay on the CUDA-core core of
// window_gather.cuh.
//
// Bound on the H100 at the model's shapes: operations at the fine, wide
// levels (2 C Cout FLOP per present plan entry, 989 TFLOP/s of bf16 tensor
// cores), while the coarse levels (512-3,584 rows) need a few microseconds
// at most either way; there the limit is how many SMs have work.
//
// Design.
// - Tensor cores: mma.sync.aligned.m16n8k16 (bf16 x bf16 -> f32), fragments
//   from shared memory by ldmatrix (A) and ldmatrix.trans (B, stored
//   [k][n]). Not wgmma: its operands must sit in shared memory in the
//   canonical swizzled layout and it wants 64-row warpgroup tiles; mma.sync
//   takes any padded layout, and these products are small (64 rows x <= 128
//   columns x 32 channels per stage) and gather-bound. wgmma is later work.
// - A block owns 64 output rows x BN output columns (BN in {32, 64, 96, 128},
//   chosen per Cout by the wrapper so that Cout = 96 is one tile, not two
//   half-empty ones); each warp owns 32 x 32 of it (2 x 4 mma tiles).
// - Rows first: for up to 32 terms at once the block resolves the source
//   row of each (term, output row) into shared memory, every load in
//   flight together, and ORs a per-warp bit mask of the terms with any
//   present row. Terms with none are skipped, as in the CUDA-core core.
// - Liveness (a policy, the template's Live): AllLive (K2, K3) keeps every
//   32-channel chunk of every term and adds no code. K5's policy has each
//   warp, in the same pass, ballot one bit per 32-channel chunk of a term:
//   whether any live weight block lies under the chunk and this block's
//   column tile. The masks sit in shared memory (one word per term, so
//   C <= 1,024); a term whose mask is empty is dropped with the absent
//   ones. No barrier beyond the one that ends the pass.
// - Then one flattened loop over (live term, live 32-channel chunk)
//   through a ring of kStages shared-memory stages: cp.async copies of 16
//   bytes (8 channels) per gathered row piece and per weight row piece,
//   the zero-fill form (src-size 0) for absent rows and ragged edges,
//   issued kStages - 1 steps ahead of the multiply, one barrier per step.
//   Rows whose width is not a multiple of 8 (the stem, C = 27) go through
//   the same loop with element-by-element staging; the zeros it writes past
//   C are the zeros a Cin-padded input would copy, so the two agree bit
//   for bit.
// - Sums: each term's products accumulate in their own f32 registers
//   (at most C / 16 mma steps) and are then added to the running f32 sum
//   with an ordinary rounded add, so long chains never stay inside the
//   tensor core's accumulator. A step K5 skips would have added exact
//   zeros (its weights are zero on every dead block), so on finite inputs
//   K5's sums are K2's on the masked weights, bit for bit.
// - Coarse levels: when (rows / 64) x (Cout / BN) blocks would leave SMs
//   idle, the wrapper splits the G x M terms into `parts` contiguous runs
//   (blockIdx.z); each part writes an f32 partial [n_out, Cout] to a
//   scratch buffer, and split_reduce_kernel adds the parts in ascending
//   order and rounds once. No atomics: repeats are bit-identical. K6's
//   few terms (2-8 kernel offsets) split finer, over (term, 32-channel
//   chunk) steps: its StepRange policy (row_gather_matmul.cu) marks, as
//   K5's liveness does, the steps of a part live and the rest dead, and
//   gives the part's term range; its parts add in the same fixed order.
// - NaN in a present input row or in a weight reaches every output it is
//   multiplied into, through the partials too; under K5's policy, every
//   column of the tile of a step that runs (its dead blocks' zero weights
//   carry it), and nothing through a step that is skipped.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "window_gather.cuh"

namespace ndt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // output rows per block
constexpr int kBK = 32;        // input channels per stage
constexpr int kStages = 4;     // shared-memory ring
constexpr int kMaxTerms = 32;  // terms resolved at once (one bit each)
constexpr int kPad = 8;        // bf16 of padding per shared row: 16 bytes,
                               // so ldmatrix's 8 rows hit 8 bank groups
constexpr int kAS = kBK + kPad;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; copies zeros when !valid (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of a warp's 32 x 32 tile over a 16-deep slice, for
// mma_32x32: A (two 16 x 16 tiles) from rows stored [m][k] (ldmatrix) or
// [k][m] (ldmatrix.trans), B (four 16 x 8 tiles) from rows stored [k][n]
// (ldmatrix.trans); `stride` is the stored row length in elements.
__device__ __forceinline__ void load_a(uint32_t (&af)[2][4], const bf16* a,
                                       int stride, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldmatrix_x4(af[mi],
                a + (mi * 16 + (lane & 15)) * stride + (lane >> 4) * 8);
}
// ldmatrix.trans of the 8 x 8 blocks (m 0-7 | 8-15) x (k 0-7 | 8-15) in the
// order of a0..a3
__device__ __forceinline__ void load_a_trans(uint32_t (&af)[2][4],
                                             const bf16* a, int stride,
                                             int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldmatrix_x4_trans(af[mi], a + ((lane & 7) + ((lane >> 4) << 3)) * stride +
                                  mi * 16 + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void load_b_trans(uint32_t (&bfr)[4][2],
                                             const bf16* b, int stride,
                                             int lane) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, b + (lane & 15) * stride + nj * 16 + (lane >> 4) * 8);
    bfr[2 * nj][0] = r[0];
    bfr[2 * nj][1] = r[1];
    bfr[2 * nj + 1][0] = r[2];
    bfr[2 * nj + 1][1] = r[3];
  }
}
__device__ __forceinline__ void mma_32x32(float (&acc)[2][4][4],
                                          const uint32_t (&af)[2][4],
                                          const uint32_t (&bfr)[4][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
}

__device__ __forceinline__ void add_and_clear(float (&acc)[2][4][4],
                                              float (&part)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] += part[mi][ni][e];
        part[mi][ni][e] = 0.f;
      }
}

// Stores a warp's 32 x 32 accumulator at (r0, c0) of a row-major
// [n_rows, n_cols] matrix of T (bf16 or f32), masking the ragged edges.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                          const float (&acc)[2][4][4],
                                          int r0, int c0, int n_rows,
                                          int n_cols, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mi * 16 + h * 8 + (lane >> 2);
      if (r >= n_rows) continue;
      T* row = dst + static_cast<long long>(r) * n_cols;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = c0 + ni * 8 + (lane & 3) * 2;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (col + 1 < n_cols && (n_cols & 1) == 0) {
          if constexpr (sizeof(T) == 2) {
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
          }
        } else {
          if (col < n_cols) store_f(row + col, v0);
          if (col + 1 < n_cols) store_f(row + col + 1, v1);
        }
      }
    }
}

// Whether a liveness policy splits a block's work over steps and names
// its term range itself (Live::kStepSplit, Live::terms); otherwise part z
// takes terms [z * per, (z + 1) * per).
template <typename L, typename = void>
struct SplitsSteps : std::false_type {};
template <typename L>
struct SplitsSteps<L, std::void_t<decltype(L::kStepSplit)>>
    : std::bool_constant<L::kStepSplit> {};

template <int BN>
struct GatherSmem {
  static constexpr int kBS = BN + kPad;
  static constexpr int kABytes = kStages * kBM * kAS * 2;
  static constexpr int kBBytes = kStages * kBK * kBS * 2;
  static constexpr int kSrcBytes = kMaxTerms * kBM * 4;
  static constexpr int kBytes = kABytes + kBBytes + kSrcBytes;
};

// The core. Grid: (ceil(n_out / 64), ceil(cout / BN), parts); part p sums
// terms [p * per, min(n_terms, (p + 1) * per)). With parts == 1 it writes
// bf16 `out`, else f32 partials `part` [parts, n_out, cout]. Live: AllLive,
// or a policy whose live_under(q, k0, k1, col0, col1) says whether term q
// has a live weight block under channels [k0, k1) and columns
// [col0, col1) (K5's BlockLive, K6's StepRange). Rows: the row source
// (PlanRows, MapRows).
template <int BN, bool kVec, typename Live, typename Rows>
__global__ void __launch_bounds__(2 * BN) gather_mma_kernel(
    const bf16* __restrict__ src, int c, Rows rows,
    const bf16* __restrict__ w, int n_terms, int per, int n_out, int cout,
    bf16* __restrict__ out, float* __restrict__ part, Live lv) {
  using S = GatherSmem<BN>;
  constexpr int kThreads = 2 * BN;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = reinterpret_cast<bf16*>(smem + S::kABytes);
  int* src_s = reinterpret_cast<int*>(smem + S::kABytes + S::kBBytes);
  __shared__ unsigned warp_live[kWarps];
  // live 32-channel chunks of each term of the group (Live only)
  __shared__ unsigned chunk_s[Live::kAlways ? 1 : kMaxTerms];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // 32-row half of the block
  const int wn = warp >> 1;  // 32-column slice of the block
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * BN;
  int q_begin, q_end;
  if constexpr (SplitsSteps<Live>::value) {
    lv.terms(n_terms, q_begin, q_end);
  } else {
    q_begin = blockIdx.z * per;
    q_end = min(n_terms, q_begin + per);
  }
  const int nk = (c + kBK - 1) / kBK;

  float acc[2][4][4], tacc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = tacc[mi][ni][e] = 0.f;

  for (int g0 = q_begin; g0 < q_end; g0 += kMaxTerms) {
    const int nq = min(kMaxTerms, q_end - g0);
    // resolve the source rows of every (term, row) of this group
    unsigned mine = 0;
    for (int e = tid; e < nq * kBM; e += kThreads) {
      const int tl = e / kBM;
      const int r = row0 + (e - tl * kBM);
      const int s = r < n_out ? rows(g0 + tl, r) : -1;
      src_s[e] = s;
      if (s >= 0) mine |= 1u << tl;
    }
    mine = __reduce_or_sync(0xffffffffu, mine);
    if (lane == 0) warp_live[warp] = mine;
    if constexpr (!Live::kAlways) {
      // one warp per term, one lane per 32-channel chunk (nk <= 32)
      for (int tl = warp; tl < nq; tl += kWarps) {
        const unsigned bits = __ballot_sync(
            0xffffffffu, lane < nk && lv.live_under(g0 + tl, lane * kBK,
                                                    (lane + 1) * kBK, col0,
                                                    col0 + BN));
        if (lane == 0) chunk_s[tl] = bits;
      }
    }
    __syncthreads();
    unsigned live = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) live |= warp_live[i];
    int steps;
    if constexpr (Live::kAlways) {
      steps = __popc(live) * nk;
    } else {
      steps = 0;
      for (unsigned r = live; r; r &= r - 1) {
        const int n = __popc(chunk_s[__ffs(r) - 1]);
        if (n == 0) live &= ~(1u << (__ffs(r) - 1));
        steps += n;
      }
    }

    // the issue side walks (live term, live chunk) kStages - 1 steps ahead
    unsigned rest = live;
    int it_term = rest ? __ffs(rest) - 1 : 0;
    unsigned it_chunks = 0;  // Live only: chunks of it_term still to issue
    int it_k = 0;
    if constexpr (!Live::kAlways) {
      it_chunks = rest ? chunk_s[it_term] : 0u;
      it_k = it_chunks ? __ffs(it_chunks) - 1 : 0;
    }
    auto issue = [&](int slot) {
      const int k0 = it_k * kBK;
      const int* srow = src_s + it_term * kBM;
      const bf16* wq = w + static_cast<long long>(g0 + it_term) * c * cout;
      bf16* a = a_s + slot * kBM * kAS;
      bf16* b = b_s + slot * kBK * S::kBS;
      if constexpr (kVec) {
        for (int e = tid; e < kBM * (kBK / 8); e += kThreads) {
          const int r = e / (kBK / 8);
          const int ch = k0 + (e - r * (kBK / 8)) * 8;
          const int s = srow[r];
          const bool ok = s >= 0 && ch < c;
          cp_async16(a + r * kAS + ch - k0,
                     ok ? src + static_cast<long long>(s) * c + ch : src, ok);
        }
        for (int e = tid; e < kBK * (BN / 8); e += kThreads) {
          const int kr = e / (BN / 8);
          const int cc = (e - kr * (BN / 8)) * 8;
          const bool ok = k0 + kr < c && col0 + cc < cout;
          cp_async16(b + kr * S::kBS + cc,
                     ok ? wq + static_cast<long long>(k0 + kr) * cout + col0 +
                              cc
                        : w,
                     ok);
        }
      } else {
        // every load of the stage in flight before the first store
        constexpr int kPerA = kBM * kBK / kThreads;
        constexpr int kPerB = kBK * BN / kThreads;
        static_assert(kPerA * kThreads == kBM * kBK &&
                      kPerB * kThreads == kBK * BN);
        bf16 va[kPerA], vb[kPerB];
#pragma unroll
        for (int j = 0; j < kPerA; ++j) {
          const int e = tid + j * kThreads;
          const int r = e / kBK;
          const int kk = e - r * kBK;
          const int s = srow[r];
          va[j] = (s >= 0 && k0 + kk < c)
                      ? src[static_cast<long long>(s) * c + k0 + kk]
                      : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int j = 0; j < kPerB; ++j) {
          const int e = tid + j * kThreads;
          const int kr = e / BN;
          const int cc = e - kr * BN;
          vb[j] = (k0 + kr < c && col0 + cc < cout)
                      ? wq[static_cast<long long>(k0 + kr) * cout + col0 + cc]
                      : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int j = 0; j < kPerA; ++j) {
          const int e = tid + j * kThreads;
          a[(e / kBK) * kAS + e % kBK] = va[j];
        }
#pragma unroll
        for (int j = 0; j < kPerB; ++j) {
          const int e = tid + j * kThreads;
          b[(e / BN) * S::kBS + e % BN] = vb[j];
        }
      }
      if constexpr (Live::kAlways) {
        if (++it_k == nk) {
          it_k = 0;
          rest &= rest - 1;
          it_term = rest ? __ffs(rest) - 1 : 0;
        }
      } else {
        it_chunks &= it_chunks - 1;
        if (it_chunks == 0) {
          rest &= rest - 1;
          it_term = rest ? __ffs(rest) - 1 : 0;
          it_chunks = rest ? chunk_s[it_term] : 0u;
        }
        it_k = it_chunks ? __ffs(it_chunks) - 1 : 0;
      }
    };

    // Live only: the compute side's count of chunks left in its term
    unsigned c_rest = live;
    int c_left = 0;
    if constexpr (!Live::kAlways) {
      c_left = c_rest ? __popc(chunk_s[__ffs(c_rest) - 1]) : 0;
    }
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
      const bf16* a = a_s + slot * kBM * kAS + wm * 32 * kAS;
      const bf16* b = b_s + slot * kBK * S::kBS + wn * 32;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
        load_a(af, a + kk, kAS, lane);
        load_b_trans(bfr, b + kk * S::kBS, S::kBS, lane);
        mma_32x32(tacc, af, bfr);
      }
      if constexpr (Live::kAlways) {
        if ((s + 1) % nk == 0) add_and_clear(acc, tacc);
      } else {
        if (--c_left == 0) {  // the term's last live chunk
          add_and_clear(acc, tacc);
          c_rest &= c_rest - 1;
          c_left = c_rest ? __popc(chunk_s[__ffs(c_rest) - 1]) : 0;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // src_s, warp_live and chunk_s are rewritten next
  }

  const int r0 = row0 + wm * 32;
  const int c0 = col0 + wn * 32;
  if (part == nullptr) {
    store_tile(out, acc, r0, c0, n_out, cout, lane);
  } else {
    store_tile(part + static_cast<long long>(blockIdx.z) * n_out * cout, acc,
               r0, c0, n_out, cout, lane);
  }
}

// out[e] = sum over k < parts of part[k * n + e], k ascending, stored in
// TOut (bf16: rounded once).
template <typename TOut>
__global__ void split_reduce_kernel(const float* __restrict__ part, int parts,
                                    long long n, TOut* __restrict__ out) {
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < parts; ++k) s += part[k * n + e];
    store_f(out + e, s);
  }
}

// One launch of the core (and of the reduction when parts > 1) into out
// of type TOut: bf16 (the core rounds once), or float (K6: the core
// stores its f32 sums, straight into out when parts == 1).
template <int BN, bool kVec, typename Live, typename Rows, typename TOut>
int launch_bn(const bf16* src, int c, Rows rows, const bf16* w,
              int n_terms, int parts, int per, int n_out, int cout,
              TOut* out, float* part, Live lv, cudaStream_t stream) {
  auto kernel = gather_mma_kernel<BN, kVec, Live, Rows>;
  constexpr int kBytes = GatherSmem<BN>::kBytes;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes));
  if (err != 0) return err;
  dim3 grid(static_cast<unsigned>((n_out + kBM - 1) / kBM),
            static_cast<unsigned>((cout + BN - 1) / BN),
            static_cast<unsigned>(parts));
  bf16* out_bf16 = nullptr;
  float* out_f32 = parts > 1 ? part : nullptr;
  if constexpr (std::is_same_v<TOut, float>) {
    if (parts <= 1) out_f32 = out;
  } else {
    out_bf16 = out;
  }
  kernel<<<grid, 2 * BN, kBytes, stream>>>(src, c, rows, w, n_terms, per,
                                           n_out, cout, out_bf16, out_f32,
                                           lv);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || parts <= 1) return err;
  const long long n = static_cast<long long>(n_out) * cout;
  const long long blocks = (n + 255) / 256;
  split_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                        256, 0, stream>>>(part, parts, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The core over any row source: n_terms terms into out [n_out, cout] of
// type TOut. bn: column tile (32, 64, 96 or 128; 32 when vec is false,
// the element-by-element staging); parts, per: the split (parts == 1: no
// scratch; per: terms per part, or under a step-splitting policy steps
// per part, which the policy reads); part: f32 scratch
// [parts, n_out, cout].
template <typename Rows, typename Live, typename TOut>
int launch_rows(const void* src_v, int c, Rows rows, const void* w,
                int n_terms, long long n_out, int cout, int bn, bool vec,
                int parts, int per, float* part, TOut* o, cudaStream_t stream,
                Live lv) {
  if (n_out <= 0 || cout <= 0) return 0;
  if (parts < 1 || per < 1 || (parts > 1 && part == nullptr) ||
      parts > 65535 || n_out > 0x7fffffff ||
      (!SplitsSteps<Live>::value &&
       static_cast<long long>(parts) * per < n_terms) ||
      (!Live::kAlways && c > 32 * kBK))  // one mask bit per chunk
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const bf16*>(src_v);
  const auto* ww = static_cast<const bf16*>(w);
  const int n = static_cast<int>(n_out);
  if (!vec) {
    if (bn != 32) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bn<32, false>(s, c, rows, ww, n_terms, parts, per, n, cout,
                                o, part, lv, stream);
  }
  switch (bn) {
    case 32:
      return launch_bn<32, true>(s, c, rows, ww, n_terms, parts, per, n,
                                 cout, o, part, lv, stream);
    case 64:
      return launch_bn<64, true>(s, c, rows, ww, n_terms, parts, per, n,
                                 cout, o, part, lv, stream);
    case 96:
      return launch_bn<96, true>(s, c, rows, ww, n_terms, parts, per, n,
                                 cout, o, part, lv, stream);
    case 128:
      return launch_bn<128, true>(s, c, rows, ww, n_terms, parts, per, n,
                                  cout, o, part, lv, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2's bf16 kernel (and K3's d_feats half, and K5's with its liveness
// policy lv): the windowed gather-matmul over a plan on tensor cores,
// bf16 out. bn: column tile (32, 64, 96 or 128; 32 when C or Cout is not
// a multiple of 8); parts, per: the term split (parts == 1: no scratch);
// part: f32 scratch [parts, n_tiles * tile, cout].
template <typename Live = AllLive>
int launch_gather_matmul(const void* feats, int n_rows, int c,
                         const int32_t* starts, const int32_t* idx,
                         const void* w, int groups, int n_tiles, int members,
                         int tile, int cout, int bn, int parts, int per,
                         float* part, void* out, cudaStream_t stream,
                         Live lv = Live{}) {
  const PlanRows rows{starts, idx, n_tiles, members, tile, n_rows};
  return launch_rows(feats, c, rows, w, groups * members,
                     static_cast<long long>(n_tiles) * tile, cout, bn,
                     c % 8 == 0 && cout % 8 == 0, parts, per, part,
                     static_cast<bf16*>(out), stream, lv);
}

}  // namespace tc
}  // namespace ndt
