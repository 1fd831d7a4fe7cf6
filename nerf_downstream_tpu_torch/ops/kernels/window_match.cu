// K1 window_match and its window-starts pass: the window plan of a sorted
// key table, built on the card in two launches with no host round trip.
//
// K1 replaces the Pallas TPU kernel window_match_pallas
// (nerf_downstream_tpu/ops/pallas/window_gather.py:387, body _match_kernel
// :344). For each output tile t and offset group g, the query keys of the
// tile's rows are shifted by the static 64-bit delta of each member m
// (uniform unsigned add with carry; masked rows get the sentinel pair
// 0xFFFFFFFF/0xFFFFFFFE) and matched against the coverage window of the
// sorted key table that starts at starts[g, t]. Rows past the table read
// as 0xFFFFFFFF/0xFFFFFFFF, the padding the reference appends.
// Output idx[g, t, m, i]: the in-window rank of the match, -1 when none.
// The reference takes the max over matching ranks; the window is sorted
// (valid keys ascending, invalid and padding keys last), so the last key
// <= query found by binary search is that same rank, duplicates included.
//
// The pass computes what the reference's build_plan_direct computes around
// its match kernel (nerf_downstream_tpu/ops/window_conv.py:241-265), which
// runs there under jit: per (group, member) and tile the lower bound of the
// tile's first query key shifted by the member's delta (n_valid_in for a
// tile past the valid rows, and n_valid_in after the last tile), per group
// the min over members of the tile's bound (smin) and the max of the next
// tile's (emax), the running max of smin over the tiles clamped at 0 and
// floored to the window (starts), and the count of (group, tile) windows
// whose bounds span more than the coverage (n_escaped). The lower bound is
// packing.lower_bound_hier_keys's, bit for bit: over a table of n rows with
// n % 256 == 0 and n > 256, the block-top keys below the query pick a
// 256-row block and the keys below the query inside it are counted (a
// binary search of each, exact on a sorted table); otherwise
// packing.lower_bound_keys's fixed bit_length(n) rounds with clamped reads,
// overshoot to n + 1 included.
//
// Deltas: every (group, member)'s 64-bit key delta is a kernel parameter
// (at most kMaxTerms pairs), as the Pallas kernel takes them as static
// constants, so no delta tensor is made or copied. n_valid_in and
// n_valid_out are device scalars read by the kernel: nothing waits on the
// host.
//
// Bound on the H100: bytes. Per plan K1 must read the key table (8 B a
// row) and the query keys and mask (9 B a row) once and write idx (4 B per
// (g, m, row)); its ~log2(coverage) compares per entry are a few integer
// operations per byte. At the 64k eval batch's finest same-set plan (65,536
// rows, G = 9, M = 3, T = 256, coverage 512) that is 8.2 MB: 2.4 us at
// 3.35 TB/s. The pass reads G x M x nT boundary keys and a few table keys
// per search and writes 2 G nT words: well under a microsecond of bytes; its
// limit is the latency of its dependent searches.
//
// Design of K1. A block of up to 128 threads owns `rows` rows of one tile
// and one group (the wrapper picks rows so that even the 512-row plans
// give the 132 SMs a few hundred blocks); its threads take the (member,
// row) pairs in turn, the first pair's query key loaded before the
// barrier, and run one binary search per pair in shared memory. The
// kernel is held to 32 registers so that 16 blocks stay resident per SM:
// each block's latency chain (its start, its window, its searches) hides
// behind the others'. The window is staged as 64-bit keys with 16-byte
// loads of the hi and lo words (element loads at a misaligned or ragged
// edge); the deltas go to shared memory; writes are coalesced along the
// row.
// Design of the pass. Blocks of 128 threads, each thread one (member,
// tile) search of its block's group, so a large plan's searches spread
// over the SMs: the valid counts, the thread's boundary key and the
// table's block-top keys are loaded before one barrier; the top search
// runs in shared memory, the 256-row block in two rounds of 16
// independent loads; the bound goes to a scratch array. The last block to
// finish (a device-wide ticket after a fence) runs a warp per group over
// its tiles: the min and max over members, the running max (a serial run
// per lane, then a warp scan), the floor, the escape count, and the
// groups' counts added in group order.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxTerms = 32;

// the (group, member) deltas in g * members + m order, by value (outside
// the unnamed namespace: the C entry points take it and keep C linkage)
struct Deltas {
  uint32_t hi[kMaxTerms];
  uint32_t lo[kMaxTerms];
};

namespace {

constexpr int kHierBlock = 256;
constexpr int kPassThreads = 128;
constexpr int kStageBatch = 32;  // loads per thread in flight at once
constexpr int kMatchThreads = 128;

__device__ __forceinline__ unsigned long long key_at(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo, long long r) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(hi[r])) << 32) |
         static_cast<uint32_t>(lo[r]);
}

// delta words of term q; static indices keep the parameter in its bank
__device__ __forceinline__ void delta_of(const Deltas& d, int q, uint32_t& wh,
                                         uint32_t& wl) {
  wh = 0;
  wl = 0;
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k) {
    if (k == q) {
      wh = d.hi[k];
      wl = d.lo[k];
    }
  }
}

__device__ __forceinline__ unsigned long long shifted(uint32_t oh, uint32_t ol,
                                                      bool valid, uint32_t wh,
                                                      uint32_t wl) {
  uint32_t ql = ol + wl;
  uint32_t qh = oh + wh + (ql < ol ? 1u : 0u);
  if (!valid) {
    qh = 0xFFFFFFFFu;
    ql = 0xFFFFFFFEu;
  }
  return (static_cast<unsigned long long>(qh) << 32) | ql;
}

// packing.lower_bound_keys: bit_length(n) fixed rounds, reads clamped to
// row n - 1
__device__ int lower_bound_fixed(const int32_t* __restrict__ hi,
                                 const int32_t* __restrict__ lo, int n,
                                 unsigned long long q) {
  long long a = 0, z = n;
  const int rounds = max(1, 32 - __clz(n));
  for (int r = 0; r < rounds; ++r) {
    const long long mid = (a + z) >> 1;
    const bool less = key_at(hi, lo, mid < n - 1 ? mid : n - 1) < q;
    if (less) {
      a = mid + 1;
    } else {
      z = mid;
    }
  }
  return static_cast<int>(a);
}

// packing.lower_bound_hier_keys's two-level count over a sorted table
__device__ int lower_bound_hier(const unsigned long long* tops, int nb,
                                const int32_t* __restrict__ hi,
                                const int32_t* __restrict__ lo,
                                unsigned long long q) {
  int a = 0, z = nb;  // tops below q
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (tops[mid] < q) {
      a = mid + 1;
    } else {
      z = mid;
    }
  }
  const int b = min(max(a - 1, 0), nb - 1);
  // rows of the block below q, in two rounds of independent loads: the
  // first key of each 16-row part, then the 16 rows of the part that holds
  // the boundary (every row before it is below q, none after it)
  const long long base = static_cast<long long>(b) * kHierBlock;
  int parts = 0;
#pragma unroll
  for (int j = 0; j < kHierBlock / 16; ++j)
    parts += key_at(hi, lo, base + 16 * j) < q ? 1 : 0;
  if (parts == 0) return static_cast<int>(base);
  const long long part = base + 16 * (parts - 1);
  int below = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) below += key_at(hi, lo, part + i) < q ? 1 : 0;
  return static_cast<int>(part) + below;
}

__device__ unsigned int g_pass_blocks_done = 0;

// Grid (ceil(members * n_tiles / kPassThreads), groups): each thread one
// (member, tile) search of its block's group, its bound to bnd
// [groups, members, n_tiles]; the last block to finish scans every group.
__global__ void __launch_bounds__(kPassThreads) window_starts_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo, int n_in,
    const int32_t* __restrict__ o_hi, const int32_t* __restrict__ o_lo,
    const int32_t* __restrict__ n_valid_in_p,
    const int32_t* __restrict__ n_valid_out_p, Deltas d, int members,
    int n_tiles, int tile, int window, int cov, int32_t* __restrict__ bnd,
    int32_t* __restrict__ starts, int32_t* __restrict__ emax,
    int32_t* __restrict__ counts) {
  // the block-top keys; in the last block, the bounds of every group
  extern __shared__ __align__(16) unsigned long long tops[];
  int* bnd_s = reinterpret_cast<int*>(tops);
  __shared__ bool is_last;
  const int g = blockIdx.y;
  const int groups = gridDim.y;
  const int tid = threadIdx.x;
  const int e = blockIdx.x * blockDim.x + tid;
  const int work = members * n_tiles;
  const bool hier = n_in % kHierBlock == 0 && n_in > kHierBlock;
  const int nb = hier ? n_in / kHierBlock : 0;

  // the valid counts, this thread's boundary key and the block-top keys
  // are all in flight before the one barrier
  const int nvi = *n_valid_in_p;
  const int nvo = *n_valid_out_p;
  const int m = e < work ? e / n_tiles : 0;
  const int t = e - m * n_tiles;
  const long long row = static_cast<long long>(t) * tile;
  uint32_t oh = 0, ol = 0;
  if (e < work) {
    oh = static_cast<uint32_t>(o_hi[row]);
    ol = static_cast<uint32_t>(o_lo[row]);
  }
  for (int j = tid; j < nb; j += blockDim.x)
    tops[j] = key_at(hi, lo, static_cast<long long>(j) * kHierBlock);
  __syncthreads();
  if (e < work) {
    int b = nvi;
    if (row < nvo) {
      uint32_t wh, wl;
      delta_of(d, g * members + m, wh, wl);
      const unsigned long long q = shifted(oh, ol, true, wh, wl);
      b = hier ? lower_bound_hier(tops, nb, hi, lo, q)
               : lower_bound_fixed(hi, lo, n_in, q);
    }
    bnd[(g * members + m) * n_tiles + t] = b;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned last = gridDim.x * gridDim.y - 1;
    is_last = atomicInc(&g_pass_blocks_done, last) == last;
  }
  __syncthreads();
  if (!is_last) return;

  // the last block: every bound to shared memory (in batches of loads in
  // flight together, past L1), then a warp per group runs over its tiles. smin(t)
  // is the min over members of bnd[., t], emax the max of bnd[., t + 1]
  // (nvi after the last tile); the running max of smin over the tiles is
  // a serial run over each lane's tiles, then a warp scan.
  const int total = groups * work;
  for (int k0 = tid; k0 < total; k0 += kStageBatch * blockDim.x) {
    int v[kStageBatch];  // a batch of loads in flight before any store
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int k = k0 + u * blockDim.x;
      v[u] = k < total ? __ldcg(bnd + k) : 0;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < total) bnd_s[k] = v[u];
    }
  }
  __syncthreads();
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const int chunk = (n_tiles + 31) / 32;
  const int t0 = min(n_tiles, lane * chunk);
  const int t1 = min(n_tiles, t0 + chunk);
  for (int gg = tid >> 5; gg < groups; gg += n_warps) {
    const int* gb = bnd_s + gg * work;
    auto smin = [&](int u) {
      int v = gb[u];
      for (int k = 1; k < members; ++k) v = min(v, gb[k * n_tiles + u]);
      return v;
    };
    int run = INT_MIN;
    for (int u = t0; u < t1; ++u) run = max(run, smin(u));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run = max(run, v);
    }
    int prefix = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) prefix = INT_MIN;
    int esc = 0;
    run = prefix;
    for (int u = t0; u < t1; ++u) {
      run = max(run, smin(u));
      const int st = max(run, 0) / window * window;
      int em = nvi;
      if (u + 1 < n_tiles) {
        em = gb[u + 1];
        for (int k = 1; k < members; ++k) em = max(em, gb[k * n_tiles + u + 1]);
      }
      starts[gg * n_tiles + u] = st;
      emax[gg * n_tiles + u] = em;
      esc += (em - st > cov) ? 1 : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      esc += __shfl_down_sync(0xffffffffu, esc, o);
    if (lane == 0) counts[gg] = esc;
  }
  __syncthreads();
  if (tid == 0) {  // the groups' counts, added in group order
    int total = 0;
    for (int k = 0; k < groups; ++k) total += counts[k];
    counts[groups] = total;
  }
}

__global__ void __launch_bounds__(kMatchThreads, 16) window_match_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo, int n_in,
    const int32_t* __restrict__ o_hi, const int32_t* __restrict__ o_lo,
    const uint8_t* __restrict__ o_mask, Deltas d,
    const int32_t* __restrict__ starts, int n_tiles, int members, int tile,
    int rows, int cov, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned long long win[];
  __shared__ uint32_t dh_s[kMaxTerms], dl_s[kMaxTerms];
  const int splits = tile / rows;
  const int t = blockIdx.x / splits;
  const int i0 = (blockIdx.x - t * splits) * rows;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int work = rows * members;
  const int start = starts[g * n_tiles + t];

  // this thread's first (member, row) pair: its query key is loaded
  // before the window arrives
  int e = tid;
  uint32_t oh = 0, ol = 0;
  bool valid = false;
  if (e < work) {
    const int m = e / rows;
    const long long row = static_cast<long long>(t) * tile + i0 + e - m * rows;
    oh = static_cast<uint32_t>(o_hi[row]);
    ol = static_cast<uint32_t>(o_lo[row]);
    valid = o_mask[row] != 0;
  }
  if (tid < kMaxTerms) delta_of(d, tid, dh_s[tid], dl_s[tid]);

  const bool vec =
      ((reinterpret_cast<uintptr_t>(hi) | reinterpret_cast<uintptr_t>(lo)) &
       15) == 0 &&
      (start & 3) == 0;
  for (int j = tid * 4; j < cov; j += blockDim.x * 4) {
    const long long r = static_cast<long long>(start) + j;
    if (vec && r >= 0 && r + 3 < n_in && j + 3 < cov) {
      const int4 h = *reinterpret_cast<const int4*>(hi + r);
      const int4 l = *reinterpret_cast<const int4*>(lo + r);
      const int hv[4] = {h.x, h.y, h.z, h.w};
      const int lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        win[j + k] =
            (static_cast<unsigned long long>(static_cast<uint32_t>(hv[k]))
             << 32) |
            static_cast<uint32_t>(lv[k]);
    } else {
      for (int k = 0; k < 4 && j + k < cov; ++k) {
        const long long rk = r + k;
        win[j + k] = (rk >= 0 && rk < n_in) ? key_at(hi, lo, rk) : ~0ull;
      }
    }
  }
  __syncthreads();

  auto match = [&](int m, int i) {
    const int term = g * members + m;
    const unsigned long long q =
        shifted(oh, ol, valid, dh_s[term], dl_s[term]);
    int a = 0, b = cov;  // first rank with win[rank] > q
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (win[mid] <= q) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    idx[((static_cast<long long>(g) * n_tiles + t) * members + m) * tile + i0 +
        i] = (a > 0 && win[a - 1] == q) ? a - 1 : -1;
  };
  auto load = [&](int i) {
    const long long row = static_cast<long long>(t) * tile + i0 + i;
    oh = static_cast<uint32_t>(o_hi[row]);
    ol = static_cast<uint32_t>(o_lo[row]);
    valid = o_mask[row] != 0;
  };
  if (rows % blockDim.x == 0) {
    // the threads tile the rows: each row's key is loaded once and
    // matched for every member (the first row's before the barrier)
    for (int i = tid; i < rows; i += blockDim.x) {
      if (i != tid) load(i);
      for (int m = 0; m < members; ++m) match(m, i);
    }
  } else {
    // fewer rows than threads: the pairs in turn, e = m * rows + i
    for (; e < work; e += blockDim.x) {
      const int m = e / rows;
      if (e != tid) load(e - m * rows);
      match(m, e - m * rows);
    }
  }
}

// Opts the kernel in to ``bytes`` of dynamic shared memory where the
// default 48 KB would not hold them beside its static shared memory
// (the delta words or a flag, under 1 KB): dynamic bytes just under
// 48 KB fail to launch without the opt-in.
int set_smem(const void* kernel, size_t bytes) {
  if (bytes + 1024 <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

// Window starts of a plan: starts and emax int32[groups, n_tiles], counts
// int32[groups + 1] (each group's escaped windows, then their sum:
// n_escaped), bnd int32[groups, members, n_tiles] scratch.
// n_valid_in / n_valid_out: device int32 scalars. Launches on one stream
// at a time: the blocks count themselves in one device-wide counter.
extern "C" int window_starts_launch(
    const int32_t* hi, const int32_t* lo, int n_in, const int32_t* o_hi,
    const int32_t* o_lo, const int32_t* n_valid_in, const int32_t* n_valid_out,
    Deltas deltas, int groups, int members, int n_tiles, int tile, int window,
    int cov, int32_t* bnd, int32_t* starts, int32_t* emax, int32_t* counts,
    void* stream) {
  if (groups <= 0 || n_tiles <= 0 || n_in <= 0 || members <= 0 ||
      groups * members > kMaxTerms)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool hier = n_in % kHierBlock == 0 && n_in > kHierBlock;
  const size_t smem =
      max(hier ? static_cast<size_t>(n_in / kHierBlock) * 8 : 0,
          static_cast<size_t>(groups) * members * n_tiles * 4);
  int err = set_smem(reinterpret_cast<const void*>(window_starts_kernel), smem);
  if (err != 0) return err;
  dim3 grid((members * n_tiles + kPassThreads - 1) / kPassThreads, groups);
  window_starts_kernel<<<grid, kPassThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      hi, lo, n_in, o_hi, o_lo, n_valid_in, n_valid_out, deltas, members,
      n_tiles, tile, window, cov, bnd, starts, emax, counts);
  return static_cast<int>(cudaGetLastError());
}

// K1: idx int32[groups, n_tiles, members, tile]; rows: rows per block (a
// divisor of tile).
extern "C" int window_match_launch(
    const int32_t* hi, const int32_t* lo, int n_in, const int32_t* o_hi,
    const int32_t* o_lo, const uint8_t* o_mask, Deltas deltas,
    const int32_t* starts, int groups, int n_tiles, int members, int tile,
    int rows, int cov, int32_t* idx, void* stream) {
  if (groups <= 0 || n_tiles <= 0) return 0;
  if (rows <= 0 || tile % rows != 0 || groups * members > kMaxTerms)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(cov) * sizeof(unsigned long long);
  int err = set_smem(reinterpret_cast<const void*>(window_match_kernel), smem);
  if (err != 0) return err;
  const int threads = min(kMatchThreads, (rows * members + 31) / 32 * 32);
  dim3 grid(n_tiles * (tile / rows), groups);
  window_match_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      hi, lo, n_in, o_hi, o_lo, o_mask, deltas, starts, n_tiles, members,
      tile, rows, cov, idx);
  return static_cast<int>(cudaGetLastError());
}
