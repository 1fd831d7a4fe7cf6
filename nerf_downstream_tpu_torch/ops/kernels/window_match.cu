// K1 window_match: in-window neighbour indices by packed-key equality.
//
// Replaces the Pallas TPU kernel window_match_pallas
// (nerf_downstream_tpu/ops/pallas/window_gather.py:387, body _match_kernel
// :344). For each output tile t and offset group g, the query keys of the
// tile's rows are shifted by the static 64-bit delta of each member m
// (uniform unsigned add with carry; masked rows get the sentinel pair
// 0xFFFFFFFF/0xFFFFFFFE) and matched against the coverage window of the
// sorted key table that starts at starts[g, t]. Rows past the table read
// as 0xFFFFFFFF/0xFFFFFFFF, the padding the reference appends.
//
// Output idx[g, t, m, i]: the in-window rank of the match, -1 when none.
// The reference takes the max over matching ranks; the window is sorted
// (valid keys ascending, invalid and padding keys last), so the last key
// <= query found by binary search is that same rank, duplicates included.
//
// Bound on the H100: bytes. Per plan the kernel must read the key table
// (8 B a row) and the query keys and mask (9 B a row) once and write idx
// (4 B per (g, m, row)); its ~log2(coverage) compares per entry are a few
// integer operations per byte. At the 64k eval batch's finest same-set
// plan (65,536 rows, G = 9, M = 3, T = 256, coverage 512) that is 8.2 MB:
// 2.4 us at 3.35 TB/s, beside ~16M compares that take far less.
// Design: one block per (tile, group) stages the group's window as 64-bit
// keys in shared memory (coverage <= 1536 rows = 12 KB at the model's
// plans, so the whole window fits), each thread takes query rows and runs
// one binary search per member in shared memory; writes are coalesced
// along the tile row. Every window is read from L2 once per (tile, group)
// rather than once per query, which keeps DRAM traffic near the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void window_match_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo, int n_in,
    const int32_t* __restrict__ o_hi, const int32_t* __restrict__ o_lo,
    const uint8_t* __restrict__ o_mask, const int32_t* __restrict__ deltas,
    const int32_t* __restrict__ starts, int n_tiles, int members, int tile,
    int cov, int32_t* __restrict__ idx) {
  extern __shared__ unsigned long long win[];
  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int start = starts[g * n_tiles + t];
  for (int j = threadIdx.x; j < cov; j += blockDim.x) {
    const long long r = static_cast<long long>(start) + j;
    unsigned long long key = ~0ull;
    if (r >= 0 && r < n_in) {
      key = (static_cast<unsigned long long>(static_cast<uint32_t>(hi[r]))
             << 32) |
            static_cast<uint32_t>(lo[r]);
    }
    win[j] = key;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int row = t * tile + i;
    const uint32_t oh = static_cast<uint32_t>(o_hi[row]);
    const uint32_t ol = static_cast<uint32_t>(o_lo[row]);
    const bool valid = o_mask[row] != 0;
    for (int m = 0; m < members; ++m) {
      const uint32_t wh = static_cast<uint32_t>(deltas[(g * members + m) * 2]);
      const uint32_t wl =
          static_cast<uint32_t>(deltas[(g * members + m) * 2 + 1]);
      uint32_t ql = ol + wl;
      uint32_t qh = oh + wh + (ql < ol ? 1u : 0u);
      if (!valid) {
        qh = 0xFFFFFFFFu;
        ql = 0xFFFFFFFEu;
      }
      const unsigned long long q =
          (static_cast<unsigned long long>(qh) << 32) | ql;
      int a = 0, b = cov;  // first rank with win[rank] > q
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (win[mid] <= q) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      const int hit = (a > 0 && win[a - 1] == q) ? a - 1 : -1;
      idx[((static_cast<long long>(g) * n_tiles + t) * members + m) * tile +
          i] = hit;
    }
  }
}

}  // namespace

extern "C" int window_match_launch(
    const int32_t* hi, const int32_t* lo, int n_in, const int32_t* o_hi,
    const int32_t* o_lo, const uint8_t* o_mask, const int32_t* deltas,
    const int32_t* starts, int groups, int n_tiles, int members, int tile,
    int cov, int32_t* idx, void* stream) {
  if (groups <= 0 || n_tiles <= 0) return 0;
  const size_t smem = static_cast<size_t>(cov) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n_tiles, groups);
  window_match_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      hi, lo, n_in, o_hi, o_lo, o_mask, deltas, starts, n_tiles, members,
      tile, cov, idx);
  return static_cast<int>(cudaGetLastError());
}
