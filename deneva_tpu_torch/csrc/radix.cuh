// LSD radix sort of 64-bit words, shared by K1 (forward.cu) and K15a
// (depgraph.cu), one sweep over the words per 8-bit pass:
//   radix_init_kernel   zeroes the pass histograms and tile counters;
//   radix_hist_kernel   reads the words once and builds every pass's
//                       digit histogram (shared-memory counts, a warp whose
//                       lanes share a digit adds once; one global add per
//                       block, pass and digit) and zeroes the look-back
//                       status words;
//   radix_pass_kernel   one launch per pass: a block takes the next tile
//                       index from a device counter (tiles start in index
//                       order, which the look-back needs), ranks its words
//                       stably per warp with __match_any_sync (no pass
//                       serializes on a hot digit), publishes its digit
//                       counts, finds each digit's count in earlier tiles
//                       by a decoupled look-back over per-(tile, digit)
//                       status words (8 tiles a step), stages the tile
//                       in shared memory in digit order and stores it as
//                       coalesced runs.  A pass whose digits are all
//                       equal (the histogram says so) is a copy.
// So a pass costs one launch, one read and one write of the words, and the
// sort a fixed 2 + passes launches with no host sync.  A tile holds 256 x
// 8 words, or 4, 2, 1 a thread where that keeps >= 132 tiles (one a SM):
// a small sort runs on many SMs.  An optional int32 payload rides the
// scatter (K15a's wide mode), and an optional device flag `due` makes
// every launch return at once when it is 0 (the audit's cadence gate).
// radix_rowscan_kernel, a scan of rows of counts, serves K18a and K18b
// (mc.cu).
#pragma once

#include "common.cuh"

// Every function has internal linkage (static): each source that includes
// this header has its own copy.
namespace dt_radix {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kHistItems = 8;                 // words a hist thread reads
constexpr int kMinTiles = 132;
constexpr int kMaxPasses = 8;
constexpr int kLookback = 8;                  // status words read a step
static_assert(kSortThreads == kRadix, "one digit per thread");

// scratch: hist[kMaxPasses][kRadix] | counter[kMaxPasses] (32 words) |
// status[kMaxPasses][tiles][kRadix]
constexpr int kHistWords = kMaxPasses * kRadix;
constexpr int kStatusOffset = kHistWords + 32;
constexpr uint32_t kFlagAgg = 1u << 30;     // the tile's own count
constexpr uint32_t kFlagInc = 2u << 30;     // count through this tile
constexpr uint32_t kValueMask = kFlagAgg - 1u;
constexpr uint32_t kNoDigit = 0xFFFFu;

// words a pass thread holds: the most that keeps kMinTiles tiles
static inline int tile_items(int n) {
  int items = 8;
  while (items > 1 &&
         (n + kSortThreads * items - 1) / (kSortThreads * items) < kMinTiles)
    items /= 2;
  return items;
}

struct AddOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

static __device__ __forceinline__ uint32_t digit_of(uint64_t w, int shift) {
  return static_cast<uint32_t>(w >> shift) & (kRadix - 1);
}

static __global__ void radix_init_kernel(uint32_t* __restrict__ scratch,
                                         const uint8_t* __restrict__ due) {
  if (due != nullptr && !*due) return;
  for (int i = threadIdx.x; i < kStatusOffset; i += blockDim.x)
    scratch[i] = 0u;
}

// Every pass's histogram of the words; zero `status_words` status words.
static __global__ void __launch_bounds__(kSortThreads)
radix_hist_kernel(const uint64_t* __restrict__ in, int n, int lo, int passes,
                  uint32_t* __restrict__ scratch, long long status_words,
                  const uint8_t* __restrict__ due) {
  if (due != nullptr && !*due) return;
  __shared__ uint32_t h[kMaxPasses][kRadix];
  uint32_t* status = scratch + kStatusOffset;
  for (long long i = blockIdx.x * static_cast<long long>(kSortThreads) +
                     threadIdx.x;
       i < status_words; i += static_cast<long long>(gridDim.x) * kSortThreads)
    status[i] = 0u;
  for (int p = 0; p < passes; ++p) h[p][threadIdx.x] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kSortThreads * kHistItems;
  for (int u = 0; u < kHistItems; ++u) {
    const int idx = base + u * kSortThreads + threadIdx.x;
    const bool valid = idx < n;
    const uint64_t v = valid ? in[idx] : 0ull;
    for (int p = 0; p < passes; ++p) {
      const uint32_t d = valid ? digit_of(v, lo + kRadixBits * p) : kNoDigit;
      const uint32_t d0 = __shfl_sync(0xffffffffu, d, 0);
      if (__all_sync(0xffffffffu, d == d0)) {
        if (lane == 0 && valid) atomicAdd(&h[p][d], 32u);
      } else if (valid) {
        atomicAdd(&h[p][d], 1u);
      }
    }
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const uint32_t c = h[p][threadIdx.x];
    if (c) atomicAdd(&scratch[p * kRadix + threadIdx.x], c);
  }
}

// Pass p (bits [shift, shift + 8)) of the words `in` into `out`, tiles of
// kSortThreads * ITEMS words.
template <int ITEMS>
static __global__ void __launch_bounds__(kSortThreads)
radix_pass_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                  const int32_t* __restrict__ pin, int32_t* __restrict__ pout,
                  int n, int shift, int p, int tiles, uint32_t* scratch,
                  const uint8_t* __restrict__ due) {
  constexpr int kTile = kSortThreads * ITEMS;
  constexpr int kWarpSpan = 32 * ITEMS;
  if (due != nullptr && !*due) return;
  __shared__ uint64_t skey[kTile];
  __shared__ int32_t spay[kTile];
  __shared__ uint32_t wcnt[kSortWarps][kRadix];
  __shared__ uint32_t dstart[kRadix];
  __shared__ int32_t gbase[kRadix];
  __shared__ int tile_s;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) tile_s = static_cast<int>(atomicAdd(&scratch[kHistWords + p], 1u));
  for (int i = lane; i < kRadix; i += 32) wcnt[warp][i] = 0u;
  const uint32_t total = scratch[p * kRadix + t];
  if (__syncthreads_or(total == static_cast<uint32_t>(n))) {
    // one digit holds every word: the pass is a copy
    const int i0 = blockIdx.x * kTile;
    for (int i = i0 + t; i < n && i < i0 + kTile; i += kSortThreads) {
      out[i] = in[i];
      if (pout != nullptr) pout[i] = pin[i];
    }
    return;
  }
  const int tile = tile_s;
  const int base = tile * kTile + warp * kWarpSpan;
  uint64_t v[ITEMS];
  int32_t pv[ITEMS];
  uint32_t dg[ITEMS], rk[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int idx = base + u * 32 + lane;
    const bool valid = idx < n;
    v[u] = valid ? in[idx] : 0ull;
    pv[u] = valid && pin != nullptr ? pin[idx] : 0;
    dg[u] = valid ? digit_of(v[u], shift) : kNoDigit;
  }
  // stable rank inside the warp, items in lane order: the group's highest
  // lane reads and bumps the warp's count, a shuffle hands it to the group
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const uint32_t d = dg[u];
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const int leader = 31 - __clz(peers);
    uint32_t before = 0u;
    if (lane == leader && d != kNoDigit) {
      before = wcnt[warp][d];
      wcnt[warp][d] = before + __popc(peers);
    }
    before = __shfl_sync(peers, before, leader);
    __syncwarp();
    rk[u] = before + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  // thread t owns digit t: warp offsets, the tile's count, look-back
  uint32_t cnt = 0u;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const uint32_t c = wcnt[w][t];
    wcnt[w][t] = cnt;
    cnt += c;
  }
  volatile uint32_t* status =
      scratch + kStatusOffset + static_cast<size_t>(p) * tiles * kRadix;
  status[static_cast<size_t>(tile) * kRadix + t] =
      (tile == 0 ? kFlagInc : kFlagAgg) | cnt;
  uint32_t unused;
  const uint32_t start = dt_block_incl_scan(cnt, AddOp(), 0u, unused) - cnt;
  const uint32_t gstart = dt_block_incl_scan(total, AddOp(), 0u, unused) - total;
  // look back kLookback tiles a step: the loads of a step are issued
  // together, and a step ends at the first prefix (or unpublished tile)
  uint32_t prefix = 0u;
  if (tile > 0) {
    for (int j = tile - 1;;) {
      uint32_t s[kLookback];
#pragma unroll
      for (int q = 0; q < kLookback; ++q) {
        s[q] = kFlagInc;   // before tile 0: a prefix of 0
        if (j - q >= 0) s[q] = status[static_cast<size_t>(j - q) * kRadix + t];
      }
      int q = 0;
      bool done = false;
#pragma unroll
      for (int r = 0; r < kLookback; ++r) {
        if (done || s[r] == 0u) {  // tile j - r has not published yet
          done = true;
          continue;
        }
        prefix += s[r] & kValueMask;
        q = r + 1;
        if (s[r] & kFlagInc) {
          q = -1;
          done = true;
        }
      }
      if (q < 0) break;
      j -= q;
    }
    status[static_cast<size_t>(tile) * kRadix + t] = kFlagInc | (prefix + cnt);
  }
  dstart[t] = start;
  gbase[t] = static_cast<int32_t>(gstart + prefix) - static_cast<int32_t>(start);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const uint32_t d = dg[u];
    if (d == kNoDigit) continue;
    const uint32_t at = dstart[d] + wcnt[warp][d] + rk[u];
    skey[at] = v[u];
    spay[at] = pv[u];
  }
  __syncthreads();
  const int len = min(kTile, n - tile * kTile);
  for (int i = t; i < len; i += kSortThreads) {
    const uint64_t w = skey[i];
    const int at = gbase[digit_of(w, shift)] + i;
    out[at] = w;
    if (pout != nullptr) pout[at] = spay[i];
  }
}

// Row d of counts (digit d over all tiles) to its exclusive prefix, in
// place; totals[d] = the row's sum.  One block per row.
static __global__ void radix_rowscan_kernel(uint32_t* __restrict__ counts,
                                            int nblk,
                                            uint32_t* __restrict__ totals,
                                            const uint8_t* __restrict__ due) {
  if (due != nullptr && !*due) return;
  uint32_t* row = counts + static_cast<size_t>(blockIdx.x) * nblk;
  uint32_t carry = 0;
  for (int base = 0; base < nblk; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const uint32_t v = i < nblk ? row[i] : 0u;
    uint32_t total;
    const uint32_t incl = dt_block_incl_scan(v, AddOp(), 0u, total);
    if (i < nblk) row[i] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Sort the n words of `a` (with the payload `pa`, when not null) by their
// bits [lo, hi), 8 bits a pass (hi - lo <= 64), with `b` (`pb`) as the
// second buffer; `scratch` holds kStatusOffset + kMaxPasses * kRadix *
// ceil(n / (kSortThreads * tile_items(n))) uint32 (at most ceil(n / 256)
// tiles).  On return `a` and `pa`
// name the buffers that hold the sorted words and payload.
static inline void sort_pairs_bits(uint64_t*& a, uint64_t*& b, int32_t*& pa,
                                   int32_t*& pb, int n, int lo, int hi,
                                   uint32_t* scratch, cudaStream_t s,
                                   const uint8_t* due = nullptr) {
  if (n <= 0 || hi <= lo) return;
  const int items = tile_items(n);
  const int tiles = (n + kSortThreads * items - 1) / (kSortThreads * items);
  const int passes = (hi - lo + kRadixBits - 1) / kRadixBits;
  const int hblk = (n + kSortThreads * kHistItems - 1) /
                   (kSortThreads * kHistItems);
  radix_init_kernel<<<1, kSortThreads, 0, s>>>(scratch, due);
  radix_hist_kernel<<<hblk, kSortThreads, 0, s>>>(
      a, n, lo, passes, scratch,
      static_cast<long long>(passes) * tiles * kRadix, due);
  for (int p = 0; p < passes; ++p) {
    const int shift = lo + kRadixBits * p;
    if (items == 8)
      radix_pass_kernel<8><<<tiles, kSortThreads, 0, s>>>(
          a, b, pa, pb, n, shift, p, tiles, scratch, due);
    else if (items == 4)
      radix_pass_kernel<4><<<tiles, kSortThreads, 0, s>>>(
          a, b, pa, pb, n, shift, p, tiles, scratch, due);
    else if (items == 2)
      radix_pass_kernel<2><<<tiles, kSortThreads, 0, s>>>(
          a, b, pa, pb, n, shift, p, tiles, scratch, due);
    else
      radix_pass_kernel<1><<<tiles, kSortThreads, 0, s>>>(
          a, b, pa, pb, n, shift, p, tiles, scratch, due);
    uint64_t* t = a;
    a = b;
    b = t;
    int32_t* tp = pa;
    pa = pb;
    pb = tp;
  }
}

// The words alone; returns the buffer that holds the sorted words.
static inline uint64_t* sort_bits(uint64_t* a, uint64_t* b, int n, int lo,
                                  int hi, uint32_t* scratch, cudaStream_t s,
                                  const uint8_t* due = nullptr) {
  int32_t* pa = nullptr;
  int32_t* pb = nullptr;
  sort_pairs_bits(a, b, pa, pb, n, lo, hi, scratch, s, due);
  return a;
}

}  // namespace dt_radix
