// LSD radix sort of 64-bit words, shared by K1 (forward.cu) and K15a
// (depgraph.cu): 8-bit digits; per pass a per-tile histogram with
// warp-aggregated shared atomics, a parallel scan of each digit's row of
// tile counts, and a stable scatter that ranks lanes with
// __match_any_sync, so no pass serializes on a hot digit.  An optional
// int32 payload rides the scatter (K15a's wide mode), and an optional
// device flag `due` makes every pass return at once when it is 0 (the
// audit's cadence gate).
#pragma once

#include "common.cuh"

// Every function has internal linkage (static): each source that includes
// this header has its own copy.
namespace dt_radix {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSortThreads = 256;
constexpr int kSortTile = 2048;              // lanes per block
constexpr int kSortWarps = kSortThreads / 32;
static_assert(kSortThreads == kRadix, "scatter scans one digit per thread");

struct AddOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

static __device__ __forceinline__ uint32_t digit_of(uint64_t w, int shift) {
  return static_cast<uint32_t>(w >> shift) & (kRadix - 1);
}

// counts[d * nblk + b] = lanes of tile b with digit d
static __global__ void radix_hist_kernel(const uint64_t* __restrict__ in,
                                         int n, int shift,
                                         uint32_t* __restrict__ counts,
                                         const uint8_t* __restrict__ due) {
  if (due != nullptr && !*due) return;
  __shared__ uint32_t h[kRadix];
  for (int i = threadIdx.x; i < kRadix; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int base = blockIdx.x * kSortTile;
  const int lane = threadIdx.x & 31;
  for (int off = threadIdx.x; off < kSortTile; off += blockDim.x) {
    const int idx = base + off;
    const bool valid = idx < n;
    const uint32_t d = valid ? digit_of(in[idx], shift) : 0xFFFFu;
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRadix; i += blockDim.x)
    counts[i * gridDim.x + blockIdx.x] = h[i];
}

// Row d of counts (digit d over all tiles) to its exclusive prefix, in
// place; totals[d] = the row's sum.  One block per digit.
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

// Stable scatter of tile b's lanes: digit d's lanes start at the sum of
// all smaller digits' totals plus row d's prefix at b.  blockDim.x must be
// kRadix (one digit per thread for the digit-base scan).
static __global__ void radix_scatter_kernel(const uint64_t* __restrict__ in,
                                            uint64_t* __restrict__ out, int n,
                                            int shift,
                                            const uint32_t* __restrict__ offsets,
                                            const uint32_t* __restrict__ totals,
                                            const int32_t* __restrict__ pin,
                                            int32_t* __restrict__ pout,
                                            const uint8_t* __restrict__ due) {
  if (due != nullptr && !*due) return;
  __shared__ uint32_t base_off[kRadix];
  __shared__ uint32_t warp_cnt[kSortWarps][kRadix];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  {
    const uint32_t t = totals[threadIdx.x];
    uint32_t unused;
    const uint32_t incl = dt_block_incl_scan(t, AddOp(), 0u, unused);
    base_off[threadIdx.x] =
        incl - t + offsets[threadIdx.x * gridDim.x + blockIdx.x];
  }
  const int tile0 = blockIdx.x * kSortTile;
  for (int c = 0; c < kSortTile; c += kSortThreads) {
    for (int i = threadIdx.x; i < kSortWarps * kRadix; i += blockDim.x)
      (&warp_cnt[0][0])[i] = 0u;
    __syncthreads();
    const int idx = tile0 + c + threadIdx.x;
    const bool valid = idx < n;
    const uint64_t v = valid ? in[idx] : 0ull;
    const uint32_t d = valid ? digit_of(v, shift) : 0xFFFFu;
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const uint32_t below = __popc(peers & ((1u << lane) - 1u));
    if (valid && lane == __ffs(peers) - 1) warp_cnt[warp][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      uint32_t pos = base_off[d] + below;
      for (int w = 0; w < warp; ++w) pos += warp_cnt[w][d];
      out[pos] = v;
      if (pout != nullptr) pout[pos] = pin[idx];
    }
    __syncthreads();
    uint32_t t = 0;
    for (int w = 0; w < kSortWarps; ++w) t += warp_cnt[w][threadIdx.x];
    base_off[threadIdx.x] += t;
    __syncthreads();
  }
}

// Sort the n words of `a` (with the payload `pa`, when not null) by their
// bits [lo, hi), 8 bits a pass, with `b` (`pb`) as the second buffer;
// `counts` holds kRadix * (ceil(n / kSortTile) + 1) uint32.  On return `a`
// and `pa` name the buffers that hold the sorted words and payload.
static inline void sort_pairs_bits(uint64_t*& a, uint64_t*& b, int32_t*& pa,
                                   int32_t*& pb, int n, int lo, int hi,
                                   uint32_t* counts, cudaStream_t s,
                                   const uint8_t* due = nullptr) {
  const int nblk = (n + kSortTile - 1) / kSortTile;
  uint32_t* totals = counts + kRadix * nblk;
  for (int shift = lo; shift < hi; shift += kRadixBits) {
    radix_hist_kernel<<<nblk, kSortThreads, 0, s>>>(a, n, shift, counts, due);
    radix_rowscan_kernel<<<kRadix, 1024, 0, s>>>(counts, nblk, totals, due);
    radix_scatter_kernel<<<nblk, kSortThreads, 0, s>>>(
        a, b, n, shift, counts, totals, pa, pb, due);
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
                                  int hi, uint32_t* counts, cudaStream_t s,
                                  const uint8_t* due = nullptr) {
  int32_t* pa = nullptr;
  int32_t* pb = nullptr;
  sort_pairs_bits(a, b, pa, pb, n, lo, hi, counts, s, due);
  return a;
}

}  // namespace dt_radix
