// K14a + K14b: the probes of the port's two lookup indexes.
//
// K14a: HashIndex.lookup, TPC-C's CUSTOMER_LAST secondary index.
// Replaces deneva_tpu/storage/index.py:97 HashIndex.lookup (home bucket
// :324 _hash_jnp, then a fixed-depth linear probe of max_probe cells) as
// TPC-C's generator probes it once per epoch (workloads/tpcc.py:263
// _lastname_middle).  Design: one thread per query hashes it, walks at
// most max_probe cells and stops at a hit (the cell's slot) or an empty
// cell (miss_slot); a key not met within max_probe cells misses, as the
// reference's unrolled loop gives.
//   Bound: bytes — 4 B in and 4 B out per query, plus the cells a probe
//   walks (one 32 B sector per query at the index's load factor 0.5).
//
// K14b: SortedIndex.lookup, the ordered index of INDEX_STRUCT=IDX_BTREE.
//
// Replaces deneva_tpu/storage/index.py:155-166 SortedIndex._lower and
// lookup (jnp.searchsorted side="left", clip to n - 1, hit test, slot or
// miss_slot), as YCSB's primary path probes it (workloads/ycsb.py:184-192)
// once per epoch for every lane.
// Design: one thread per query, a branchless lower bound over the sorted
// int32 keys (the index halves the range with a select, no divergent
// branch), then one gather of the key and the slot.  Duplicate keys give
// the first entry, as searchsorted does.
//   Bound: bytes — 4 B in and 4 B out per query; the log2(n) probes per
//   query fall on the sorted keys' top levels, which stay in L2.
//
// K14e merge: DynamicSortedIndex.insert, TPC-C's dynamic ORDER index.
// Replaces deneva_tpu/storage/index.py:264 (one stable lax.sort of the
// BIG-padded live array ++ the m masked inserts, cut to cap; cnt +=
// popcount(mask)), as tpcc_order_index's NewOrders insert once per
// executed pass.  Design: the output equals a stable merge in which a
// live entry goes before a new one of the same key, so it is built
// without sorting cap + m keys, in two launches:
//   1. rank: each new entry's rank among the new entries by (key, lane),
//      masked lanes keyed BIG, by counting over tiles in shared memory
//      (O(m^2) compares; m is one epoch's batch), scattered into sorted
//      scratch; each block adds its popcount of the mask;
//   2. place: live entry p goes to p + #(new keys < key) and sorted new
//      entry i to i + #(live keys <= key), each by one binary search in
//      the other array; positions below cap are written.  Thread 0 writes
//      cnt + popcount.
// Output goes to fresh buffers: merging in place over the array being
// read would race.  An empty call still copies the live array.
//   Bound: bytes — the live keys and slots read and written once (16 B
//   per entry: 16.8 MB at cap = 2^20) plus 9 B per insert.
//
// K14e probes: SortedIndex.lookup_count / range_slots / range_between
// (deneva_tpu/storage/index.py:168,193,202), which DynamicSortedIndex
// reaches through its view with n = cap.  One thread per query: K14b's
// branchless lower bound (and an upper bound for the count), then the
// fixed-width window of slots (miss_slot past the end or past q_hi).
//   Bound: bytes — 4-8 B in per query, 4 B (count) or 5 B per window
//   lane out, and the window's keys and slots read.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t hash_home(int32_t k, uint32_t mask) {
  uint32_t x = static_cast<uint32_t>(k) * 2654435761u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x & mask;
}

__global__ void hash_lookup_kernel(const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ slots, int cap,
                                   int max_probe,
                                   const int32_t* __restrict__ q, long long m,
                                   int miss, int32_t* __restrict__ out) {
  const uint32_t cmask = static_cast<uint32_t>(cap) - 1u;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < m; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t x = q[t];
    uint32_t pos = hash_home(x, cmask);
    int32_t r = miss;
    for (int p = 0; p < max_probe; ++p) {
      const int32_t k = __ldg(&keys[pos]);
      if (k == x) {
        r = __ldg(&slots[pos]);
        break;
      }
      if (k == -1) break;
      pos = (pos + 1u) & cmask;
    }
    out[t] = r;
  }
}

__global__ void lookup_kernel(const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ slots, int n,
                              const int32_t* __restrict__ q, long long m,
                              int miss, int32_t* __restrict__ out) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < m; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t x = q[t];
    if (n == 0) {
      out[t] = miss;
      continue;
    }
    int base = 0, len = n;
    while (len > 1) {
      const int half = len >> 1;
      base = __ldg(&keys[base + half]) < x ? base + half : base;
      len -= half;
    }
    int lo = base + (__ldg(&keys[base]) < x ? 1 : 0);
    lo = min(lo, n - 1);
    out[t] = __ldg(&keys[lo]) == x ? __ldg(&slots[lo]) : miss;
  }
}

// lower bound: the first position whose key is >= x (n if none)
__device__ __forceinline__ int lower_pos(const int32_t* __restrict__ keys,
                                         int n, int32_t x) {
  if (n == 0) return 0;
  int base = 0, len = n;
  while (len > 1) {
    const int half = len >> 1;
    base = __ldg(&keys[base + half]) < x ? base + half : base;
    len -= half;
  }
  return base + (__ldg(&keys[base]) < x ? 1 : 0);
}

// upper bound: the first position whose key is > x (n if none)
__device__ __forceinline__ int upper_pos(const int32_t* __restrict__ keys,
                                         int n, int32_t x) {
  if (n == 0) return 0;
  int base = 0, len = n;
  while (len > 1) {
    const int half = len >> 1;
    base = __ldg(&keys[base + half]) <= x ? base + half : base;
    len -= half;
  }
  return base + (__ldg(&keys[base]) <= x ? 1 : 0);
}

constexpr int32_t kBig = 0x7fffffff;
constexpr int kRankThreads = 256;

__global__ void merge_rank_kernel(const int32_t* __restrict__ nk,
                                  const int32_t* __restrict__ ns,
                                  const uint8_t* __restrict__ mask, int m,
                                  int32_t* __restrict__ sk,
                                  int32_t* __restrict__ ss,
                                  int32_t* __restrict__ pop) {
  __shared__ int32_t tile[kRankThreads];
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  const bool live = i < m;
  const bool on = live && mask[i];
  const int32_t k = on ? nk[i] : kBig;
  int rank = 0;
  for (int t0 = 0; t0 < m; t0 += kRankThreads) {
    const int j = t0 + static_cast<int>(threadIdx.x);
    tile[threadIdx.x] = j < m ? (mask[j] ? nk[j] : kBig) : kBig;
    __syncthreads();
    const int lim = min(kRankThreads, m - t0);
    if (live) {
      for (int u = 0; u < lim; ++u) {
        const int32_t kj = tile[u];
        rank += (kj < k) || (kj == k && t0 + u < i);
      }
    }
    __syncthreads();
  }
  if (live) {
    sk[rank] = k;
    ss[rank] = ns[i];
  }
  const int cnt = __syncthreads_count(on);
  if (threadIdx.x == 0 && cnt) atomicAdd(pop, cnt);
}

__global__ void merge_place_kernel(const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ slots, int cap,
                                   const int32_t* __restrict__ sk,
                                   const int32_t* __restrict__ ss, int m,
                                   const int32_t* __restrict__ cnt_in,
                                   const int32_t* __restrict__ pop,
                                   int32_t* __restrict__ out_k,
                                   int32_t* __restrict__ out_s,
                                   int32_t* __restrict__ cnt_out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t == 0) *cnt_out = *cnt_in + *pop;
  if (t < cap) {
    const int p = static_cast<int>(t);
    const int32_t k = keys[p];
    const long long q = static_cast<long long>(p) + lower_pos(sk, m, k);
    if (q < cap) {
      out_k[q] = k;
      out_s[q] = slots[p];
    }
  } else if (t < static_cast<long long>(cap) + m) {
    const int i = static_cast<int>(t - cap);
    const int32_t k = sk[i];
    const long long q = static_cast<long long>(i) + upper_pos(keys, cap, k);
    if (q < cap) {
      out_k[q] = k;
      out_s[q] = ss[i];
    }
  }
}

__global__ void probe_kernel(const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ slots, int n,
                             const int32_t* __restrict__ q_lo,
                             const int32_t* __restrict__ q_hi, long long m,
                             int width, int mode, int miss,
                             int32_t* __restrict__ count,
                             int32_t* __restrict__ out_slots,
                             uint8_t* __restrict__ out_valid) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < m; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t x = q_lo[t];
    const int lo = lower_pos(keys, n, x);
    if (mode == 0) {
      count[t] = upper_pos(keys, n, x) - lo;
      continue;
    }
    const int32_t hi = mode == 2 ? q_hi[t] : 0;
    for (int w = 0; w < width; ++w) {
      const long long pos = static_cast<long long>(lo) + w;
      bool ok = pos < n;
      if (ok && mode == 2) ok = __ldg(&keys[pos]) <= hi;
      out_slots[t * width + w] = ok ? __ldg(&slots[pos]) : miss;
      out_valid[t * width + w] = ok;
    }
  }
}

}  // namespace

// K14a: m queries (any shape, contiguous) -> m slots; cap a power of two.
DT_EXPORT int dt_hash_lookup(const int32_t* keys, const int32_t* slots,
                             int cap, int max_probe, const int32_t* q,
                             long long m, int miss, int32_t* out,
                             void* stream) {
  if (cap <= 0 || (cap & (cap - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return dt_status();
  hash_lookup_kernel<<<dt_blocks(m, 256), 256, 0, dt_stream(stream)>>>(
      keys, slots, cap, max_probe, q, m, miss, out);
  return dt_status();
}

// K14b: m queries (any shape, contiguous) -> m slots.
DT_EXPORT int dt_sorted_lookup(const int32_t* keys, const int32_t* slots,
                               int n, const int32_t* q, long long m, int miss,
                               int32_t* out, void* stream) {
  lookup_kernel<<<dt_blocks(m, 256), 256, 0, dt_stream(stream)>>>(
      keys, slots, n, q, m, miss, out);
  return dt_status();
}

// K14e merge: the live (keys, slots) of capacity cap and cnt, with the m
// masked inserts, into (out_k, out_s, cnt_out); sk, ss (m each) and pop
// (one int) are scratch.  Outputs must not alias the inputs.
DT_EXPORT int dt_index_merge(const int32_t* keys, const int32_t* slots,
                             int cap, const int32_t* cnt, const int32_t* nk,
                             const int32_t* ns, const uint8_t* mask, int m,
                             int32_t* sk, int32_t* ss, int32_t* pop,
                             int32_t* out_k, int32_t* out_s, int32_t* cnt_out,
                             void* stream) {
  if (cap <= 0 || m < 0 || out_k == keys || out_s == slots)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = dt_stream(stream);
  cudaMemsetAsync(pop, 0, sizeof(int32_t), st);
  if (m > 0)
    merge_rank_kernel<<<dt_blocks(m, kRankThreads), kRankThreads, 0, st>>>(
        nk, ns, mask, m, sk, ss, pop);
  merge_place_kernel<<<dt_blocks(static_cast<long long>(cap) + m, 256), 256,
                       0, st>>>(keys, slots, cap, sk, ss, m, cnt, pop, out_k,
                                out_s, cnt_out);
  return dt_status();
}

// K14e probes: m queries (any shape, contiguous).  mode 0: count[m] of
// entries equal to q_lo; mode 1: the width entries from q_lo's lower bound
// into out_slots / out_valid [m, width]; mode 2: those with key <= q_hi.
DT_EXPORT int dt_sorted_probe(const int32_t* keys, const int32_t* slots,
                              int n, const int32_t* q_lo, const int32_t* q_hi,
                              long long m, int width, int mode, int miss,
                              int32_t* count, int32_t* out_slots,
                              uint8_t* out_valid, void* stream) {
  if (mode < 0 || mode > 2 || width < 0 || (mode == 2 && q_hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || (mode != 0 && width == 0)) return dt_status();
  probe_kernel<<<dt_blocks(m, 256), 256, 0, dt_stream(stream)>>>(
      keys, slots, n, q_lo, q_hi, m, width, mode, miss, count, out_slots,
      out_valid);
  return dt_status();
}
