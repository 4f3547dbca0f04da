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
