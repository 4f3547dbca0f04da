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

// K14b: m queries (any shape, contiguous) -> m slots.
DT_EXPORT int dt_sorted_lookup(const int32_t* keys, const int32_t* slots,
                               int n, const int32_t* q, long long m, int miss,
                               int32_t* out, void* stream) {
  lookup_kernel<<<dt_blocks(m, 256), 256, 0, dt_stream(stream)>>>(
      keys, slots, n, q, m, miss, out);
  return dt_status();
}
