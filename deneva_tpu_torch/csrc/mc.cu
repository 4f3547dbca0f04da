// K18a + K18b: the sharded forwarding plan's capacity rule and owner
// blocks, once per shard on its slice of bD whole txns (A lanes each).
//
// K18a replaces deneva_tpu/ops/forward.py:109 mc_plan_defer as the
// shard-local pass of deneva_tpu/workloads/ycsb.py:400-412.  The
// reference stably sorts the slice's lanes by (owner = key % D, ts) and
// defers every txn with a lane at position >= pair_cap in its owner's
// run.  A txn's lanes are contiguous and share its ts, so that order is
// (owner, ts, txn, lane), and a lane of txn t with owner o sits at
//   prefix_o(t) + (its rank among t's owner-o lanes),
// where prefix_o(t) sums the owner-o lane counts c[t'][o] of the txns t'
// before t in (ts, txn) order.  So t defers iff prefix_o(t) + c[t][o] >
// pair_cap for an owner o it touches.  The kernel ranks the bD txns by
// (ts, txn) by counting (thread t of block (x, y) compares its ts with
// the 1,024 txns of span y, 256 at a time from shared memory, and adds
// its count to t's rank) and writes the order, then
// each txn's D owner counts as D rows in that order (one thread per
// txn), scans every row to its exclusive prefix (one block a row,
// radix.cuh's row scan) and tests each txn against its prefixes (one
// thread per txn).  It writes the defer flags and the order, which K18b
// reads.
//   Bound: bytes (keys, valid and ts read once; flags and order written
//   once).  The rank does bD^2 compares (67 M at bD = 8,192), where a
//   radix sort of bD words would take 18 launches of a few microseconds
//   each; at the slice sizes of the main path the compares are cheaper.
//
// K18b replaces deneva_tpu/workloads/ycsb.py:413-441 (drop the deferred
// txns' lanes, stable (owner, ts) sort, bincount, one fixed block per
// destination).  The same count rows and scans with the deferred txns'
// counts zeroed give every surviving lane its slot prefix_o(t) + rank in
// block o, where one thread per txn writes its lanes' (key, rank,
// write); removing deferred txns only moves survivors earlier, so every
// survivor fits.  A last grid fills each block past its owner's total
// with (INT32_MAX, 0, false).  (The
// reference's clamped dynamic_slice leaves other owners' lanes in those
// slots, which its receiver masks to the sentinel key.)
//   Bound: bytes (the slice's lanes read once, the D blocks written
//   once).
#include "common.cuh"
#include "radix.cuh"

namespace {

constexpr int kMaxParts = 8;
constexpr int kThreads = 256;
constexpr int kRowScanThreads = 1024;
constexpr int kRankSpan = 1024;            // txns one rank block compares
constexpr int32_t kBigKey = 0x7FFFFFFF;

__device__ __forceinline__ int owner_of(int32_t key, int d) {
  const int o = key % d;
  return o < 0 ? o + d : o;
}

// Txn t's valid lanes per owner, in registers (the unrolled select keeps
// the array out of local memory).
__device__ __forceinline__ void owner_counts(const int32_t* __restrict__ keys,
                                             const uint8_t* __restrict__ valid,
                                             int t, int a, int d,
                                             int (&c)[kMaxParts]) {
#pragma unroll
  for (int o = 0; o < kMaxParts; ++o) c[o] = 0;
  const size_t at = static_cast<size_t>(t) * a;
  for (int j = 0; j < a; ++j) {
    if (!valid[at + j]) continue;
    const int o = owner_of(keys[at + j], d);
#pragma unroll
    for (int q = 0; q < kMaxParts; ++q)
      if (q == o) ++c[q];
  }
}

// rank[t] += #{t' in this block's span of kRankSpan txns : (ts[t'], t') <
// (ts[t], t)}: thread t of block (x, y) counts span y, so the bD^2
// compares spread over bD / kThreads x bD / kRankSpan blocks.
__global__ void rank_kernel(const int32_t* __restrict__ ts, int bd,
                            int32_t* __restrict__ rank) {
  __shared__ int32_t tile[kThreads];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t me = t < bd ? ts[t] : 0;
  const int end = min(bd, (blockIdx.y + 1) * kRankSpan);
  int cnt = 0;
  for (int t0 = blockIdx.y * kRankSpan; t0 < end; t0 += kThreads) {
    const int j = t0 + threadIdx.x;
    tile[threadIdx.x] = j < end ? ts[j] : 0;
    __syncthreads();
    const int lim = min(kThreads, end - t0);
    for (int jj = 0; jj < lim; ++jj) {
      const int32_t tj = tile[jj];
      cnt += (tj < me) || (tj == me && t0 + jj < t);
    }
    __syncthreads();
  }
  if (t < bd && cnt) atomicAdd(&rank[t], cnt);
}

// order[rank[t]] = t: the stable order by ts.
__global__ void order_kernel(const int32_t* __restrict__ rank, int bd,
                             int32_t* __restrict__ order) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < bd) order[rank[t]] = t;
}

// One thread per position i of the (ts, txn) order: row o of `cnt`
// holds, at i, txn order[i]'s owner-o lane count, 0 for a txn that
// `dfr` (when given) defers.
__global__ void count_kernel(const int32_t* __restrict__ order,
                             const int32_t* __restrict__ keys,
                             const uint8_t* __restrict__ valid,
                             const uint8_t* __restrict__ dfr, int bd, int a,
                             int d, uint32_t* __restrict__ cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bd) return;
  const int t = order[i];
  int c[kMaxParts];
  owner_counts(keys, valid, t, a, d, c);
  const bool skip = dfr != nullptr && dfr[t];
#pragma unroll
  for (int o = 0; o < kMaxParts; ++o)
    if (o < d) cnt[static_cast<size_t>(o) * bd + i] = skip ? 0u : c[o];
}

// K18a: txn order[i] defers iff a lane count c overflows its prefix.
__global__ void defer_kernel(const int32_t* __restrict__ order,
                             const int32_t* __restrict__ keys,
                             const uint8_t* __restrict__ valid,
                             const uint32_t* __restrict__ excl, int bd,
                             int a, int d, int cap,
                             uint8_t* __restrict__ dfr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bd) return;
  const int t = order[i];
  int c[kMaxParts];
  owner_counts(keys, valid, t, a, d, c);
  bool over = false;
#pragma unroll
  for (int o = 0; o < kMaxParts; ++o)
    if (o < d && c[o] > 0)
      over |= static_cast<long long>(excl[static_cast<size_t>(o) * bd + i])
              + c[o] > cap;
  dfr[t] = over;
}

// K18b: each surviving lane of txn order[i] to its slot in its owner's
// block, in lane order after the txn's prefix.
__global__ void place_kernel(const int32_t* __restrict__ order,
                             const int32_t* __restrict__ keys,
                             const uint8_t* __restrict__ valid,
                             const int32_t* __restrict__ rank,
                             const uint8_t* __restrict__ w,
                             const uint8_t* __restrict__ dfr,
                             const uint32_t* __restrict__ excl, int bd,
                             int a, int d, int cap, int32_t* __restrict__ bk,
                             int32_t* __restrict__ br,
                             uint8_t* __restrict__ bw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bd) return;
  const int t = order[i];
  if (dfr[t]) return;
  int run[kMaxParts];
#pragma unroll
  for (int o = 0; o < kMaxParts; ++o)
    run[o] = o < d ? static_cast<int>(excl[static_cast<size_t>(o) * bd + i])
                   : 0;
  const size_t at = static_cast<size_t>(t) * a;
  const int32_t r = rank[t];
  for (int j = 0; j < a; ++j) {
    if (!valid[at + j]) continue;
    const int32_t k = keys[at + j];
    const int o = owner_of(k, d);
    int pos = 0;
#pragma unroll
    for (int q = 0; q < kMaxParts; ++q)
      if (q == o) pos = run[q]++;
    if (pos < cap) {  // always, for the defer flags K18a gave this slice
      const size_t s = static_cast<size_t>(o) * cap + pos;
      bk[s] = k;
      br[s] = r;
      bw[s] = w[at + j];
    }
  }
}

// Every block slot past its owner's total: (INT32_MAX, 0, false).
__global__ void fill_kernel(const uint32_t* __restrict__ totals, int d,
                            int cap, int32_t* __restrict__ bk,
                            int32_t* __restrict__ br,
                            uint8_t* __restrict__ bw) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (s >= static_cast<long long>(d) * cap) return;
  const int o = static_cast<int>(s / cap);
  const long long p = s % cap;
  if (p < totals[o]) return;
  bk[s] = kBigKey;
  br[s] = 0;
  bw[s] = 0;
}

}  // namespace

// K18a.  cnt: d * bd + d uint32 of scratch; rank: bd int32 of scratch.
DT_EXPORT int dt_mc_defer(const int32_t* keys, const uint8_t* valid,
                          const int32_t* ts, int bd, int a, int d, int cap,
                          uint8_t* dfr, int32_t* order, uint32_t* cnt,
                          int32_t* rank, void* stream) {
  if (d < 2 || d > kMaxParts || bd < 1 || a < 1) return 1;
  cudaStream_t s = dt_stream(stream);
  const int nb = dt_blocks(bd, kThreads);
  cudaMemsetAsync(rank, 0, sizeof(int32_t) * bd, s);
  rank_kernel<<<dim3(nb, dt_blocks(bd, kRankSpan)), kThreads, 0, s>>>(
      ts, bd, rank);
  order_kernel<<<nb, kThreads, 0, s>>>(rank, bd, order);
  count_kernel<<<nb, kThreads, 0, s>>>(order, keys, valid, nullptr, bd, a, d,
                                       cnt);
  dt_radix::radix_rowscan_kernel<<<d, kRowScanThreads, 0, s>>>(
      cnt, bd, cnt + static_cast<size_t>(d) * bd, nullptr);
  defer_kernel<<<nb, kThreads, 0, s>>>(order, keys, valid, cnt, bd, a, d,
                                       cap, dfr);
  return dt_status();
}

// K18b.  bk, br, bw: [d, cap]; cnt: d * bd + d uint32 of scratch.
DT_EXPORT int dt_mc_pack(const int32_t* keys, const uint8_t* valid,
                         const int32_t* rank, const uint8_t* w,
                         const uint8_t* dfr, const int32_t* order, int bd,
                         int a, int d, int cap, int32_t* bk, int32_t* br,
                         uint8_t* bw, uint32_t* cnt, void* stream) {
  if (d < 2 || d > kMaxParts || bd < 1 || a < 1 || cap < 1) return 1;
  cudaStream_t s = dt_stream(stream);
  const int nb = dt_blocks(bd, kThreads);
  uint32_t* totals = cnt + static_cast<size_t>(d) * bd;
  count_kernel<<<nb, kThreads, 0, s>>>(order, keys, valid, dfr, bd, a, d,
                                       cnt);
  dt_radix::radix_rowscan_kernel<<<d, kRowScanThreads, 0, s>>>(
      cnt, bd, totals, nullptr);
  place_kernel<<<nb, kThreads, 0, s>>>(order, keys, valid, rank, w, dfr, cnt,
                                       bd, a, d, cap, bk, br, bw);
  const long long n = static_cast<long long>(d) * cap;
  fill_kernel<<<dt_blocks(n, kThreads), kThreads, 0, s>>>(totals, d, cap, bk,
                                                           br, bw);
  return dt_status();
}
