// K13b + K15c + K17: the metrics plane's conflict density and the
// isolation audit plane's single-node half.
//
// K13b replaces deneva_tpu/cc/base.py:228 conflict_density: per valid,
// active lane its family-0 conflict bucket; per bucket the writes and the
// touches (all valid lanes, or under the reference's incidence arm only
// the lanes that read or write); a lane contends when  w_oth > 0 | (w &
// u_oth > 0)  with its own row's lanes on the bucket taken out, and counts
// into its owner's slot of int32[P].  The incidence's column sums and the
// scatter arm give these same integers.
//   One cooperative launch of at most the occupancy grid (512-thread
// blocks, asked once per device), no memset and no N-sized scratch.  A
// warp task holds whole rows: 32 / A rows of A <= 32 lanes on a warp's
// lanes (a longer row, a warp walking it 32 lanes at a time).  A
// lane's fields load together; its own row's same-bucket writes and lanes
// come from a walk of the row's A buckets by shuffles.  Three phases, two
// grid barriers (the clears before every add, the adds before every
// read, in any block; nothing else needs ordering):
//   count: the grid zeroes out[] and each block its P counts.  Dense
//     regime (k <= 8,192 and a block's lanes at least k / 8 and below
//     2^16): the grid zeroes the k words of the caller's uint64
//     histogram and each lane adds (write << 16 | touch) into its block's
//     shared table.  Direct regime (the rest: the router's 2^18 buckets,
//     ycsb_skew's 2,048 txns): a __match_any_sync on the bucket makes the
//     warp-groups, and each group's lowest lane zeroes its bucket's word;
//   add: dense, the block adds each nonzero entry (writes << 32 |
//     touches) with one 64-bit atomic; direct, one a warp-group;
//   verdict: each valid lane reads its bucket's word once, applies the
//     rule less its own row's counts and folds its owner into the block's
//     counts (a ballot at P = 1, a match on the owner above); the block
//     adds each nonzero count to out[].
// A thread keeps its first 4 tasks' lanes in registers from the first
// phase to the last (every task of the main path's); a later task is
// read again.  Bucket j's word sits at j << 3 where k <= 8,192 (the
// scratch dt_conflict_density_layout asks for is 8 k words there), so a
// 64 KB histogram's adds spread over the L2.  The slice-8 kernel took four stream operations (two
// memsets, two launches) and ~600,000 warp-group atomics on its two
// histograms at the forwarding batch: [K13b-split] put 0.0395 of its
// 0.0520 ms in that pass, the row walk through its N-sized scratch at
// 0.0088 (PERF.md).
//   Bound: bytes.  Each lane's table id, key and owner (4 B each) and its
//   valid / read / write flags (1 B each) read once, the txn flags, P
//   counts out: 9.9 MB at the forwarding batch of 65,536 x 10.
//
// K15c-scan replaces the audit's use of deneva_tpu/cc/depgraph.py:63
// segment_bounds, :70 prev_writer, :81 next_writer and :97 pack_edge
// (cc/base.py:469-492, 507).  On the sorted doubled lanes, the nearest
// PRECEDING live writer of lane i inside its key segment is the largest
// writer lane index below i (a max-scan of "lane i-1 writes ? i-1 : -1"
// against a max-scan of segment heads), and the nearest FOLLOWING one is
// the same scan over the reversed lanes (q = n-1-i; segment tails become
// heads).  Both scans run across 1024-lane tiles with a carry pass, as
// K15b.  A last pass writes per lane the flags and packed edges (wr or ww
// from the preceding writer, rw to the following one), the lane's audit
// bucket and the epoch-start observation mask.
//   Bound: bytes (read the sorted lanes once; write 2n flags and edges,
//   n buckets and observations).
//
// K15c-compact replaces :115 compact_lanes (stable: flagged lanes keep
// their lane order) with :155 witness_count fused: tile counts of the 2n
// flags, one block's exclusive scan of them (cnt, dropped), then each tile
// ranks its flags by a block scan and writes the lanes below `cap`,
// counting kept edges whose both ends sit at level 0.
//   Bound: bytes (2n flags and edges, n buckets in; cap edges and buckets
//   out).
//
// K17 replaces cc/base.py:414 _audit_observe_impl around K15a's sort and
// K15c, in two entry points.  dt_audit_lanes: the dense serialization rank
// opos of `order` over the committed txns (stable index tiebreak; also
// alone as dt_audit_rank, :434-437's argsort and scatter of arange), then
// one thread per access writes its read and write lane (key, banded
// position, txn id); dead lanes take position 0, which no output reads,
// so K15a's packing bound holds for the live lanes alone.
//   The rank is a counting rank over the whole grid.  Each block owns
// kRankRows rows, holds their keys in registers, and its threads stride
// over all B keys with 16-byte loads; a key before the block's rows
// counts where it is <= a row's key, one after them where it is <, one
// inside them by the full rule, so a pair costs a compare and an add.
// Each row's count is reduced by warp shuffles and one shared-memory sum
// and written once: no atomics, no memset, and B / 16 blocks (128 at B =
// 2,048, one wave of the 132 SMs).  The function is bound by its bytes
// (9 B a txn); the count's B^2 compares keep it far above that bound as
// B grows.  A radix sort of the keys would do four passes over B words,
// but on the H100 it was the faster only from about 13,700 txns, and the
// audit takes at most 16,384, where the count still beats a stable
// argsort (PERF.md); so the count is the one route.
//   dt_audit_observe: one pass over the sorted lanes digests the
// epoch-start reads against the PRE-update stamps (rdig; under MVCC the
// ring entry version_select picks by the reader's ts, the first of equal
// maxima) and scatter-maxes the writers' positions + 1 per audit bucket;
// a second pass scatter-maxes the ids of the writers at that position; a
// pass over the buckets writes the new stamps in place, digests them
// (vdig) and pushes the MVCC rings.  The uint32 sums wrap as uint32_t;
// they are sums, so their order is free.
//   Bound: bytes (the rank's keys and ranks, the lanes, the stamp tables
//   read and written once).
//
// Every audit entry point takes an optional device flag `due` (the cadence
// gate): when it is 0 the passes return at once; the compaction writes
// the reference's skip outputs (edges -1, zeros) and the stamp pass
// leaves the stamps and zeroes the digests.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "hashing.cuh"

namespace {

constexpr uint32_t kLanePad = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kTile = 1024;          // lanes per scan / compaction block
constexpr int kRankRows = 16;        // rows a counting-rank block owns
constexpr int kRankThreads = 256;
constexpr uint32_t kM1 = 0x9E3779B9u, kM2 = 0x85EBCA6Bu, kM3 = 0xC2B2AE35u,
                   kM4 = 0x27D4EB2Fu;

struct MaxOp {
  __device__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};
struct SumOp {
  __device__ int32_t operator()(int32_t a, int32_t b) const { return a + b; }
};
struct USumOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

__device__ __forceinline__ bool gated_off(const uint8_t* due) {
  return due != nullptr && !*due;
}

// -- K13b -------------------------------------------------------------------

constexpr int kDensThreads = 512;
constexpr int kDensSlots = 4;            // warp tasks a thread keeps
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kNoBucket = 0x80000000u;   // no bucket (k <= 2^30)

// One lane as the count phase leaves it: its bucket, its owner, and
// v | w << 1 | lead << 2 | own_w << 3 | own_u << 9 | sw << 15 | su << 21
// | u << 27 (own_*: the row's valid lanes on its bucket, writes and all;
// sw, su: the warp-group's writes and touches, kept by its lowest lane,
// lead; u: the lane touches).
struct DensLane {
  uint32_t bk;
  int32_t owner;
  uint32_t bits;
};

struct DensArgs {
  const int32_t* table_ids;
  const int32_t* keys;
  const uint8_t* valid;
  const uint8_t* is_read;
  const uint8_t* is_write;
  const uint8_t* active;
  const int32_t* owner;
  int b, a, p, inc_arm, rpw;     // rpw: rows a warp holds (a <= 32)
  int k, shift;                  // bucket j's word: hist[j << shift]
  uint32_t kmask;
  unsigned long long* hist;      // writes << 32 | touches
  int32_t* out;
};

struct DensRead {
  bool v, w, u;
  uint32_t bk;
  int32_t owner;
};

// A lane's fields, loaded together (one round trip, not a chain of
// dependent loads behind the row's and the lane's flags).
__device__ __forceinline__ DensRead dens_read(const DensArgs& g, bool in,
                                              int row, int i) {
  DensRead d = {false, false, false, 0u, -1};
  if (in) {
    const uint8_t act = g.active[row], val = g.valid[i];
    const uint8_t wr = g.is_write[i], rd = g.is_read[i];
    const int32_t tid = g.table_ids[i], key = g.keys[i], own = g.owner[i];
    if (act && val) {
      d.v = true;
      d.bk = bucket_of(tid, key, 0, g.kmask);
      d.w = wr != 0;
      d.u = !g.inc_arm || d.w || rd != 0;
      d.owner = own;
    }
  }
  return d;
}

// Rows of at most 32 lanes: warp task q holds rows [q rpw, q rpw + rpw),
// row r of the task on lanes [r a, r a + a).  Every lane of the warp
// calls it: a lane's own counts walk its row's a buckets by shuffles;
// in the direct regime a match on the bucket makes the warp-groups (the
// invalid lanes one group of a bucket no valid lane has).
template <bool kDense>
__device__ __forceinline__ DensLane dens_narrow(const DensArgs& g, int q,
                                                int r, int pos) {
  const int lane = threadIdx.x & 31;
  const int row = q * g.rpw + r;
  const DensRead d = dens_read(g, r < g.rpw && row < g.b, row,
                               row * g.a + pos);
  const uint32_t key = d.v ? d.bk : kNoBucket;
  const uint32_t wb = __ballot_sync(kFull, d.w);
  uint32_t own_w = 0u, own_u = 0u;
  const int first = r * g.a;
  for (int s = 0; s < g.a; ++s) {
    const bool eq = __shfl_sync(kFull, key, first + s) == key && d.v;
    own_u += eq;
    own_w += eq && ((wb >> ((first + s) & 31)) & 1u);
  }
  const uint32_t peers = kDense ? 0u : __match_any_sync(kFull, key);
  const uint32_t ub = kDense ? 0u : __ballot_sync(kFull, d.u);
  const bool lead = !kDense && d.v && lane == __ffs(peers) - 1;
  DensLane o;
  o.bk = d.bk;
  o.owner = d.owner;
  o.bits = static_cast<uint32_t>(d.v) | static_cast<uint32_t>(d.w) << 1 |
           static_cast<uint32_t>(lead) << 2 | own_w << 3 | own_u << 9 |
           __popc(peers & wb) << 15 | __popc(peers & ub) << 21 |
           static_cast<uint32_t>(d.u) << 27;
  return o;
}

// A lane's first phase.  Dense: its write and touch into the block's
// shared table (k words of writes << 16 | touches), a shared atomic a
// lane that writes or touches; direct: its warp-group's lowest lane
// zeroes the bucket's word.
template <bool kDense>
__device__ __forceinline__ void dens_first(const DensArgs& g,
                                           const DensLane& l,
                                           uint32_t* tab) {
  if (kDense) {
    const uint32_t w = (l.bits >> 1) & 1u, u = (l.bits >> 27) & 1u;
    if (w | u) atomicAdd(&tab[l.bk], w << 16 | u);
  } else if (l.bits & 4u) {
    g.hist[l.bk << g.shift] = 0ull;
  }
}

__device__ __forceinline__ void dens_add(const DensArgs& g,
                                         const DensLane& l) {
  const unsigned long long sw = (l.bits >> 15) & 63u, su = (l.bits >> 21) & 63u;
  if ((l.bits & 4u) && (sw | su))
    atomicAdd(&g.hist[l.bk << g.shift], sw << 32 | su);
}

// The contention rule on a lane's bucket totals less its own row's, then
// the lane's owner (-1: it does not count).
__device__ __forceinline__ int32_t dens_verdict(const DensArgs& g, bool v,
                                                bool w, uint32_t bk,
                                                int own_w, int own_u,
                                                int32_t owner) {
  if (!v) return -1;
  const unsigned long long h = __ldcg(&g.hist[bk << g.shift]);
  const int w_oth = static_cast<int>(h >> 32) - own_w;
  const int u_oth = static_cast<int>(h & 0xFFFFFFFFull) - own_u;
  const bool conf = w_oth > 0 || (w && u_oth > 0);
  return conf && owner >= 0 && owner < g.p ? owner : -1;
}

// One lane's owner into the block's counts: a shared atomic a warp-group
// (at P = 1 the warp's lane 0 adds its ballot's count).
__device__ __forceinline__ void dens_fold(const DensArgs& g, int32_t o,
                                          int32_t* cnt) {
  if (g.p == 1) {
    const uint32_t n = __popc(__ballot_sync(kFull, o == 0));
    if ((threadIdx.x & 31) == 0 && n) atomicAdd(&cnt[0], n);
    return;
  }
  const uint32_t peers = __match_any_sync(kFull, o);
  if (o >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&cnt[o], __popc(peers));
}

__device__ __forceinline__ int32_t dens_narrow_verdict(const DensArgs& g,
                                                       const DensLane& l) {
  return dens_verdict(g, l.bits & 1u, (l.bits >> 1) & 1u, l.bk,
                      (l.bits >> 3) & 63u, (l.bits >> 9) & 63u, l.owner);
}

// Rows of more than 32 lanes: a warp holds one row and walks it 32 lanes
// at a time; the histogram phases see a chunk's lanes, the verdict walks
// the whole row again for a lane's own counts (by shuffles, no scratch).
template <bool kDense>
__device__ __forceinline__ DensLane dens_wide(const DensArgs& g, int row,
                                              int c) {
  const int lane = threadIdx.x & 31;
  const int s = c * 32 + lane;
  const DensRead d = dens_read(g, s < g.a, row, row * g.a + s);
  const uint32_t peers =
      kDense ? 0u : __match_any_sync(kFull, d.v ? d.bk : kNoBucket);
  const uint32_t wb = kDense ? 0u : __ballot_sync(kFull, d.w);
  const uint32_t ub = kDense ? 0u : __ballot_sync(kFull, d.u);
  DensLane o;
  o.bk = d.bk;
  o.owner = d.owner;
  o.bits = static_cast<uint32_t>(d.v) | static_cast<uint32_t>(d.w) << 1 |
           static_cast<uint32_t>(d.v && lane == __ffs(peers) - 1) << 2 |
           __popc(peers & wb) << 15 | __popc(peers & ub) << 21 |
           static_cast<uint32_t>(d.u) << 27;
  return o;
}

__device__ __forceinline__ int32_t dens_wide_verdict(const DensArgs& g,
                                                     int row, int c) {
  const int lane = threadIdx.x & 31;
  const int s = c * 32 + lane;
  const DensRead d = dens_read(g, s < g.a, row, row * g.a + s);
  int own_w = 0, own_u = 0;
  for (int c2 = 0; c2 * 32 < g.a; ++c2) {
    const int s2 = c2 * 32 + lane;
    const DensRead e = dens_read(g, s2 < g.a, row, row * g.a + s2);
    const uint32_t key = e.v ? e.bk : kNoBucket;
    const uint32_t wb = __ballot_sync(kFull, e.w);
    for (int j = 0; j < 32; ++j) {
      const bool eq = __shfl_sync(kFull, key, j) == d.bk;
      own_u += eq;
      own_w += eq && ((wb >> j) & 1u);
    }
  }
  return dens_verdict(g, d.v, d.w, d.bk, own_w, own_u, d.owner);
}

// K13b's launch (the file's header gives its phases and regimes): warp
// gw takes the tasks gw, gw + nw, ...; a thread keeps its first
// kDensSlots tasks' lanes in registers across the barriers and reads a
// later task again in each phase.
template <bool kWide, bool kDense>
__global__ void __launch_bounds__(kDensThreads)
density_kernel(DensArgs g) {
  __shared__ int32_t cnt[1024];
  extern __shared__ uint32_t tab[];   // dense: k words
  auto grid = cooperative_groups::this_grid();
  const int lane = threadIdx.x & 31;
  const int gid = blockIdx.x * kDensThreads + threadIdx.x;
  const int gw = gid >> 5;
  const int nw = gridDim.x * (kDensThreads / 32);
  for (int j = threadIdx.x; j < g.p; j += kDensThreads) cnt[j] = 0;
  for (int j = gid; j < g.p; j += gridDim.x * kDensThreads) g.out[j] = 0;
  if (kDense) {
    // the grid zeroes every bucket's word (k <= 8,192), each block its
    // table
    for (int j = gid; j < g.k; j += gridDim.x * kDensThreads)
      g.hist[j << g.shift] = 0ull;
    for (int j = threadIdx.x; j < g.k; j += kDensThreads) tab[j] = 0u;
    __syncthreads();
  }
  const int r = !kWide && g.a > 0 ? lane / g.a : 0;   // once a thread
  const int pos = lane - r * g.a;
  const int tasks = kWide ? g.b : (g.b + g.rpw - 1) / g.rpw;
  DensLane keep[kDensSlots];
  if (kWide) {
    for (int row = gw; row < g.b; row += nw)
      for (int c = 0; c * 32 < g.a; ++c)
        dens_first<kDense>(g, dens_wide<kDense>(g, row, c), tab);
  } else {
#pragma unroll
    for (int j = 0; j < kDensSlots; ++j) {
      const int q = gw + j * nw;
      keep[j] = q < tasks ? dens_narrow<kDense>(g, q, r, pos)
                          : DensLane{0u, -1, 0u};
      dens_first<kDense>(g, keep[j], tab);
    }
    for (int q = gw + kDensSlots * nw; q < tasks; q += nw)
      dens_first<kDense>(g, dens_narrow<kDense>(g, q, r, pos), tab);
  }
  grid.sync();
  if (kDense) {
    for (int j = threadIdx.x; j < g.k; j += kDensThreads) {
      const uint32_t t = tab[j];
      if (t != 0u)
        atomicAdd(&g.hist[j << g.shift],
                  static_cast<unsigned long long>(t >> 16) << 32 |
                      (t & 0xFFFFu));
    }
  } else if (kWide) {
    for (int row = gw; row < g.b; row += nw)
      for (int c = 0; c * 32 < g.a; ++c)
        dens_add(g, dens_wide<kDense>(g, row, c));
  } else {
#pragma unroll
    for (int j = 0; j < kDensSlots; ++j) dens_add(g, keep[j]);
    for (int q = gw + kDensSlots * nw; q < tasks; q += nw)
      dens_add(g, dens_narrow<kDense>(g, q, r, pos));
  }
  grid.sync();
  if (kWide) {
    for (int row = gw; row < g.b; row += nw)
      for (int c = 0; c * 32 < g.a; ++c)
        dens_fold(g, dens_wide_verdict(g, row, c), cnt);
  } else {
#pragma unroll
    for (int j = 0; j < kDensSlots; ++j)
      dens_fold(g, dens_narrow_verdict(g, keep[j]), cnt);
    for (int q = gw + kDensSlots * nw; q < tasks; q += nw)
      dens_fold(g, dens_narrow_verdict(g, dens_narrow<kDense>(g, q, r, pos)),
                cnt);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < g.p; j += kDensThreads)
    if (cnt[j]) atomicAdd(&g.out[j], cnt[j]);
}

// -- K17, lanes -----------------------------------------------------------------

// opos[i] = #{j : key_j < key_i, or key_j == key_i and j < i}, key = order
// for committed txns and INT32_MAX for the others.
__device__ __forceinline__ int32_t order_key(const uint8_t* committed,
                                             const int32_t* order, int j) {
  return committed[j] ? order[j] : INT32_MAX;
}

// Block x owns rows [16x, 16x + 16).  VEC: `order` is 16-byte and
// `committed` 4-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(kRankThreads)
rank_count_kernel(const uint8_t* __restrict__ committed,
                  const int32_t* __restrict__ order, int b,
                  const uint8_t* __restrict__ due,
                  int32_t* __restrict__ opos) {
  __shared__ int32_t part[kRankThreads / 32][kRankRows];
  if (gated_off(due)) return;
  const int i0 = blockIdx.x * kRankRows;
  int32_t ki[kRankRows], cnt[kRankRows];
#pragma unroll
  for (int r = 0; r < kRankRows; ++r) {
    ki[r] = i0 + r < b ? order_key(committed, order, i0 + r) : INT32_MAX;
    cnt[r] = 0;
  }
  // groups of 4 keys; i0 is a multiple of 4, so a group lies wholly
  // before, inside or after the block's rows
  const int nq = VEC ? b / 4 : 0;
  for (int q = threadIdx.x; q < nq; q += kRankThreads) {
    const int4 o = reinterpret_cast<const int4*>(order)[q];
    const uchar4 c = reinterpret_cast<const uchar4*>(committed)[q];
    const int32_t k[4] = {c.x ? o.x : INT32_MAX, c.y ? o.y : INT32_MAX,
                          c.z ? o.z : INT32_MAX, c.w ? o.w : INT32_MAX};
    const int j0 = 4 * q;
    if (j0 < i0) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < kRankRows; ++r) cnt[r] += k[u] <= ki[r];
    } else if (j0 >= i0 + kRankRows) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < kRankRows; ++r) cnt[r] += k[u] < ki[r];
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < kRankRows; ++r)
          cnt[r] += k[u] < ki[r] || (k[u] == ki[r] && j0 + u < i0 + r);
    }
  }
  for (int j = 4 * nq + threadIdx.x; j < b; j += kRankThreads) {
    const int32_t kj = order_key(committed, order, j);
#pragma unroll
    for (int r = 0; r < kRankRows; ++r)
      cnt[r] += kj < ki[r] || (kj == ki[r] && j < i0 + r);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRankRows; ++r) {
    const int32_t v = dt_warp_reduce(cnt[r], SumOp());
    if (lane == 0) part[warp][r] = v;
  }
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (threadIdx.x < kRankRows && i < b) {
    int32_t s = 0;
#pragma unroll
    for (int w = 0; w < kRankThreads / 32; ++w) s += part[w][threadIdx.x];
    opos[i] = s;
  }
}

__global__ void audit_lanes_kernel(
    const uint8_t* __restrict__ committed, const int32_t* __restrict__ lvl,
    const int32_t* __restrict__ table_ids, const int32_t* __restrict__ keys,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ is_read,
    const uint8_t* __restrict__ is_write,
    const uint8_t* __restrict__ order_free, int b, int a, int order_vis,
    const uint8_t* __restrict__ due, const int32_t* __restrict__ opos,
    int64_t* __restrict__ keys2, int32_t* __restrict__ pos2,
    int32_t* __restrict__ tid2) {
  if (gated_off(due)) return;
  const int n = b * a;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = i / a;
  const bool cm = committed[row] && valid[i] &&
                  !(order_free != nullptr && order_free[i]);
  const bool rm = cm && is_read[i];
  const bool wm = cm && is_write[i];
  const int64_t ident = combine_ident(table_ids[i], keys[i]);
  const int32_t band = lvl[row] * (b + 2);
  const int32_t base = band + 1 + opos[row];
  keys2[i] = rm ? ident : static_cast<int64_t>(kLanePad);
  pos2[i] = rm ? (order_vis ? base * 2 : band * 2) : 0;
  tid2[i] = row;
  keys2[n + i] = wm ? ident : static_cast<int64_t>(kLanePad);
  pos2[n + i] = wm ? base * 2 + 1 : 0;
  tid2[n + i] = row;
}

// -- K15c-scan --------------------------------------------------------------------

__device__ __forceinline__ bool live_writer(const int64_t* sk,
                                            const int32_t* sp, int x) {
  return sk[x] != static_cast<int64_t>(kLanePad) && (sp[x] & 1);
}

// The four scan inputs of tile position x: forward over lane i = x (the
// previous lane's index if it is a live writer; i at a segment head),
// reverse over q = x, lane j = n-1-q (q-1 if lane j+1 is a live writer; q
// at a segment tail).
__device__ __forceinline__ void scan_inputs(const int64_t* sk,
                                            const int32_t* sp, int x, int n,
                                            int32_t v[4]) {
  v[0] = v[1] = v[2] = v[3] = -1;
  if (x >= n) return;
  const int i = x;
  if (i > 0 && live_writer(sk, sp, i - 1)) v[0] = i - 1;
  if (i == 0 || sk[i] != sk[i - 1]) v[1] = i;
  const int j = n - 1 - x;
  if (x > 0 && live_writer(sk, sp, j + 1)) v[2] = x - 1;
  if (j == n - 1 || sk[j] != sk[j + 1]) v[3] = x;
}

__global__ void scan_agg_kernel(const int64_t* __restrict__ sk,
                                const int32_t* __restrict__ sp, int n,
                                const uint8_t* __restrict__ due,
                                int32_t* __restrict__ agg) {
  if (gated_off(due)) return;
  int32_t v[4];
  scan_inputs(sk, sp, blockIdx.x * blockDim.x + threadIdx.x, n, v);
  for (int c = 0; c < 4; ++c) {
    const int32_t m = dt_block_reduce(v[c], MaxOp(), -1);
    if (threadIdx.x == 0) agg[4 * blockIdx.x + c] = m;
  }
}

// One block: carry[4 * t + c] = max of agg[c] over tiles < t (-1 at t = 0).
__global__ void scan_carry_kernel(const int32_t* __restrict__ agg, int nb,
                                  const uint8_t* __restrict__ due,
                                  int32_t* __restrict__ carry) {
  __shared__ int32_t part[4][kTile];
  if (gated_off(due)) return;
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * per, nb);
  const int end = min(beg + per, nb);
  int32_t m[4] = {-1, -1, -1, -1};
  for (int t = beg; t < end; ++t)
    for (int c = 0; c < 4; ++c) m[c] = max(m[c], agg[4 * t + c]);
  for (int c = 0; c < 4; ++c) part[c][threadIdx.x] = m[c];
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    int32_t o[4];
    for (int c = 0; c < 4; ++c)
      o[c] = threadIdx.x >= off ? part[c][threadIdx.x - off] : -1;
    __syncthreads();
    for (int c = 0; c < 4; ++c)
      part[c][threadIdx.x] = max(part[c][threadIdx.x], o[c]);
    __syncthreads();
  }
  int32_t run[4];
  for (int c = 0; c < 4; ++c)
    run[c] = threadIdx.x ? part[c][threadIdx.x - 1] : -1;
  for (int t = beg; t < end; ++t)
    for (int c = 0; c < 4; ++c) {
      carry[4 * t + c] = run[c];
      run[c] = max(run[c], agg[4 * t + c]);
    }
}

__global__ void scan_tile_kernel(const int64_t* __restrict__ sk,
                                 const int32_t* __restrict__ sp,
                                 const int32_t* __restrict__ sid, int n,
                                 const uint8_t* __restrict__ due,
                                 const int32_t* __restrict__ carry,
                                 int32_t* __restrict__ prev,
                                 int32_t* __restrict__ nxt) {
  if (gated_off(due)) return;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t v[4], unused;
  scan_inputs(sk, sp, x, n, v);
  const int32_t* c = carry + 4 * blockIdx.x;
  for (int k = 0; k < 4; ++k)
    v[k] = max(dt_block_incl_scan(v[k], MaxOp(), -1, unused), c[k]);
  if (x < n) {
    prev[x] = v[0] >= v[1] && v[0] >= 0 ? sid[v[0]] : -1;
    nxt[n - 1 - x] = v[2] >= v[3] && v[2] >= 0 ? sid[n - 1 - v[2]] : -1;
  }
}

__global__ void scan_lanes_kernel(const int64_t* __restrict__ sk,
                                  const int32_t* __restrict__ sp,
                                  const int32_t* __restrict__ sid, int n,
                                  uint32_t bmask,
                                  const uint8_t* __restrict__ due,
                                  const int32_t* __restrict__ prev,
                                  const int32_t* __restrict__ nxt,
                                  uint8_t* __restrict__ flags,
                                  int32_t* __restrict__ edges,
                                  int32_t* __restrict__ sbk,
                                  uint8_t* __restrict__ obs) {
  if (gated_off(due)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool live = sk[i] != static_cast<int64_t>(kLanePad);
  const bool sw = sp[i] & 1;
  const int32_t me = sid[i], p = prev[i], x = nxt[i];
  const bool f_prev = live && p >= 0 && p != me;
  const bool f_next = live && !sw && x >= 0 && x != me;
  flags[i] = f_prev;
  flags[n + i] = f_next;
  // kinds: ww 0, wr 1, rw 2
  edges[i] = f_prev ? ((sw ? 0 : 1) << 28 | p << 14 | me) : -1;
  edges[n + i] = f_next ? (2 << 28 | me << 14 | x) : -1;
  sbk[i] = static_cast<int32_t>(
      bucket_of_ident(static_cast<uint32_t>(sk[i]), 0, bmask));
  obs[i] = live && !sw && p < 0;
}

// -- K15c-compact -----------------------------------------------------------------

__global__ void compact_count_kernel(const uint8_t* __restrict__ flags,
                                     int m, const uint8_t* __restrict__ due,
                                     int32_t* __restrict__ tcnt) {
  if (gated_off(due)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t f = i < m ? flags[i] : 0;
  const int32_t c = dt_block_reduce(f, SumOp(), 0);
  if (threadIdx.x == 0) tcnt[blockIdx.x] = c;
}

// One block: the -1 fill of the export, the tiles' exclusive offsets, the
// counts; off the cadence the skip outputs.
__global__ void compact_scan_kernel(const int32_t* __restrict__ tcnt, int nt,
                                    int cap, const uint8_t* __restrict__ due,
                                    int32_t* __restrict__ toff,
                                    int32_t* __restrict__ edges,
                                    int32_t* __restrict__ ebkt,
                                    int32_t* __restrict__ cnt,
                                    int32_t* __restrict__ dropped,
                                    int32_t* __restrict__ wit) {
  for (int j = threadIdx.x; j < cap; j += blockDim.x) edges[j] = ebkt[j] = -1;
  if (gated_off(due)) {
    if (threadIdx.x == 0) *cnt = *dropped = *wit = 0;
    return;
  }
  const int per = (nt + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * per, nt);
  const int end = min(beg + per, nt);
  int32_t s = 0;
  for (int t = beg; t < end; ++t) s += tcnt[t];
  int32_t total;
  int32_t run = dt_block_incl_scan(s, SumOp(), 0, total) - s;
  for (int t = beg; t < end; ++t) {
    toff[t] = run;
    run += tcnt[t];
  }
  if (threadIdx.x == 0) {
    *cnt = total;
    *dropped = total > cap ? total - cap : 0;
    *wit = 0;
  }
}

__global__ void compact_place_kernel(const uint8_t* __restrict__ flags,
                                     const int32_t* __restrict__ edges2,
                                     const int32_t* __restrict__ sbk, int m,
                                     int cap, const int32_t* __restrict__ lvl,
                                     int b, const uint8_t* __restrict__ due,
                                     const int32_t* __restrict__ toff,
                                     int32_t* __restrict__ edges,
                                     int32_t* __restrict__ ebkt,
                                     int32_t* __restrict__ wit) {
  if (gated_off(due)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t f = i < m ? flags[i] : 0;
  int32_t unused;
  const int32_t slot =
      toff[blockIdx.x] + dt_block_incl_scan(f, SumOp(), 0, unused) - 1;
  int32_t z = 0;
  if (f && slot < cap) {
    const int32_t e = edges2[i];
    const int half = m / 2;
    edges[slot] = e;
    ebkt[slot] = sbk[i < half ? i : i - half];
    const int32_t src = min(max((e >> 14) & 0x3FFF, 0), b - 1);
    const int32_t dst = min(max(e & 0x3FFF, 0), b - 1);
    z = e >= 0 && lvl[src] == 0 && lvl[dst] == 0;
  }
  const int32_t c = dt_block_reduce(z, SumOp(), 0);
  if (threadIdx.x == 0 && c) atomicAdd(wit, c);
}

// -- K17, stamps --------------------------------------------------------------------

__global__ void observe_lanes_kernel(
    const int64_t* __restrict__ sk, const int32_t* __restrict__ sp,
    const int32_t* __restrict__ sid, const int32_t* __restrict__ sbk,
    const uint8_t* __restrict__ obs, int n, const int32_t* __restrict__ ts,
    const int32_t* __restrict__ st_epoch,
    const int32_t* __restrict__ st_writer, const int32_t* __restrict__ vts,
    const int32_t* __restrict__ vepoch, const int32_t* __restrict__ vwriter,
    int h, const uint8_t* __restrict__ due, int32_t* __restrict__ top,
    uint32_t* __restrict__ dig) {
  if (gated_off(due)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t mix = 0;
  if (i < n) {
    const int32_t bk = sbk[i];
    if (obs[i]) {
      const int32_t s = sid[i];
      int32_t oe, ow;
      if (vts != nullptr) {
        // version_select: the newest retained boundary <= the reader's ts
        const int32_t rts = ts[s];
        int32_t best = -1, sel = -1;
        for (int j = 0; j < h; ++j) {
          const int32_t v = vts[static_cast<size_t>(bk) * h + j];
          if (v >= 0 && v <= rts && v > best) {
            best = v;
            sel = j;
          }
        }
        oe = sel >= 0 ? vepoch[static_cast<size_t>(bk) * h + sel] : -1;
        ow = sel >= 0 ? vwriter[static_cast<size_t>(bk) * h + sel] : -1;
      } else {
        oe = st_epoch[bk];
        ow = st_writer[bk];
      }
      mix = (static_cast<uint32_t>(s) * kM1) ^
            (static_cast<uint32_t>(bk) * kM2) ^
            (static_cast<uint32_t>(oe) * kM3) ^
            (static_cast<uint32_t>(ow) * kM4);
    }
    if (sk[i] != static_cast<int64_t>(kLanePad) && (sp[i] & 1))
      atomicMax(&top[bk], sp[i] + 1);
  }
  const uint32_t sum = dt_block_reduce(mix, USumOp(), 0u);
  if (threadIdx.x == 0 && sum) atomicAdd(&dig[1], sum);
}

__global__ void observe_wid_kernel(const int64_t* __restrict__ sk,
                                   const int32_t* __restrict__ sp,
                                   const int32_t* __restrict__ sid,
                                   const int32_t* __restrict__ sbk, int n,
                                   const uint8_t* __restrict__ due,
                                   const int32_t* __restrict__ top,
                                   int32_t* __restrict__ wid) {
  if (gated_off(due)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (sk[i] != static_cast<int64_t>(kLanePad) && (sp[i] & 1) &&
      sp[i] + 1 == top[sbk[i]])
    atomicMax(&wid[sbk[i]], sid[i] + 1);
}

__global__ void observe_buckets_kernel(
    const int32_t* __restrict__ top, const int32_t* __restrict__ wid, int k,
    const int32_t* __restrict__ ts, const int32_t* __restrict__ epoch,
    int32_t* __restrict__ st_epoch, int32_t* __restrict__ st_writer,
    int32_t* __restrict__ vts, int32_t* __restrict__ vepoch,
    int32_t* __restrict__ vwriter, int32_t* __restrict__ vpos, int h,
    const uint8_t* __restrict__ due, uint32_t* __restrict__ dig) {
  if (gated_off(due)) return;
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t d = 0;
  if (kk < k) {
    int32_t e = st_epoch[kk], w = st_writer[kk];
    if (top[kk] > 0) {
      e = *epoch;
      w = wid[kk] - 1;
      st_epoch[kk] = e;
      st_writer[kk] = w;
      if (vts != nullptr) {
        const int32_t slot = vpos[kk] % h;
        const size_t at = static_cast<size_t>(kk) * h + slot;
        vts[at] = ts[max(w, 0)];
        vepoch[at] = e;
        vwriter[at] = w;
        vpos[kk] += 1;
      }
    }
    d = (static_cast<uint32_t>(e) * kM1) ^ (static_cast<uint32_t>(w) * kM2);
  }
  const uint32_t sum = dt_block_reduce(d, USumOp(), 0u);
  if (threadIdx.x == 0 && sum) atomicAdd(&dig[0], sum);
}

// The dense regime's largest k: its shared table stays at 32 KB a block.
constexpr int kDenseMaxK = 8192;
// Bucket j's histogram word is hist[j << kDenseShift] where k <=
// kDenseMaxK, so a 64 KB histogram's adds spread over the L2's slices
// (packed, they would take few of them); the words are packed above.
constexpr int kDenseShift = 3;

template <bool kWide, bool kDense>
size_t density_smem(int k) {
  return kDense ? static_cast<size_t>(k) * sizeof(uint32_t) : 0;
}

// The occupancy grid of a K13b variant on the current device (blocks per
// SM x SMs, dense ones at their largest table), asked once per device; 0
// where a query fails.
template <bool kWide, bool kDense>
int density_grid() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, density_kernel<kWide, kDense>, kDensThreads,
          density_smem<kWide, kDense>(kDenseMaxK)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

struct DensLayout {
  bool dense;
  int rpw, grid, shift;
  long long tasks, words;   // warp tasks; uint64 words of scratch
};

// K13b's launch at b x a lanes and k buckets: the dense regime where a
// block's lanes are many against its table (at least k / 8: a block
// scans its table once) and fewer than 2^16 (its counts are 16 bits), the
// direct one otherwise.  False for sizes the kernel does not take, or
// where a query fails.
bool density_layout(int b, int a, int k, DensLayout& l) {
  if (k < 1 || (k & (k - 1)) != 0 || k > (1 << 30) || b < 0 || a < 0 ||
      static_cast<long long>(b) * a >= (1LL << 31))
    return false;
  const bool wide = a > 32;
  l.rpw = a >= 1 && a <= 32 ? 32 / a : 1;
  const long long rows = a == 0 ? 0 : b;
  l.tasks = wide ? rows : (rows + l.rpw - 1) / l.rpw;
  const long long per_block = kDensThreads / 32;
  const int fit = wide ? density_grid<true, true>()
                       : density_grid<false, true>();
  if (fit < 1) return false;
  const int grid = static_cast<int>(std::min<long long>(
      fit, std::max(1LL, (l.tasks + per_block - 1) / per_block)));
  const long long block_lanes = (l.tasks + grid * per_block - 1) /
                                (grid * per_block) * per_block *
                                (wide ? a : 32);
  l.dense = k <= kDenseMaxK && block_lanes < 65536 && 8 * block_lanes >= k;
  const int direct_fit = l.dense ? fit
                         : wide  ? density_grid<true, false>()
                                 : density_grid<false, false>();
  if (direct_fit < 1) return false;
  l.grid = std::min(grid, direct_fit);
  l.shift = k <= kDenseMaxK ? kDenseShift : 0;
  l.words = static_cast<long long>(k) << l.shift;
  return true;
}

template <bool kWide>
int launch_density(DensArgs g, const DensLayout& l, cudaStream_t s) {
  void* args[] = {&g};
  const void* kernel =
      l.dense ? reinterpret_cast<const void*>(density_kernel<kWide, true>)
              : reinterpret_cast<const void*>(density_kernel<kWide, false>);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(l.grid), dim3(kDensThreads), args,
      l.dense ? density_smem<kWide, true>(g.k) : 0, s);
  return e != cudaSuccess ? static_cast<int>(e) : dt_status();
}

}  // namespace

// K13b's layout at b x a lanes and k buckets: out[0] the uint64 words of
// scratch dt_conflict_density needs, out[1] 1 in the dense regime (0 in
// the direct one), out[2] the blocks of its grid.  Launches nothing.
DT_EXPORT int dt_conflict_density_layout(int b, int a, int k,
                                         long long* out) {
  DensLayout l;
  if (!density_layout(b, a, k, l)) return 1;
  out[0] = l.words;
  out[1] = l.dense;
  out[2] = l.grid;
  return 0;
}

// K13b: int32[p] contending lanes of b x a accesses, one cooperative
// launch in the layout dt_conflict_density_layout reports.  `hist` is the
// caller's scratch of `hist_len` uint64 words (at least the layout's; a
// shorter one is refused before any launch); k is a power of two, at most
// 2^30; b * a < 2^31, so no count carries into the high word; p in [1,
// 1024].
DT_EXPORT int dt_conflict_density(const int32_t* table_ids,
                                  const int32_t* keys, const uint8_t* valid,
                                  const uint8_t* is_read,
                                  const uint8_t* is_write,
                                  const uint8_t* active, const int32_t* owner,
                                  int b, int a, int k, int p, int inc_arm,
                                  unsigned long long* hist,
                                  long long hist_len, int32_t* out,
                                  void* stream) {
  DensLayout l;
  if (p < 1 || p > 1024 || !density_layout(b, a, k, l) ||
      hist_len < l.words)
    return static_cast<int>(cudaErrorInvalidValue);
  DensArgs g = {table_ids, keys, valid, is_read, is_write,
                active,    owner, a == 0 ? 0 : b, a, p, inc_arm, l.rpw, k,
                l.shift,   static_cast<uint32_t>(k - 1), hist, out};
  const cudaStream_t s = dt_stream(stream);
  return a > 32 ? launch_density<true>(g, l, s)
                : launch_density<false>(g, l, s);
}

namespace {

// The counting rank of `order` into opos.
void launch_rank(const uint8_t* committed, const int32_t* order, int b,
                 const uint8_t* due, int32_t* opos, cudaStream_t s) {
  if (b <= 0) return;
  const int grid = (b + kRankRows - 1) / kRankRows;
  if (reinterpret_cast<uintptr_t>(order) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(committed) % 4 == 0)
    rank_count_kernel<true><<<grid, kRankThreads, 0, s>>>(committed, order,
                                                           b, due, opos);
  else
    rank_count_kernel<false><<<grid, kRankThreads, 0, s>>>(committed, order,
                                                            b, due, opos);
}

}  // namespace

// K17's rank alone: opos (b int32) of `order` over the committed txns;
// `due` may be null.
DT_EXPORT int dt_audit_rank(const uint8_t* committed, const int32_t* order,
                            int b, const uint8_t* due, int32_t* opos,
                            void* stream) {
  launch_rank(committed, order, b, due, opos, dt_stream(stream));
  return dt_status();
}

// K17, lanes: the rank (as dt_audit_rank; `opos` is b int32 of scratch),
// then 2 * b * a doubled lanes of the committed accesses; `order_free`
// and `due` may be null.
DT_EXPORT int dt_audit_lanes(const uint8_t* committed, const int32_t* order,
                             const int32_t* lvl, const int32_t* table_ids,
                             const int32_t* keys, const uint8_t* valid,
                             const uint8_t* is_read, const uint8_t* is_write,
                             const uint8_t* order_free, int b, int a,
                             int order_vis, const uint8_t* due, int32_t* opos,
                             int64_t* keys2, int32_t* pos2, int32_t* tid2,
                             void* stream) {
  cudaStream_t s = dt_stream(stream);
  launch_rank(committed, order, b, due, opos, s);
  audit_lanes_kernel<<<dt_blocks(static_cast<long long>(b) * a, kThreads),
                       kThreads, 0, s>>>(committed, lvl, table_ids, keys,
                                         valid, is_read, is_write, order_free,
                                         b, a, order_vis, due, opos, keys2,
                                         pos2, tid2);
  return dt_status();
}

// K15c-scan over n sorted lanes; `scratch` holds 2n + 8 * ceil(n / 1024)
// int32; bmask = audit_buckets - 1.
DT_EXPORT int dt_audit_scans(const int64_t* sk, const int32_t* sp,
                             const int32_t* sid, int n, int bmask,
                             const uint8_t* due, uint8_t* flags,
                             int32_t* edges, int32_t* sbk, uint8_t* obs,
                             int32_t* scratch, void* stream) {
  cudaStream_t s = dt_stream(stream);
  const int nb = (n + kTile - 1) / kTile;
  int32_t* prev = scratch;
  int32_t* nxt = scratch + n;
  int32_t* agg = scratch + 2 * n;
  int32_t* carry = agg + 4 * nb;
  scan_agg_kernel<<<nb, kTile, 0, s>>>(sk, sp, n, due, agg);
  scan_carry_kernel<<<1, kTile, 0, s>>>(agg, nb, due, carry);
  scan_tile_kernel<<<nb, kTile, 0, s>>>(sk, sp, sid, n, due, carry, prev,
                                        nxt);
  scan_lanes_kernel<<<dt_blocks(n, kThreads), kThreads, 0, s>>>(
      sk, sp, sid, n, static_cast<uint32_t>(bmask), due, prev, nxt, flags,
      edges, sbk, obs);
  return dt_status();
}

// K15c-compact of m = 2n flagged lanes into cap slots; `scratch` holds
// 2 * ceil(m / 1024) + 1 int32; lvl holds b int32.
DT_EXPORT int dt_compact_edges(const uint8_t* flags, const int32_t* edges2,
                               const int32_t* sbk, int m, int cap,
                               const int32_t* lvl, int b, const uint8_t* due,
                               int32_t* edges, int32_t* ebkt, int32_t* cnt,
                               int32_t* dropped, int32_t* wit,
                               int32_t* scratch, void* stream) {
  if (cap < 1 || b < 1) return 1;
  cudaStream_t s = dt_stream(stream);
  const int nt = (m + kTile - 1) / kTile;
  int32_t* tcnt = scratch;
  int32_t* toff = scratch + nt;
  compact_count_kernel<<<nt, kTile, 0, s>>>(flags, m, due, tcnt);
  compact_scan_kernel<<<1, kTile, 0, s>>>(tcnt, nt, cap, due, toff, edges,
                                          ebkt, cnt, dropped, wit);
  compact_place_kernel<<<nt, kTile, 0, s>>>(flags, edges2, sbk, m, cap, lvl,
                                            b, due, toff, edges, ebkt, wit);
  return dt_status();
}

// K17, stamps: n sorted lanes against k audit buckets (rings of depth h
// when vts is not null), stamps updated in place; `scratch` holds 2k int32
// (top, wid) and `dig` 2 uint32 (vdig, rdig), both zeroed here.
DT_EXPORT int dt_audit_observe(const int64_t* sk, const int32_t* sp,
                               const int32_t* sid, const int32_t* sbk,
                               const uint8_t* obs, int n, const int32_t* ts,
                               const int32_t* epoch, int32_t* st_epoch,
                               int32_t* st_writer, int32_t* vts,
                               int32_t* vepoch, int32_t* vwriter,
                               int32_t* vpos, int h, int k,
                               const uint8_t* due, int32_t* scratch,
                               uint32_t* dig, void* stream) {
  if (vts != nullptr && h < 1) return 1;
  cudaStream_t s = dt_stream(stream);
  int32_t* top = scratch;
  int32_t* wid = scratch + k;
  cudaMemsetAsync(scratch, 0, 2 * static_cast<size_t>(k) * sizeof(int32_t),
                  s);
  cudaMemsetAsync(dig, 0, 2 * sizeof(uint32_t), s);
  observe_lanes_kernel<<<dt_blocks(n, kThreads), kThreads, 0, s>>>(
      sk, sp, sid, sbk, obs, n, ts, st_epoch, st_writer, vts, vepoch, vwriter,
      h, due, top, dig);
  observe_wid_kernel<<<dt_blocks(n, kThreads), kThreads, 0, s>>>(
      sk, sp, sid, sbk, n, due, top, wid);
  observe_buckets_kernel<<<dt_blocks(k, kThreads), kThreads, 0, s>>>(
      top, wid, k, ts, epoch, st_epoch, st_writer, vts, vepoch, vwriter, vpos,
      h, due, dig);
  return dt_status();
}
