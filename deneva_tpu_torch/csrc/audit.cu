// K13b + K15c + K17: the metrics plane's conflict density and the
// isolation audit plane's single-node half.
//
// K13b replaces deneva_tpu/cc/base.py:228 conflict_density.  Pass 1 hashes
// every valid, active lane into its family-0 conflict bucket and counts
// per bucket the writes and the touches (all valid lanes, or under the
// reference's incidence arm only the lanes that read or write), with one
// atomic per warp-group of equal buckets (__match_any_sync).  Pass 2 is one
// thread per lane: the txn's own same-bucket lanes (a walk of its row's A
// buckets) are subtracted, the contention rule  w_oth > 0 | (w & u_oth >
// 0)  applied, and the lane counted into its owner's slot of int32[P]
// (shared-memory counts, one global atomic per block and owner).  The
// incidence's column sums and the scatter arm give these same integers.
//   Bound: bytes.  Each lane's table id, key and owner (4 B each) and its
//   valid / read / write flags (1 B each) read once, the txn flags, P
//   counts out: 26 MB at the forwarding batch of 65,536 x 16.
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

__global__ void density_hist_kernel(
    const int32_t* __restrict__ table_ids, const int32_t* __restrict__ keys,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ is_read,
    const uint8_t* __restrict__ is_write, const uint8_t* __restrict__ active,
    int n, int a, uint32_t kmask, int inc_arm, int32_t* __restrict__ wcol,
    int32_t* __restrict__ ucol, int32_t* __restrict__ bkt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const bool v = in && valid[i] && active[i / a];
  const uint32_t bk = v ? bucket_of(table_ids[i], keys[i], 0, kmask)
                        : 0xFFFFFFFFu;
  const bool w = v && is_write[i];
  const bool u = v && (!inc_arm || is_read[i] || w);
  if (in) bkt[i] = v ? static_cast<int32_t>(bk) : -1;
  // one atomic per group of lanes of a warp on one bucket
  const uint32_t peers = __match_any_sync(0xffffffffu, bk);
  const uint32_t su = __reduce_add_sync(peers, u ? 1u : 0u);
  const uint32_t sw = __reduce_add_sync(peers, w ? 1u : 0u);
  if (v && (threadIdx.x & 31) == __ffs(peers) - 1) {
    if (su) atomicAdd(&ucol[bk], static_cast<int32_t>(su));
    if (sw) atomicAdd(&wcol[bk], static_cast<int32_t>(sw));
  }
}

__global__ void density_conf_kernel(const int32_t* __restrict__ bkt,
                                    const uint8_t* __restrict__ is_write,
                                    const int32_t* __restrict__ owner, int n,
                                    int a, int p,
                                    const int32_t* __restrict__ wcol,
                                    const int32_t* __restrict__ ucol,
                                    int32_t* __restrict__ out) {
  extern __shared__ int32_t cnt[];
  for (int j = threadIdx.x; j < p; j += blockDim.x) cnt[j] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t o = -1;
  if (i < n && bkt[i] >= 0) {
    const int32_t bk = bkt[i];
    const int row0 = (i / a) * a;
    int32_t own_w = 0, own_u = 0;
    for (int s = 0; s < a; ++s) {
      // an invalid lane holds -1, so equal buckets are valid lanes
      if (bkt[row0 + s] == bk) {
        ++own_u;
        own_w += is_write[row0 + s] ? 1 : 0;
      }
    }
    const bool w = is_write[i];
    const bool conf =
        wcol[bk] - own_w > 0 || (w && ucol[bk] - own_u > 0);
    if (conf && owner[i] >= 0 && owner[i] < p) o = owner[i];
  }
  const uint32_t peers = __match_any_sync(0xffffffffu, o);
  if (o >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&cnt[o], __popc(peers));
  __syncthreads();
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    if (cnt[j]) atomicAdd(&out[j], cnt[j]);
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

}  // namespace

// K13b: int32[p] contending lanes of b x a accesses.  `scratch` holds 2k +
// b*a int32 (write counts, touch counts, lane buckets); k a power of two.
DT_EXPORT int dt_conflict_density(const int32_t* table_ids,
                                  const int32_t* keys, const uint8_t* valid,
                                  const uint8_t* is_read,
                                  const uint8_t* is_write,
                                  const uint8_t* active, const int32_t* owner,
                                  int b, int a, int k, int p, int inc_arm,
                                  int32_t* scratch, int32_t* out,
                                  void* stream) {
  if ((k & (k - 1)) != 0 || p < 1 || p > 1024) return 1;
  cudaStream_t s = dt_stream(stream);
  const int n = b * a;
  int32_t* wcol = scratch;
  int32_t* ucol = scratch + k;
  int32_t* bkt = scratch + 2 * k;
  cudaMemsetAsync(scratch, 0, 2 * static_cast<size_t>(k) * sizeof(int32_t),
                  s);
  cudaMemsetAsync(out, 0, static_cast<size_t>(p) * sizeof(int32_t), s);
  density_hist_kernel<<<dt_blocks(n, kThreads), kThreads, 0, s>>>(
      table_ids, keys, valid, is_read, is_write, active, n, a,
      static_cast<uint32_t>(k - 1), inc_arm, wcol, ucol, bkt);
  density_conf_kernel<<<dt_blocks(n, kThreads), kThreads,
                        p * sizeof(int32_t), s>>>(bkt, is_write, owner, n, a,
                                                  p, wcol, ucol, out);
  return dt_status();
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
