// K3 + K4b: YCSB's forward-execute and query generation.
//
// K3 replaces deneva_tpu/workloads/ycsb.py:78 _forward_execute_f0 (value
// law :57 _field_fingerprint, :65 _field_bytes) over a sorted ForwardPlan:
// read lanes gather F0 at their slot — a forwarded read (fwd >= 0) takes
// f(key, fwd) instead — and fold into a wrapping uint32 checksum; each
// key's final writer (win) stores f(key, rank) — only at a slot below cap:
// under part_cnt > 1 the winners of keys another partition owns carry the
// trash slot, and the trash row is never written (its gathers read the
// loader's 0).  Each key has exactly one winner, so the store is a
// duplicate-free direct scatter (the reference's `mono` cummax trick only
// spares XLA a sort inside its scatter).
//   One cooperative launch of the occupancy grid (1,024-thread blocks per
// SM x SMs, at most a block per 256 lanes; a grid barrier over 264 such
// blocks costs 1.41 µs on the card, over 1,056 of 256 threads 2.23)
// striding over the lanes, its warps interleaved over the blocks so that
// a small plan spreads over the SMs: every block gathers and sums its lanes'
// checksum and write count in registers, reduces them once and stores
// the pair to its own word of the scratch acc[2 + b]; one grid barrier;
// then the winners store, and block 0 adds the blocks' pairs into
// acc[0], acc[1] as int64 (the wrapper's results, with no conversion
// launch).  No memset, no atomic, no ticket: the scratch is the
// caller's, a word per block.  A lane's plan fields load together, one
// round trip, before its row or value; in fingerprint mode a thread's
// first 4 lanes (all of them on the main path) keep their store in
// registers across the barrier, so the plan is read once.
//   The order rests on a precondition: below cap, distinct keys have
// distinct slots, and the trash slot (cap) is never stored.  So the only
// store that can meet a gather is its own key's winner, and a read with
// fwd < 0 (a lane before its key's first write) must see the epoch-start
// row that winner overwrites — whichever blocks hold the two lanes, and
// however long the key's segment (zipf 0.9's hottest key holds ~2% of
// the main path's lanes).  The grid barrier orders every gather before
// every store.
//   Fingerprint mode is a thread per lane.  Full-row mode (uint8[rows,
// tup], tup % 4 == 0) gives a warp 32 lanes at a time: each lane loads
// its own plan fields, the warp lists its reading (or storing) lanes by
// ballot, and walks their rows' 4-byte words over its 32 threads (25 of
// a 100-byte row's words on one step, the next row's first words on the
// rest), the row's fields by shuffle, the word's place by a running
// (row, word) pair, no division; a gather issues 8 steps' loads before
// it sums them.  Forwarded words are computed in registers (word_law);
// 16-byte vectors would not align (tup = 100).
//   Bound: bytes — the plan's 19 B/lane plus one F0 row per distinct
// gathered slot and per winner.
//
// K4b replaces deneva_tpu/workloads/ycsb.py:277 generate with
// deneva_tpu/ops/sampling.py:54 Zipfian.sample and :70 HotSet.sample:
// split(gen_key, 3) -> k1, k2, k3; keys from k1; is_write = uniform(k2) <
// write_perc; under txn_write_perc < 1 a per-txn draw from k3 gates the
// row's writes; under key_order each txn's keys are sorted ascending (the
// write flags stay put).
//   One launch for every option, over chunks of whole rows (a multiple
//   of 4 rows).  Where the draws at 4 a thread fill at least half the
//   resident threads (the main path), a thread draws 4 consecutive
//   elements (8 or 16 independent hash chains) and stores one 16-byte
//   key vector and one 4-byte flag word, the chunk's ragged tail element
//   by element; the grid is at most the occupancy grid (asked once per
//   device and variant: zipf, theta 0 or HOT, with or without key_order)
//   and strides over chunks of at most a block's 1,024 draws, fewer (but
//   at least a warp's) where full chunks would leave its blocks idle.
//   Below (a 2,048-txn sweep epoch) a thread draws one, so the draws
//   spread over 4 times the warps, and each chunk of a block's 256 draws
//   gets a block.  A block's warp 0 hashes the split keys by parallel
//   lanes, one level at a time (k1..k3; under HOT split(k1, 3) and the
//   two randint key pairs: three dependent hashes, where the slice-4
//   kernel's thread 0 hashed ten in series in every one of 2,560
//   blocks), for the block's warps through shared memory.
//   The per-txn gate is hashed once a row into shared memory (it was
//   hashed once an element, behind a division).
//   Zipf: the quantile is evaluated in float32 op by op as the reference
//   does (round-to-nearest intrinsics, so nvcc contracts nothing into an
//   FMA), except that the power is taken in float64 and rounded to
//   float32 — the plain version does the same
//   (deneva_tpu_torch/ops/sampling.py).  The power stays: [K4b-split]
//   timed it below the hashes (PERF.md).
//   HOT: split(k1, 3) -> h1, h2, h3; a Bernoulli from h1 picks the hot or
//   the cold range, and jax.random.randint draws from h2 or h3, each split
//   again in two for its high and low words, folded by remainders in
//   wrapping uint32 (jax/_src/random.py:581 _randint).  The range's keys,
//   span, multiplier and remainder magic are selected first and one
//   randint is drawn (the slice-4 kernel's warps took both branches);
//   each % span is a multiply-high by the host's magic number
//   (threefry.cuh dt_fastmod, exact for every uint32 and span).  No pow,
//   so the keys equal the reference's bit for bit.
//   key_order: in the same launch the chunk's keys (<= 1,024, req <= 64)
//   go to shared memory and each is stored at its rank in its row (keys
//   below it, or equal and earlier), so rows leave sorted; the slice-4
//   kernel's second launch insertion-sorted in local memory.
//   Bound: operations — two 20-round threefry hashes and a float64 pow
//   (or four hashes under HOT) per element against 5 output bytes; on
//   the H100 the hashes' integer instructions and the pow's float64 ones
//   run on separate pipes (PERF.md [K4b-split]).
#include <cooperative_groups.h>

#include "common.cuh"
#include "threefry.cuh"
#include "value_law.cuh"

namespace {

struct AddOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

constexpr int kExecThreads = 1024;
constexpr int kExecBatch = 8;     // a warp's row-word steps in flight
constexpr int kExecCarry = 4;     // lanes a thread carries to its stores
constexpr unsigned kWarpAll = 0xffffffffu;

// A block's checksum and write count, reduced once, into its own word
// acc[2 + b] (write count high, checksum low).
__device__ __forceinline__ void exec_partials(uint32_t s, uint32_t wc,
                                              unsigned long long* acc) {
  s = dt_block_reduce(s, AddOp(), 0u);
  wc = dt_block_reduce(wc, AddOp(), 0u);
  if (threadIdx.x == 0)
    acc[2 + blockIdx.x] = static_cast<unsigned long long>(wc) << 32 | s;
}

// Block 0, after the grid barrier: the blocks' words summed into acc[0]
// (checksum) and acc[1] (write count), each a wrapping uint32 widened to
// 64 bits; read past L1, as other SMs wrote them.
__device__ __forceinline__ void exec_totals(unsigned long long* acc) {
  uint32_t s = 0u, wc = 0u;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
    const unsigned long long w = __ldcg(acc + 2 + b);
    s += static_cast<uint32_t>(w);
    wc += static_cast<uint32_t>(w >> 32);
  }
  s = dt_block_reduce(s, AddOp(), 0u);
  wc = dt_block_reduce(wc, AddOp(), 0u);
  if (threadIdx.x == 0) {
    acc[0] = s;
    acc[1] = wc;
  }
}

// A warp's list of its lanes set in `rows`, in lane order; returns how
// many.
__device__ __forceinline__ int warp_list(unsigned rows, uint8_t* list) {
  const int lane = threadIdx.x & 31;
  if (rows >> lane & 1u)
    list[__popc(rows & ((1u << lane) - 1u))] = static_cast<uint8_t>(lane);
  __syncwarp();
  return __popc(rows);
}

// One step of a warp's walk over the 4-byte words of its listed rows:
// warp lane l holds word u of the r-th listed row, r * words + u running
// over the steps in 32s (q, rem = 32 / words, 32 % words: no division).
__device__ __forceinline__ void walk_step(int& r, int& u, int words, int q,
                                          int rem) {
  r += q;
  u += rem;
  if (u >= words) {
    u -= words;
    ++r;
  }
}

template <bool kRow>
__global__ void __launch_bounds__(kExecThreads)
    forward_exec_kernel(void* f0v, int tup, const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ rank,
                        const uint8_t* __restrict__ is_read,
                        const uint8_t* __restrict__ is_write,
                        const int32_t* __restrict__ fwd,
                        const uint8_t* __restrict__ win,
                        const int32_t* __restrict__ slots, int n, int cap,
                        unsigned long long* acc) {
  __shared__ uint8_t lists[kExecThreads / 32][32];
  uint8_t* list = lists[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int words = tup >> 2;
  const int q = kRow ? 32 / words : 0, rem = kRow ? 32 % words : 0;
  // warps interleave over the blocks (warp w of block b takes lanes
  // 32 (w * blocks + b) + ...), so a small plan spreads over every SM
  const int tid = ((threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 + lane;
  const int stride = gridDim.x * blockDim.x;
  uint32_t s = 0u, wc = 0u;
  // a lane's plan fields load together (one round trip; the plan is
  // small and usually in L2 from K2), then its row or value
  // fingerprint mode: a thread's first kExecCarry lanes keep their store
  // (slot, or -1, and value) in registers across the barrier
  int32_t carry_slot[kExecCarry];
  uint32_t carry_val[kExecCarry];
  if (!kRow) {
    const uint32_t* f0 = static_cast<const uint32_t*>(f0v);
    auto gather = [&](int i) {
      const bool rd = is_read[i];
      const int32_t f = fwd[i], k = keys[i], sl = slots[i];
      wc += is_write[i];
      if (rd)
        s += f >= 0 ? fp_law(static_cast<uint32_t>(k),
                             static_cast<uint32_t>(f))
                    : f0[sl];
    };
#pragma unroll
    for (int c = 0; c < kExecCarry; ++c) {
      const int i = tid + c * stride;
      carry_slot[c] = -1;
      if (i < n) {
        gather(i);
        const int32_t sl = slots[i];
        if (win[i] && sl < cap) {
          carry_slot[c] = sl;
          carry_val[c] = fp_law(static_cast<uint32_t>(keys[i]),
                                static_cast<uint32_t>(rank[i]));
        }
      }
    }
#pragma unroll 4
    for (int i = tid + kExecCarry * stride; i < n; i += stride) gather(i);
  } else {
    const uint8_t* f0 = static_cast<const uint8_t*>(f0v);
    for (int base = tid - lane; base < n; base += stride) {
      const int i = base + lane;
      bool rd = false;
      int32_t f = -1, sl = 0;
      uint32_t fp = 0u;
      if (i < n) {
        rd = is_read[i] != 0;
        f = fwd[i];
        sl = slots[i];
        fp = fp_law(static_cast<uint32_t>(keys[i]), static_cast<uint32_t>(f));
        wc += is_write[i];
      }
      const int total = warp_list(__ballot_sync(kWarpAll, rd), list) * words;
      int r = lane / words, u = lane - r * words;
      for (int t0 = 0; t0 < total; t0 += 32 * kExecBatch) {
        // kExecBatch steps' words in flight before they are summed
        uint32_t x[kExecBatch];
#pragma unroll
        for (int b = 0; b < kExecBatch; ++b) {
          const bool act = t0 + 32 * b + lane < total;
          const int j = act ? static_cast<int>(list[r]) : 0;
          const int32_t fj = __shfl_sync(kWarpAll, f, j);
          const int32_t sj = __shfl_sync(kWarpAll, sl, j);
          const uint32_t pj = __shfl_sync(kWarpAll, fp, j);
          x[b] = !act ? 0u
                 : fj >= 0 ? word_law(pj, 4u * static_cast<uint32_t>(u))
                           : reinterpret_cast<const uint32_t*>(
                                 f0 + static_cast<size_t>(sj) * tup)[u];
          walk_step(r, u, words, q, rem);
        }
#pragma unroll
        for (int b = 0; b < kExecBatch; ++b) s += byte_sum(x[b]);
      }
      __syncwarp();
    }
  }
  exec_partials(s, wc, acc);
  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0) exec_totals(acc);
  if (!kRow) {
    uint32_t* f0 = static_cast<uint32_t*>(f0v);
#pragma unroll
    for (int c = 0; c < kExecCarry; ++c)
      if (carry_slot[c] >= 0) f0[carry_slot[c]] = carry_val[c];
#pragma unroll 4
    for (int i = tid + kExecCarry * stride; i < n; i += stride) {
      const bool w = win[i];
      const int32_t sl = slots[i], k = keys[i], v = rank[i];
      if (w && sl < cap)
        f0[sl] = fp_law(static_cast<uint32_t>(k), static_cast<uint32_t>(v));
    }
  } else {
    uint8_t* f0 = static_cast<uint8_t*>(f0v);
    for (int base = tid - lane; base < n; base += stride) {
      const int i = base + lane;
      bool st = false;
      int32_t sl = 0;
      uint32_t fp = 0u;
      if (i < n) {
        sl = slots[i];
        st = win[i] && sl < cap;
        fp = fp_law(static_cast<uint32_t>(keys[i]),
                    static_cast<uint32_t>(rank[i]));
      }
      const int total = warp_list(__ballot_sync(kWarpAll, st), list) * words;
      int r = lane / words, u = lane - r * words;
      for (int t0 = 0; t0 < total; t0 += 32) {
        const bool act = t0 + lane < total;
        const int j = act ? static_cast<int>(list[r]) : 0;
        const int32_t sj = __shfl_sync(kWarpAll, sl, j);
        const uint32_t pj = __shfl_sync(kWarpAll, fp, j);
        if (act)
          reinterpret_cast<uint32_t*>(f0 + static_cast<size_t>(sj) * tup)[u] =
              word_law(pj, 4u * static_cast<uint32_t>(u));
        walk_step(r, u, words, q, rem);
      }
      __syncwarp();
    }
  }
}

// The occupancy grid of K3's launch on the current device (blocks per SM
// x SMs), asked once per device; 0 where a query fails.
template <bool kRow>
int exec_grid() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, forward_exec_kernel<kRow>, kExecThreads, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

// -- K4b ----------------------------------------------------------------------

constexpr int kGenThreads = 256;
constexpr int kMaxSortedReq = 64;

enum GenMode : int { kGenZipf = 0, kGenTheta0 = 1, kGenHot = 2 };

struct GenArgs {
  const int64_t* gen_key;
  int n, req, n_rows;
  int rows_per_chunk, chunks;   // a chunk: whole rows, a multiple of 4
  float n_f, zetan, eta, alpha, thresh1;
  // HOT: the hot range [0, hot_span), the cold one [hot_max, hot_max +
  // cold_span) (hot_span = hot_max); each range's span, randint
  // multiplier and remainder magic from the host
  uint32_t hot_max, hot_span, hot_mult, cold_span, cold_mult;
  unsigned long long hot_magic, cold_magic;
  float access_perc, p_write, p_txn_write;
  int write_gate;
  int32_t* keys;
  uint8_t* is_write;
};

// The launch's split keys: split(gen_key, 3) -> k1, k2, k3 and, under HOT,
// split(k1, 3) -> h1, h2, h3, then split(h2, 2) and split(h3, 2).  A
// block's warp 0 hashes them, one level at a time by parallel lanes (the
// lane's index the counter), gathering each level by shuffles: three
// dependent hashes under HOT, one otherwise, once a resident block.
struct GenKeys {
  uint32_t k1[2], k2[2], k3[2], h1[2], h2a[2], h2b[2], h3a[2], h3b[2];
};

template <int kMode>
__device__ __forceinline__ GenKeys gen_keys(const int64_t* gen_key) {
  const uint32_t lane = threadIdx.x & 31;
  GenKeys s = {};
  uint32_t x0 = 0u, x1 = lane;
  dt_threefry2x32(static_cast<uint32_t>(gen_key[0]),
                  static_cast<uint32_t>(gen_key[1]), x0, x1);
#define DT_GEN_TAKE(dst, src, from)                 \
  dst[0] = __shfl_sync(kWarpAll, src##0, from);     \
  dst[1] = __shfl_sync(kWarpAll, src##1, from);
  DT_GEN_TAKE(s.k1, x, 0)
  DT_GEN_TAKE(s.k2, x, 1)
  DT_GEN_TAKE(s.k3, x, 2)
  if (kMode == kGenHot) {
    uint32_t y0 = 0u, y1 = lane;
    dt_threefry2x32(s.k1[0], s.k1[1], y0, y1);
    DT_GEN_TAKE(s.h1, y, 0)
    // lanes 0, 1 split h2 (lane 1's), lanes 2, 3 split h3 (lane 2's)
    const int src = lane < 2 ? 1 : 2;
    const uint32_t c0 = __shfl_sync(kWarpAll, y0, src);
    const uint32_t c1 = __shfl_sync(kWarpAll, y1, src);
    uint32_t z0 = 0u, z1 = lane & 1u;
    dt_threefry2x32(c0, c1, z0, z1);
    DT_GEN_TAKE(s.h2a, z, 0)
    DT_GEN_TAKE(s.h2b, z, 1)
    DT_GEN_TAKE(s.h3a, z, 2)
    DT_GEN_TAKE(s.h3b, z, 3)
  }
#undef DT_GEN_TAKE
  return s;
}

// The key of flat draw i.
template <int kMode>
__device__ __forceinline__ int32_t gen_key_at(const GenArgs& g,
                                              const GenKeys& s, uint32_t i) {
  if (kMode == kGenHot) {
    // the Bernoulli picks the range; one randint from its keys, its
    // remainders by the range's magic
    const bool hot =
        dt_bits_to_uniform(dt_random_bits(s.h1[0], s.h1[1], i)) <
        g.access_perc;
    const uint32_t a0 = hot ? s.h2a[0] : s.h3a[0];
    const uint32_t a1 = hot ? s.h2a[1] : s.h3a[1];
    const uint32_t b0 = hot ? s.h2b[0] : s.h3b[0];
    const uint32_t b1 = hot ? s.h2b[1] : s.h3b[1];
    const uint32_t off = dt_randint_fold(
        dt_random_bits(a0, a1, i), dt_random_bits(b0, b1, i),
        hot ? g.hot_span : g.cold_span, hot ? g.hot_mult : g.cold_mult,
        hot ? g.hot_magic : g.cold_magic);
    return static_cast<int32_t>((hot ? 0u : g.hot_max) + off);
  } else if (kMode == kGenTheta0) {
    const float u = dt_bits_to_uniform(dt_random_bits(s.k1[0], s.k1[1], i));
    return min(__float2int_rz(__fmul_rn(u, g.n_f)), g.n_rows - 1);
  } else {
    const float u = dt_bits_to_uniform(dt_random_bits(s.k1[0], s.k1[1], i));
    const float uz = __fmul_rn(u, g.zetan);
    const float base =
        __fadd_rn(__fsub_rn(__fmul_rn(g.eta, u), g.eta), 1.0f);
    const float pw = __double2float_rn(
        pow(static_cast<double>(base), static_cast<double>(g.alpha)));
    const int32_t spread = __float2int_rz(__fmul_rn(g.n_f, pw));
    const int32_t v = uz < 1.0f ? 0 : (uz < g.thresh1 ? 1 : spread);
    return max(0, min(v, g.n_rows - 1));
  }
}

// K4b as one launch of the occupancy grid striding over chunks of whole
// rows.  A thread draws kPer consecutive elements; at 4 (8 or 16
// independent hash chains) it stores them as one 16-byte key vector and
// one 4-byte flag word, the chunk's ragged tail element by element.  The
// per-txn write gate is hashed once a row into shared memory; under
// key_order the chunk's keys (<= a block's 256 kPer draws) go to shared
// memory and each is placed at its rank within its row (ties by
// position), so the row leaves sorted.
template <int kMode, bool kSort, int kPer>
__global__ void __launch_bounds__(kGenThreads) generate_kernel(GenArgs g) {
  constexpr int kSpan = kGenThreads * kPer;   // draws a block takes at once
  __shared__ int32_t skeys[kSort ? kSpan : 1];
  __shared__ uint8_t sgate[kSpan];
  __shared__ GenKeys skey;
  const int t = threadIdx.x;
  // warp 0 hashes the keys for the block (a small chunk leaves most of a
  // block's warps idle, which then hash nothing)
  if (t < 32) {
    const GenKeys k = gen_keys<kMode>(g.gen_key);
    if (t == 0) skey = k;
  }
  __syncthreads();
  const GenKeys s = skey;
  for (int c = blockIdx.x; c < g.chunks; c += gridDim.x) {
    const int r0 = c * g.rows_per_chunk;
    const int rows = min(g.rows_per_chunk, g.n - r0);
    const int ne = rows * g.req;
    const int base = r0 * g.req;
    if (g.write_gate) {
      for (int r = t; r < rows; r += kGenThreads)
        sgate[r] = dt_bits_to_uniform(dt_random_bits(
                       s.k3[0], s.k3[1], static_cast<uint64_t>(r0 + r))) <
                   g.p_txn_write;
      __syncthreads();
    }
    for (int e0 = kPer * t; e0 < ne; e0 += kSpan) {
      int32_t v[kPer];
      bool w[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const uint32_t i = static_cast<uint32_t>(base + e0 + u);
        v[u] = gen_key_at<kMode>(g, s, i);
        w[u] = dt_bits_to_uniform(dt_random_bits(s.k2[0], s.k2[1], i)) <
               g.p_write;
      }
      if (g.write_gate) {
        int row = e0 / g.req, pos = e0 - row * g.req;   // once a thread
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          if (e0 + u < ne) w[u] = w[u] && sgate[row];
          if (++pos == g.req) {
            pos = 0;
            ++row;
          }
        }
      }
      // 4 draws: whole vectors (a chunk starts on a multiple of 4)
      const bool full = kPer == 4 && e0 + kPer <= ne;
      if constexpr (kPer == 4) {
        if (full)
          *reinterpret_cast<uint32_t*>(g.is_write + base + e0) =
              static_cast<uint32_t>(w[0]) |
              static_cast<uint32_t>(w[1]) << 8 |
              static_cast<uint32_t>(w[2]) << 16 |
              static_cast<uint32_t>(w[3]) << 24;
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (e0 + u >= ne) continue;
        if (!full) g.is_write[base + e0 + u] = w[u];
        if (kSort) skeys[e0 + u] = v[u];
        else if (!full) g.keys[base + e0 + u] = v[u];
      }
      if constexpr (kPer == 4 && !kSort) {
        if (full)
          *reinterpret_cast<int4*>(g.keys + base + e0) =
              make_int4(v[0], v[1], v[2], v[3]);
      }
    }
    if (kSort) {
      // req <= 64, so ne <= kSpan and e0 = kPer t is a thread's one group
      __syncthreads();
      const int e0 = kPer * t;
      int32_t v[kPer];
      int at[kPer];
      if (e0 < ne) {
        int row = e0 / g.req, pos = e0 - row * g.req;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          if (e0 + u < ne) {
            const int rs = row * g.req;
            const int32_t x = skeys[e0 + u];
            int below = 0;
            for (int j = 0; j < g.req; ++j) {
              const int32_t y = skeys[rs + j];
              below += y < x || (y == x && j < pos);
            }
            v[u] = x;
            at[u] = rs + below;
          }
          if (++pos == g.req) {
            pos = 0;
            ++row;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (e0 + u < ne) skeys[at[u]] = v[u];
      __syncthreads();
      if constexpr (kPer == 4) {
        if (e0 + kPer <= ne) {
          *reinterpret_cast<int4*>(g.keys + base + e0) = make_int4(
              skeys[e0], skeys[e0 + 1], skeys[e0 + 2], skeys[e0 + 3]);
        } else {
          for (int e = e0; e < ne; ++e) g.keys[base + e] = skeys[e];
        }
      } else {
        for (int e = e0; e < min(ne, e0 + kPer); ++e)
          g.keys[base + e] = skeys[e];
      }
    }
    // the chunk's shared gates and keys are read before the next's land
    if (g.write_gate || kSort) __syncthreads();
  }
}

// The occupancy grid of a K4b variant at 4 draws a thread on the current
// device, asked once per device; 0 where a query fails.
template <int kMode, bool kSort>
int gen_grid() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, generate_kernel<kMode, kSort, 4>, kGenThreads, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

// At 4 draws a thread a chunk is at most a block's 1,024 draws, and fewer
// rows where that would leave blocks of the occupancy grid without a
// chunk, but never fewer draws than a warp takes (128: the main path's
// 65,536 txns of 10 keys fill 656 blocks of 100 rows); the grid strides
// over the chunks.  At 1 draw a thread (a small epoch) a chunk is a
// block's 256 draws and gets a block of its own, so the hardware spreads
// the last chunks over the SMs (a grid-stride over the occupancy grid
// left its last round to a part of the blocks).  A chunk is a multiple
// of 4 rows, so it starts on a 16-byte key vector.
template <int kMode, bool kSort, int kPer>
int launch_chunks(GenArgs g, int fit, cudaStream_t s) {
  const int full = max(1, kGenThreads * kPer / (4 * g.req));   // quads
  g.rows_per_chunk =
      4 * (kPer == 1 ? full
                     : min(full, max((g.n + 4 * fit - 1) / (4 * fit),
                                     (8 * kPer + g.req - 1) / g.req)));
  g.chunks = (g.n + g.rows_per_chunk - 1) / g.rows_per_chunk;
  const int grid = kPer == 1 ? max(1, g.chunks) : max(1, min(fit, g.chunks));
  generate_kernel<kMode, kSort, kPer><<<grid, kGenThreads, 0, s>>>(g);
  return dt_status();
}

// 4 draws a thread where the draws at 4 a thread fill at least half the
// resident threads of that variant's occupancy grid (the main path's
// 655,360); 1 below, where 4 a thread would leave most of the card's warp
// schedulers idle while each warp issues its draws' hashes in series
// (ycsb_skew's and ycsb_hot's 20,480 draws are 160 warps at 4 a thread,
// 640 at 1, on the H100's 528 schedulers).
template <int kMode, bool kSort>
int launch_generate(GenArgs g, cudaStream_t s) {
  const int fit = gen_grid<kMode, kSort>();
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<long long>(g.n) * g.req >=
                 2LL * fit * kGenThreads
             ? launch_chunks<kMode, kSort, 4>(g, fit, s)
             : launch_chunks<kMode, kSort, 1>(g, fit, s);
}

}  // namespace

// K3: tup == 0 -> fingerprint table (uint32 F0); else uint8[rows, tup]
// with tup % 4 == 0.  acc (acc_len >= 3 int64 words, the caller's
// scratch) receives (checksum, write lanes) in [0, 2^32) in its first two
// words; the grid takes at most acc_len - 2 blocks.  Winners store only
// at slots < cap (the trash slot).
DT_EXPORT int dt_forward_execute(void* f0, int tup, const int32_t* keys,
                                 const int32_t* rank, const uint8_t* is_read,
                                 const uint8_t* is_write, const int32_t* fwd,
                                 const uint8_t* win, const int32_t* slots,
                                 int n, int cap, unsigned long long* acc,
                                 int acc_len, void* stream) {
  const bool row = tup != 0;
  const int fit = row ? exec_grid<true>() : exec_grid<false>();
  const int room = acc_len - 2;
  if (fit < 1 || room < 1 || n < 0 || (row && (tup < 4 || tup % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = min(min(fit, room), dt_blocks(n, 256));
  void* args[] = {&f0,  &tup, &keys,  &rank, &is_read, &is_write,
                  &fwd, &win, &slots, &n,    &cap,     &acc};
  const void* kernel =
      row ? reinterpret_cast<const void*>(forward_exec_kernel<true>)
          : reinterpret_cast<const void*>(forward_exec_kernel<false>);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kExecThreads), args, 0, dt_stream(stream));
  return e != cudaSuccess ? static_cast<int>(e) : dt_status();
}

// K4b: n txns of req draws into keys int32 / is_write bool [n, req], one
// launch.  hot_max > 0 selects HOT keys (its two ranges' spans, randint
// multipliers and remainder magics from the host), else zipf; write_gate
// applies the per-txn draw; key_order sorts each row (req <= 64).
DT_EXPORT int dt_ycsb_generate(
    const int64_t* gen_key, int n, int req, int n_rows, int theta_zero,
    float n_f, float zetan, float eta, float alpha, float thresh1,
    int hot_max, float access_perc, unsigned int hot_span,
    unsigned int hot_mult, unsigned long long hot_magic,
    unsigned int cold_span, unsigned int cold_mult,
    unsigned long long cold_magic, float p_write, int write_gate,
    float p_txn_write, int key_order, int32_t* keys, uint8_t* is_write,
    void* stream) {
  if (n < 0 || req < 1 || hot_max < 0 ||
      (hot_max > 0 && (hot_span < 1 || cold_span < 1)) ||
      static_cast<long long>(n) * req >= (1LL << 31) ||
      (key_order && req > kMaxSortedReq))
    return static_cast<int>(cudaErrorInvalidValue);
  GenArgs g = {};
  g.gen_key = gen_key;
  g.n = n;
  g.req = req;
  g.n_rows = n_rows;
  g.n_f = n_f;
  g.zetan = zetan;
  g.eta = eta;
  g.alpha = alpha;
  g.thresh1 = thresh1;
  g.hot_max = static_cast<uint32_t>(hot_max);
  g.hot_span = hot_span;
  g.hot_mult = hot_mult;
  g.cold_span = cold_span;
  g.cold_mult = cold_mult;
  g.hot_magic = hot_magic;
  g.cold_magic = cold_magic;
  g.access_perc = access_perc;
  g.p_write = p_write;
  g.p_txn_write = p_txn_write;
  g.write_gate = write_gate;
  g.keys = keys;
  g.is_write = is_write;
  const cudaStream_t s = dt_stream(stream);
  const bool sort = key_order != 0;
  if (hot_max > 0)
    return sort ? launch_generate<kGenHot, true>(g, s)
                : launch_generate<kGenHot, false>(g, s);
  if (theta_zero)
    return sort ? launch_generate<kGenTheta0, true>(g, s)
                : launch_generate<kGenTheta0, false>(g, s);
  return sort ? launch_generate<kGenZipf, true>(g, s)
              : launch_generate<kGenZipf, false>(g, s);
}
