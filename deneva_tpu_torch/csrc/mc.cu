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
// where prefix_o(t) sums the owner-o lane counts c[t][o] of the txns t'
// before t in (ts, txn) order.  So t defers iff prefix_o(t) + c[t][o] >
// pair_cap for an owner o it touches; invalid lanes count nowhere.
//   One cooperative launch (defer_kernel) over tiles of 1,024 txns, a
// block a tile (the grid at most the occupancy grid, asked once per
// device; a block strides over tiles past it), in phases split by grid
// barriers:
//   0  the tile's lanes read once, a warp's 32 adjacent ones at a time,
//      into each txn's D owner counts (a ballot an owner; the lane that
//      starts a txn's run adds the run's counts, a byte an owner, with
//      one shared 64-bit add), stored as one word a txn; the tile's
//      histogram of each of ts's four bytes (ts ^ 2^31, so signed
//      order); the look-back words zeroed.  Barrier.
//   1  every block sums the tiles' histograms into each byte's digit
//      bases; a byte whose digits are all one value is no pass (the main
//      path's ts, pool sequence numbers, span two or three bytes).
//   2  one stable LSD radix pass a remaining byte over (ts, txn) words: a
//      tile's words ranked per warp (__match_any_sync), its digit counts
//      published, each digit's count in earlier tiles found by a
//      decoupled look-back, the tile staged in digit order and stored;
//      the last pass stores the txn at its place in `order`.  Barrier
//      after each pass.
//   3  a block a tile of positions: each position's txn's counts
//      (the stored word), block scans of the D count rows, the tiles'
//      prefixes by a look-back, and the test, which writes dfr once.
// So each lane is read once, each output word written once, nothing is
// zeroed by the caller, and the rank's work grows as bD, not bD^2.
//   Bound: bytes (keys, valid and ts read once; flags and order written
//   once).  What holds it: the phases (PERF.md [K18a-phases]) — the
//   launch, 2-4 grid barriers and the look-backs, ~9 of ~28 µs, and the
//   lanes phase's instructions.
//
// K18b replaces deneva_tpu/workloads/ycsb.py:413-441 (drop the deferred
// txns' lanes, stable (owner, ts) sort, bincount, one fixed block per
// destination).  Count rows of the txns in K18a's order, the deferred
// txns' counts zeroed, and their row scans give every surviving lane its
// slot prefix_o(t) + rank in
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

#include <cooperative_groups.h>

namespace {

constexpr int kMaxParts = 8;
constexpr int kThreads = 256;
constexpr int kRowScanThreads = 1024;
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

// ---- K18a ------------------------------------------------------------------

constexpr int kTile = 1024;                // txns a tile, a thread each
constexpr int kTileWarps = kTile / 32;
constexpr int kDigits = 256;
constexpr int kKeyBytes = 4;
constexpr uint32_t kNoDigit = 0xFFFFu;
constexpr uint32_t kFlagAgg = 1u << 30;    // the tile's own count
constexpr uint32_t kFlagInc = 2u << 30;    // the count through this tile
constexpr uint32_t kValueMask = kFlagAgg - 1u;
constexpr int kLookback = 8;               // status words read a step
constexpr int kLaneBatch = 8;              // lane chunks a warp loads at once

struct AddU64 {
  __device__ uint64_t operator()(uint64_t a, uint64_t b) const {
    return a + b;
  }
};

// Scratch of K18a at bD txns, in uint32 words: the tiles' histograms
// [4][tiles][256], the passes' look-back words [4][tiles][256], the
// scan's look-back words [tiles][8], each txn's packed counts (uint64
// [bD]) and the sort's two buffers of (key, txn) words (uint64 [2][bD]).
__host__ __device__ __forceinline__ int defer_tiles(int bd) {
  return (bd + kTile - 1) / kTile;
}

inline size_t defer_scratch_words(int bd) {
  const size_t t = defer_tiles(bd);
  return 2 * kKeyBytes * t * kDigits + 8 * t + 6 * static_cast<size_t>(bd);
}

__device__ __forceinline__ uint32_t key_digit(uint64_t w, int p) {
  return static_cast<uint32_t>(w >> (32 + 8 * p)) & (kDigits - 1);
}

// The sum of the values of the tiles before `tile` from their status
// words st[j * stride] (0 until a tile publishes; kFlagInc once its value
// counts every tile up to it), kLookback words read at once a step.
__device__ uint32_t look_back(const volatile uint32_t* st, int tile,
                              int stride) {
  uint32_t prefix = 0u;
  for (int j = tile - 1; j >= 0;) {
    uint32_t s[kLookback];
#pragma unroll
    for (int q = 0; q < kLookback; ++q)
      s[q] = j - q >= 0 ? st[static_cast<size_t>(j - q) * stride] : kFlagInc;
    int q = 0;
    for (; q < kLookback && s[q] != 0u; ++q) {
      prefix += s[q] & kValueMask;
      if (s[q] & kFlagInc) return prefix;
    }
    j -= q;          // q = 0: tile j has not published yet; read again
  }
  return prefix;
}

__global__ void __launch_bounds__(kTile, 1)
defer_kernel(const int32_t* __restrict__ keys,
             const uint8_t* __restrict__ valid, const int32_t* __restrict__ ts,
             int bd, int a, int d, int cap, uint32_t* scratch,
             uint8_t* __restrict__ dfr, int32_t* __restrict__ order,
             long long* __restrict__ stamps) {
  __shared__ uint32_t wcnt[kTileWarps][kDigits];  // phase 0: histograms
  __shared__ uint64_t stage[kTile];               // phase 0: counts
  __shared__ uint32_t gbase[kKeyBytes][kDigits];
  __shared__ uint32_t dstart[kDigits];
  __shared__ int32_t tbase[kDigits];
  __shared__ uint32_t pref[kMaxParts];
  __shared__ int passes[kKeyBytes];
  auto grid = cooperative_groups::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool stamping = stamps != nullptr && blockIdx.x == 0 && tid == 0;
  if (stamping) {
    stamps[0] = dt_globaltimer();
    stamps[2] = clock64();
  }
  const int tiles = defer_tiles(bd);
  uint32_t* hist = scratch;
  volatile uint32_t* status = scratch + kKeyBytes * tiles * kDigits;
  volatile uint32_t* sstat = status + kKeyBytes * tiles * kDigits;
  uint64_t* cnt8 = reinterpret_cast<uint64_t*>(
      const_cast<uint32_t*>(sstat) + 8 * tiles);
  uint64_t* buf = cnt8 + bd;                      // [2][bd]
  // -- phase 0 --
  const size_t nstat = (kKeyBytes * kDigits + 8) * static_cast<size_t>(tiles);
  for (size_t i = blockIdx.x * static_cast<size_t>(kTile) + tid; i < nstat;
       i += static_cast<size_t>(gridDim.x) * kTile)
    status[i] = 0u;
  uint32_t (*hs)[kDigits] = wcnt;                 // [4][256]
  for (int k = blockIdx.x; k < tiles; k += gridDim.x) {
    const int t0 = k * kTile;
    for (int i = tid; i < kKeyBytes * kDigits; i += kTile) hs[0][i] = 0u;
    stage[tid] = 0ull;
    __syncthreads();
    const int t = t0 + tid;
    const bool in = t < bd;
    const uint32_t key = in ? static_cast<uint32_t>(ts[t]) ^ 0x80000000u : 0u;
#pragma unroll
    for (int p = 0; p < kKeyBytes; ++p) {
      const uint32_t dg = in ? (key >> (8 * p)) & (kDigits - 1) : kNoDigit;
      const uint32_t peers = __match_any_sync(0xffffffffu, dg);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hs[p][dg], __popc(peers));
    }
    if (stamping) stamps[3] = clock64();
    // the tile's lanes, a warp 32 adjacent ones at a time (kLaneBatch
    // such chunks loaded before any is counted): a ballot an owner, and
    // the lane that starts a txn's run in the chunk adds the run's
    // counts, a byte an owner, to the txn's word.  A lane's txn and
    // place in it advance by kTile / a and kTile % a a chunk.
    const int nl = (min(bd, t0 + kTile) - t0) * a;
    const int32_t* kt = keys + static_cast<size_t>(t0) * a;
    const uint8_t* vt = valid + static_cast<size_t>(t0) * a;
    const bool pow2 = (d & (d - 1)) == 0;
    int txn = (32 * warp + lane) / a, rem = (32 * warp + lane) % a;
    const int step_t = kTile / a, step_r = kTile % a;
    for (int l0 = 32 * warp; l0 < nl; l0 += kLaneBatch * kTile) {
      int32_t kv[kLaneBatch];
      bool vv[kLaneBatch];
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        const int l = l0 + u * kTile + lane;
        vv[u] = l < nl && vt[l];
        kv[u] = l < nl ? kt[l] : 0;
      }
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        if (l0 + u * kTile >= nl) break;              // warp-uniform
        const int l = l0 + u * kTile + lane;
        const int o = !vv[u] ? -1 : pow2 ? (kv[u] & (d - 1))
                                         : owner_of(kv[u], d);
        const bool head = l < nl && (lane == 0 || rem == 0);
        const unsigned heads = __ballot_sync(0xffffffffu, head);
        // this lane's run: up to the next head (or the chunk's end)
        const unsigned later = heads & ~((2u << lane) - 1u);
        const unsigned run =
            (later ? (later & (0u - later)) - 1u : 0xFFFFFFFFu) &
            ~((1u << lane) - 1u);
        unsigned long long add = 0ull;
        for (int q = 0; q < d; ++q) {
          const unsigned m = __ballot_sync(0xffffffffu, o == q);
          add |= static_cast<unsigned long long>(__popc(m & run))
                 << (8 * q);
        }
        if (head && add)
          atomicAdd(reinterpret_cast<unsigned long long*>(&stage[txn]), add);
        txn += step_t;
        rem += step_r;
        if (rem >= a) {
          rem -= a;
          ++txn;
        }
      }
    }
    __syncthreads();
    if (tid < kDigits)
#pragma unroll
      for (int p = 0; p < kKeyBytes; ++p)
        hist[(static_cast<size_t>(p) * tiles + k) * kDigits + tid] =
            hs[p][tid];
    if (in) cnt8[t] = stage[tid];
    __syncthreads();
  }
  if (stamping) stamps[4] = clock64();
  grid.sync();
  if (stamping) stamps[5] = clock64();
  // -- phase 1: the digit bases; the bytes that need a pass --
  uint32_t tots[kKeyBytes] = {0u, 0u, 0u, 0u};
  if (tid < kDigits)
    for (int k = 0; k < tiles; ++k)
#pragma unroll
      for (int p = 0; p < kKeyBytes; ++p)
        tots[p] += hist[(static_cast<size_t>(p) * tiles + k) * kDigits + tid];
  // two bytes' digit counts a 64-bit scan (each below 2^30: no carry)
  __shared__ unsigned one_digit;          // bit p: byte p has one digit
  if (tid == 0) one_digit = 0u;
#pragma unroll
  for (int h = 0; h < kKeyBytes / 2; ++h) {
    const uint64_t v = tots[2 * h] |
                       (static_cast<uint64_t>(tots[2 * h + 1]) << 32);
    uint64_t unused;
    const uint64_t excl =
        dt_block_incl_scan(v, AddU64(), uint64_t{0}, unused) - v;
    if (tid < kDigits) {
      gbase[2 * h][tid] = static_cast<uint32_t>(excl);
      gbase[2 * h + 1][tid] = static_cast<uint32_t>(excl >> 32);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (tots[2 * h + b] == static_cast<uint32_t>(bd))
          atomicOr(&one_digit, 1u << (2 * h + b));
    }
  }
  __syncthreads();
  int np = 0;
  for (int p = 0; p < kKeyBytes; ++p)
    if (!((one_digit >> p) & 1u)) {
      if (tid == 0) passes[np] = p;
      ++np;
    }
  __syncthreads();
  if (stamping) stamps[6] = clock64();
  // -- phase 2: the radix passes --
  for (int j = 0; j < np; ++j) {
    const int p = passes[j];
    const uint64_t* in_w = buf + static_cast<size_t>((j + 1) & 1) * bd;
    uint64_t* out_w = buf + static_cast<size_t>(j & 1) * bd;
    volatile uint32_t* st_p =
        status + static_cast<size_t>(p) * tiles * kDigits;
    for (int k = blockIdx.x; k < tiles; k += gridDim.x) {
      const int idx = k * kTile + tid;
      const bool in = idx < bd;
      uint64_t w = 0ull;
      if (in)
        w = j == 0 ? (static_cast<uint64_t>(static_cast<uint32_t>(ts[idx]) ^
                                            0x80000000u) << 32) |
                         static_cast<uint32_t>(idx)
                   : in_w[idx];
      const uint32_t dg = in ? key_digit(w, p) : kNoDigit;
      for (int x = lane; x < kDigits; x += 32) wcnt[warp][x] = 0u;
      __syncwarp();
      // stable rank inside the warp: the group's highest lane bumps the
      // warp's count, a shuffle hands the old count to the group
      const uint32_t peers = __match_any_sync(0xffffffffu, dg);
      const int leader = 31 - __clz(peers);
      uint32_t before = 0u;
      if (lane == leader && in) {
        before = wcnt[warp][dg];
        wcnt[warp][dg] = before + __popc(peers);
      }
      before = __shfl_sync(peers, before, leader);
      const uint32_t rk = before + __popc(peers & ((1u << lane) - 1u));
      __syncthreads();
      uint32_t cnt = 0u;
      if (tid < kDigits)
        for (int x = 0; x < kTileWarps; ++x) {
          const uint32_t c = wcnt[x][tid];
          wcnt[x][tid] = cnt;
          cnt += c;
        }
      volatile uint32_t* my = st_p + static_cast<size_t>(k) * kDigits + tid;
      if (tid < kDigits) *my = (k == 0 ? kFlagInc : kFlagAgg) | cnt;
      uint32_t unused;
      const uint32_t start =
          dt_block_incl_scan(cnt, dt_radix::AddOp(), 0u, unused) - cnt;
      if (tid < kDigits) {
        const uint32_t prefix = look_back(st_p + tid, k, kDigits);
        if (k > 0) *my = kFlagInc | (prefix + cnt);
        dstart[tid] = start;
        tbase[tid] = static_cast<int32_t>(gbase[p][tid] + prefix) -
                     static_cast<int32_t>(start);
      }
      __syncthreads();
      if (in) stage[dstart[dg] + wcnt[warp][dg] + rk] = w;
      __syncthreads();
      const int len = min(kTile, bd - k * kTile);
      if (tid < len) {
        const uint64_t v = stage[tid];
        const int at = tbase[key_digit(v, p)] + tid;
        if (j == np - 1) order[at] = static_cast<int32_t>(v & 0xFFFFFFFFull);
        else out_w[at] = v;
      }
      __syncthreads();
    }
    if (stamping && j < 2) stamps[7 + 2 * j] = clock64();
    grid.sync();
    if (stamping && j < 2) stamps[8 + 2 * j] = clock64();
  }
  // -- phase 3: the count rows' prefixes and the test, by position --
  for (int k = blockIdx.x; k < tiles; k += gridDim.x) {
    const int pos = k * kTile + tid;
    const bool in = pos < bd;
    const int t = !in ? 0 : np > 0 ? order[pos] : pos;
    const uint64_t c = in ? cnt8[t] : 0ull;
    uint64_t incl[kMaxParts / 2], tot[kMaxParts / 2];
#pragma unroll
    for (int h = 0; h < kMaxParts / 2; ++h) {
      // owners 2h and 2h + 1 in the low and high halves
      const uint64_t v = ((c >> (16 * h)) & 0xFFull) |
                         (((c >> (16 * h + 8)) & 0xFFull) << 32);
      incl[h] = 0ull;
      tot[h] = 0ull;
      if (2 * h < d)
        incl[h] = dt_block_incl_scan(v, AddU64(), uint64_t{0}, tot[h]);
    }
    if (tid < d) {
      const uint32_t own = static_cast<uint32_t>(tot[tid >> 1] >>
                                                 (32 * (tid & 1)));
      volatile uint32_t* my = sstat + static_cast<size_t>(k) * 8 + tid;
      *my = (k == 0 ? kFlagInc : kFlagAgg) | own;
      const uint32_t prefix = look_back(sstat + tid, k, 8);
      if (k > 0) *my = kFlagInc | (prefix + own);
      pref[tid] = prefix;
    }
    __syncthreads();
    if (in) {
      bool over = false;
#pragma unroll
      for (int o = 0; o < kMaxParts; ++o) {
        const uint32_t co = static_cast<uint32_t>(c >> (8 * o)) & 0xFFu;
        if (o < d && co > 0) {
          const uint32_t at =
              static_cast<uint32_t>(incl[o >> 1] >> (32 * (o & 1)));
          over |= static_cast<long long>(pref[o]) + at > cap;
        }
      }
      dfr[t] = over;
      if (np == 0) order[pos] = pos;
    }
    __syncthreads();
  }
  if (stamping) {
    stamps[11] = clock64();
    stamps[12] = np;
    stamps[1] = dt_globaltimer();
  }
}

// The occupancy grid of defer_kernel on the current device, asked once
// per device; 0 where a query fails.
int defer_grid() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, defer_kernel,
                                                    kTile, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

// ---- K18b ------------------------------------------------------------------

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

// K18a's launch at bD txns of A lanes over D shards: out[0] the
// cooperative grid, out[1] its tiles, out[2] the uint32 words of scratch
// dt_mc_defer needs.  Launches nothing; 1 for a size it does not take
// (D outside [2, 8], A outside [1, 255], bD A >= 2^30).
DT_EXPORT int dt_mc_defer_layout(int bd, int a, int d, long long* out) {
  if (d < 2 || d > kMaxParts || bd < 1 || a < 1 || a > 255 ||
      static_cast<long long>(bd) * a >= (1LL << 30))
    return 1;
  const int fit = defer_grid();
  if (fit < 1) return 1;
  out[0] = min(fit, defer_tiles(bd));
  out[1] = defer_tiles(bd);
  out[2] = static_cast<long long>(defer_scratch_words(bd));
  return 0;
}

// K18a: keys int32 / valid bool [bd, a], ts int32 [bd] -> dfr bool [bd]
// (the txns that defer), order int32 [bd] (the txns in (ts, txn) order);
// one cooperative launch on `scratch` (scratch_len uint32 words, at least
// dt_mc_defer_layout's; nothing in it need be zeroed).  stamps (or null)
// int64 [13]: block 0's phase stamps (common.cuh): clocks at entry,
// after ts's histograms, after phase 0, its barrier and phase 1, after
// the first two passes and their barriers, and at exit, then the passes
// made.
DT_EXPORT int dt_mc_defer(const int32_t* keys, const uint8_t* valid,
                          const int32_t* ts, int bd, int a, int d, int cap,
                          uint8_t* dfr, int32_t* order, uint32_t* scratch,
                          long long scratch_len, long long* stamps,
                          void* stream) {
  long long l[3];
  if (dt_mc_defer_layout(bd, a, d, l) != 0 || cap < a || scratch_len < l[2])
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&keys, &valid,   &ts,  &bd,    &a,     &d,
                  &cap,  &scratch, &dfr, &order, &stamps};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(defer_kernel),
      dim3(static_cast<unsigned>(l[0])), dim3(kTile),
      args, 0, dt_stream(stream));
  return e != cudaSuccess ? static_cast<int>(e) : dt_status();
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
