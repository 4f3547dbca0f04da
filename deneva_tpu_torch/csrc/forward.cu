// K1 + K2: the sorted forwarding plan of one epoch.
//
// K1 replaces the 2-key `lax.sort` of deneva_tpu/ops/forward.py:243
// forward_plan_flat (:258-264): N = B*A lanes sorted by (key, rank),
// carrying the write flag.  Each lane packs into one 63-bit word
//   key << 32 | rank << 1 | is_write        (key, rank in [0, 2^31))
// whose ascending order refines (key, rank); ties are one txn's lanes on
// one key, whose order the reference leaves open.  The one-sweep LSD
// radix sort of radix.cuh orders the words (8 passes of 8 bits).
//   Bound: bytes.  The histogram reads the words once and each pass reads
//   and writes them once, so the sort moves ~17x the 8N-byte array where
//   the bound is one read of the lanes and one write of the words; a pass
//   whose digits are all equal (the key's high bytes on a table below
//   2^24) is a straight copy.  10 launches and the pack; 2048-lane tiles
//   give 320 blocks to the 132 SMs at N = 655,360.
//
// K2 replaces the Kogge-Stone segmented scans of forward_plan_flat
// (:191 _seg_scan, :220 seg_first, :266-288).  Inside a key segment the
// ranks ascend, so
//   fwd[i] = rank of the last write lane before i's (key, rank) group,
//            if that lane has i's key, else -1;
//   win[j] = j is the last write lane of its key segment.
// One cooperative launch (plan_kernel) of the occupancy grid: block b
// owns a run of lanes (at least 1,024, in tiles of up to 8,192 staged in
// shared memory, each warp a contiguous share of a tile in items of 32
// lanes, as few as cover it), and finds within it,
// by ballots, L (the last write lane before each lane) and G (each
// lane's group head).  What a run hands the lanes after it is small: its
// last write (lane, key, rank) and the fwd of its last group, which is a
// constant, or "the last write before the run, if it has the group's
// key" (the group's head has no write before it in the run), or, with no
// head in the run, the fwd handed in.  These summaries compose, so each
// block stores its run's once (and the four fields a lane's word gives
// alone), one grid barrier, and each block composes the summaries of the
// blocks before it into its prefix (a warp's shuffles), then writes its
// lanes' fwd and win.  Every field is written once.  win needs no
// memset: every write lane q decides the byte of the write before it,
// win[L(q - 1)] = (its key differs from q's), and the lane N - 1 sets the
// last write's; other lanes write their own 0.  So each byte is written
// once, by one thread, wherever the segment ends.  The words are read
// once (and one word before each tile); no N-sized scratch.
//   Bound: bytes (read the words, write the plan: 23 B a lane).
#include <cooperative_groups.h>

#include "common.cuh"
#include "radix.cuh"

namespace {

constexpr uint32_t kBigKey = 0x7FFFFFFFu;

__global__ void pack_kernel(const int32_t* __restrict__ k,
                            const int32_t* __restrict__ r,
                            const uint8_t* __restrict__ w, int n,
                            uint64_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (static_cast<uint64_t>(static_cast<uint32_t>(k[i])) << 32) |
           (static_cast<uint64_t>(static_cast<uint32_t>(r[i])) << 1) |
           static_cast<uint64_t>(w[i] != 0);
}

__device__ __forceinline__ uint32_t key_of(uint64_t w) {
  return static_cast<uint32_t>(w >> 32);
}
__device__ __forceinline__ int32_t rank_of(uint64_t w) {
  return static_cast<int32_t>((w >> 1) & 0x7FFFFFFFu);
}

constexpr int kPlanThreads = 1024;
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kPlanItems = 8;                        // lanes a thread, at most
constexpr int kPlanTile = kPlanThreads * kPlanItems; // lanes staged at once
constexpr int kPlanMinRun = 1024;                    // lanes a block at least
constexpr int kPlanMaxBlocks = 1024;
constexpr int kRunWords = 8;                         // a summary's int32s

// What a run of lanes hands the lanes after it: its last write lane lw
// (-1: none) with that lane's key and rank, and the fwd of its last
// group: `val` (kConst), "lrank of the last write before the run when
// its key is `val`, else -1" (kFromLw: the group's head has no write
// before it in the run), or the fwd handed in (kPass: no head in the run).
enum { kConst = 0, kFromLw = 1, kPass = 2 };
struct Run {
  int lw;
  uint32_t lkey;
  int lrank, kind, val;
};

__device__ __forceinline__ Run identity_run() { return {-1, 0u, 0, kPass, 0}; }

// The run a followed by the run b.
__device__ __forceinline__ Run compose(const Run& a, const Run& b) {
  Run c = b.lw >= 0 ? b : a;
  if (b.kind == kConst) {
    c.kind = kConst;
    c.val = b.val;
  } else if (b.kind == kPass) {
    c.kind = a.kind;
    c.val = a.val;
  } else if (a.lw >= 0) {
    c.kind = kConst;
    c.val = a.lkey == static_cast<uint32_t>(b.val) ? a.lrank : -1;
  } else {
    c.kind = kFromLw;
    c.val = b.val;
  }
  return c;
}

// A run that starts at lane 0 as a prefix: no write before it, so a
// group that depends on one has fwd -1.
__device__ __forceinline__ Run as_prefix(Run a) {
  if (a.kind != kConst) {
    a.kind = kConst;
    a.val = -1;
  }
  return a;
}

__device__ __forceinline__ Run shfl_down_run(const Run& r, int off) {
  Run o;
  o.lw = __shfl_down_sync(0xffffffffu, r.lw, off);
  o.lkey = __shfl_down_sync(0xffffffffu, r.lkey, off);
  o.lrank = __shfl_down_sync(0xffffffffu, r.lrank, off);
  o.kind = __shfl_down_sync(0xffffffffu, r.kind, off);
  o.val = __shfl_down_sync(0xffffffffu, r.val, off);
  return o;
}

// The composition of a warp's 32 runs in lane order, in lane 0.
__device__ __forceinline__ Run warp_compose(Run r) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const Run o = shfl_down_run(r, off);
    if (lane + off < 32) r = compose(r, o);
  }
  return r;
}

__device__ __forceinline__ int last_bit(uint32_t m) { return 31 - __clz(m); }

// Shared state of the tile being scanned.
struct PlanShared {
  uint32_t wm[kPlanWarps][kPlanItems];   // write lanes of each item, by ballot
  uint32_t hm[kPlanWarps][kPlanItems];   // group heads
  int span;                              // a warp's lanes: 32 items
  int wcarry[kPlanWarps];                // last write before the warp, -1
  int wlast[kPlanWarps], hlast[kPlanWarps];
  Run part[kPlanWarps];
  Run prefix;
  uint64_t prev;                         // the word before the tile
};

// The last write before local lane li of the tile, -1 where none (the
// masks and the warps' carries of `tile_front`).
__device__ int last_write_before(const PlanShared& sh, int li) {
  const int w = li / sh.span, u = (li % sh.span) >> 5;
  const int l = li & 31;
  uint32_t m = sh.wm[w][u] & ((1u << l) - 1u);
  if (m) return w * sh.span + 32 * u + last_bit(m);
  for (int v = u - 1; v >= 0; --v)
    if (sh.wm[w][v]) return w * sh.span + 32 * v + last_bit(sh.wm[w][v]);
  return sh.wcarry[w];
}

// The four fields a lane's word gives alone, at lane i.
struct Unpacked {
  int32_t* keys;
  int32_t* rank;
  uint8_t* is_read;
  uint8_t* is_write;
};

// Stage the tile [s, s + len) into sw, ballot each item's writes and
// heads, scan the warps' last writes; returns the tile's run (in every
// thread).  With `out` (or null) also writes each lane's keys, rank,
// is_read and is_write.  Ends synchronised.
__device__ Run tile_front(const uint64_t* __restrict__ words, int s, int len,
                          uint64_t* sw, PlanShared& sh, const Unpacked* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < len; e += kPlanThreads) sw[e] = words[s + e];
  // items a warp: as few as the tile allows, so that every warp works
  const int items = (len + kPlanThreads - 1) / kPlanThreads;
  const int span = 32 * items;
  if (tid == 0) {
    sh.prev = s > 0 ? words[s - 1] : 0ull;
    sh.span = span;
  }
  __syncthreads();
  int wl = -1, hl = -1;
  for (int u = 0; u < items; ++u) {
    const int li = warp * span + 32 * u + lane;
    bool x = false, h = false;
    if (li < len) {
      const uint64_t w = sw[li];
      const uint64_t pw = li > 0 ? sw[li - 1] : sh.prev;
      x = w & 1ull;
      h = s + li == 0 || (w >> 1) != (pw >> 1);
      if (out != nullptr) {
        const uint32_t k = key_of(w);
        out->keys[s + li] = static_cast<int32_t>(k);
        out->rank[s + li] = rank_of(w);
        out->is_write[s + li] = x;
        out->is_read[s + li] = k != kBigKey && !x;
      }
    }
    const uint32_t wm = __ballot_sync(0xffffffffu, x);
    const uint32_t hm = __ballot_sync(0xffffffffu, h);
    if (lane == 0) {
      sh.wm[warp][u] = wm;
      sh.hm[warp][u] = hm;
    }
    if (wm) wl = warp * span + 32 * u + last_bit(wm);
    if (hm) hl = warp * span + 32 * u + last_bit(hm);
  }
  if (lane == 0) {
    sh.wlast[warp] = wl;
    sh.hlast[warp] = hl;
  }
  __syncthreads();
  if (warp == 0) {
    // lane k: warp k's last write; the last one before each warp
    const int v = sh.wlast[lane];
    const uint32_t has = __ballot_sync(0xffffffffu, v >= 0);
    const uint32_t before = has & ((1u << lane) - 1u);
    const int got = __shfl_sync(0xffffffffu, v, before ? last_bit(before) : 0);
    sh.wcarry[lane] = before ? got : -1;
    const int tlw = __shfl_sync(0xffffffffu, v, has ? last_bit(has) : 0);
    const int hv = sh.hlast[lane];
    const uint32_t hh = __ballot_sync(0xffffffffu, hv >= 0);
    const int tlh = __shfl_sync(0xffffffffu, hv, hh ? last_bit(hh) : 0);
    __syncwarp();
    if (lane == 0) {
      Run r = identity_run();
      if (has) {
        r.lw = s + tlw;
        r.lkey = key_of(sw[tlw]);
        r.lrank = rank_of(sw[tlw]);
      }
      if (hh) {
        const int e = last_write_before(sh, tlh);
        const uint32_t k = key_of(sw[tlh]);
        if (e >= 0) {
          r.kind = kConst;
          r.val = key_of(sw[e]) == k ? rank_of(sw[e]) : -1;
        } else {
          r.kind = kFromLw;
          r.val = static_cast<int>(k);
        }
      }
      sh.part[0] = r;
    }
  }
  __syncthreads();
  const Run r = sh.part[0];
  __syncthreads();
  return r;
}

// fwd and win of the tile `tile_front` staged, after the lanes whose run
// is `pre` (a prefix: kConst); win's bytes as the header says.
__device__ void tile_back(const Run& pre, int s, int len, int n,
                          const uint64_t* sw, PlanShared& sh,
                          int32_t* __restrict__ fwd,
                          uint8_t* __restrict__ win) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // fwd of a group whose head is local lane g, with its key k
  auto head_fwd = [&](int g, uint32_t k) -> int {
    const int e = last_write_before(sh, g);
    if (e >= 0) return key_of(sw[e]) == k ? rank_of(sw[e]) : -1;
    return pre.lw >= 0 && pre.lkey == k ? pre.lrank : -1;
  };
  // each warp: the fwd of its last group that starts in it
  if (lane == 0) {
    const int g = sh.hlast[warp];
    sh.part[warp].val = g >= 0 ? head_fwd(g, key_of(sw[g])) : 0;
  }
  __syncthreads();
  // the fwd handed to this warp: the last earlier warp's with a head,
  // else the prefix's
  const int hv = sh.hlast[lane];
  const uint32_t before =
      __ballot_sync(0xffffffffu, hv >= 0) & ((1u << warp) - 1u);
  int ch = before ? sh.part[last_bit(before)].val : pre.val;
  int cw = sh.wcarry[warp];
  for (int u = 0; u < sh.span / 32; ++u) {
    const int base = warp * sh.span + 32 * u;
    const int li = base + lane, i = s + li;
    const bool valid = li < len;
    const uint32_t wm = sh.wm[warp][u], hm = sh.hm[warp][u];
    const uint64_t w = valid ? sw[li] : 0ull;
    const uint32_t k = key_of(w);
    const bool x = (wm >> lane) & 1u;
    const uint32_t below = wm & ((1u << lane) - 1u);
    const int e = below ? base + last_bit(below) : cw;   // L(i - 1), local
    int hf = 0;
    if ((hm >> lane) & 1u) {
      if (e >= 0) hf = key_of(sw[e]) == k ? rank_of(sw[e]) : -1;
      else hf = pre.lw >= 0 && pre.lkey == k ? pre.lrank : -1;
    }
    const uint32_t upto = hm & (lane == 31 ? 0xffffffffu : (2u << lane) - 1u);
    const int from = __shfl_sync(0xffffffffu, hf, upto ? last_bit(upto) : 0);
    const int f = upto ? from : ch;
    const int last = __shfl_sync(0xffffffffu, hf, hm ? last_bit(hm) : 0);
    if (hm) ch = last;
    if (wm) cw = base + last_bit(wm);
    if (!valid) continue;
    fwd[i] = f;
    if (!x) {
      win[i] = 0;
    } else {
      // q = i decides the write before it
      const int p = e >= 0 ? s + e : pre.lw;
      const uint32_t pk = e >= 0 ? key_of(sw[e]) : pre.lkey;
      if (p >= 0) win[p] = pk != k;
    }
    if (i == n - 1) {
      const int lw = x ? i : (e >= 0 ? s + e : pre.lw);
      if (lw >= 0) win[lw] = 1;
    }
  }
  __syncthreads();
}

// K2: block b owns lanes [b run, min(n, (b + 1) run)), in tiles of
// kPlanTile.  Phase 1: keys, rank, is_read and is_write, and its run's
// summary into runs[b]; the grid barrier; phase 2: the prefix from
// runs[0, b), then each tile's fwd and win (a block of one tile keeps it
// staged across the barrier).
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const uint64_t* __restrict__ words, int n, int run,
            int32_t* __restrict__ runs, int32_t* __restrict__ keys,
            int32_t* __restrict__ rank, uint8_t* __restrict__ is_read,
            uint8_t* __restrict__ is_write, int32_t* __restrict__ fwd,
            uint8_t* __restrict__ win) {
  extern __shared__ uint64_t sw[];
  __shared__ PlanShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int s0 = b * run, e0 = min(n, s0 + run);
  const int tiles = (e0 - s0 + kPlanTile - 1) / kPlanTile;
  // the fields a lane's word gives alone go out before the barrier
  const Unpacked out = {keys, rank, is_read, is_write};
  Run mine = identity_run();
  for (int t = 0; t < tiles; ++t) {
    const int s = s0 + t * kPlanTile;
    mine = compose(mine, tile_front(words, s, min(kPlanTile, e0 - s), sw, sh,
                                    &out));
  }
  if (tid == 0) {
    int32_t* o = runs + static_cast<size_t>(b) * kRunWords;
    o[0] = mine.lw;
    o[1] = static_cast<int32_t>(mine.lkey);
    o[2] = mine.lrank;
    o[3] = mine.kind;
    o[4] = mine.val;
  }
  cooperative_groups::this_grid().sync();
  // the prefix: thread c reads block c's summary (c < b), past L1
  Run r = identity_run();
  if (tid < b) {
    const int32_t* o = runs + static_cast<size_t>(tid) * kRunWords;
    r = {__ldcg(o), static_cast<uint32_t>(__ldcg(o + 1)), __ldcg(o + 2),
         __ldcg(o + 3), __ldcg(o + 4)};
  }
  r = warp_compose(r);
  if (lane == 0) sh.part[warp] = r;
  __syncthreads();
  if (warp == 0) {
    r = warp_compose(sh.part[lane]);
    if (lane == 0) sh.prefix = as_prefix(r);
  }
  __syncthreads();
  Run pre = sh.prefix;
  for (int t = 0; t < tiles; ++t) {
    const int s = s0 + t * kPlanTile;
    const int len = min(kPlanTile, e0 - s);
    const Run own =
        tiles == 1 ? mine : tile_front(words, s, len, sw, sh, nullptr);
    tile_back(pre, s, len, n, sw, sh, fwd, win);
    pre = as_prefix(compose(pre, own));
  }
}

// K2's grid: the blocks of plan_kernel the card holds at once (blocks
// per SM x SMs), asked once per device; 0 where a query fails.
int plan_grid() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaFuncSetAttribute(plan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kPlanTile * 8) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, plan_kernel, kPlanThreads, kPlanTile * 8) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

// Lanes a block at n lanes with room for `room` blocks' summaries: at
// least kPlanMinRun, a multiple of 4, few enough blocks for the grid.
bool plan_layout(int n, long long room, int* blocks, int* run) {
  const long long fit = plan_grid() < kPlanMaxBlocks ? plan_grid()
                                                     : kPlanMaxBlocks;
  const long long cap = fit < room ? fit : room;
  if (n < 1 || cap < 1) return false;
  long long r = ((n + cap - 1) / cap + 3) & ~3LL;
  if (r < kPlanMinRun) r = kPlanMinRun;
  *run = static_cast<int>(r);
  *blocks = static_cast<int>((n + r - 1) / r);
  return true;
}

}  // namespace

// K1: sort lanes (k, r, w) into ascending words `out`; `tmp` is an N-word
// scratch, `counts` the sort's scratch (radix.cuh sort_pairs_bits).
DT_EXPORT int dt_sort_lanes(const int32_t* k, const int32_t* r,
                            const uint8_t* w, int n, uint64_t* out,
                            uint64_t* tmp, uint32_t* counts, void* stream) {
  cudaStream_t s = dt_stream(stream);
  pack_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(k, r, w, n, out);
  // 8 passes: the sorted words are back in `out`
  dt_radix::sort_bits(out, tmp, n, 0, 64, counts, s);
  return dt_status();
}

// K2's layout at n lanes: out[0] the blocks, out[1] the lanes a block
// owns (the last owns the rest), out[2] the int32 words of scratch
// dt_plan_scans needs.  Launches nothing.
DT_EXPORT int dt_plan_scans_layout(int n, long long* out) {
  int blocks, run;
  if (!plan_layout(n, kPlanMaxBlocks, &blocks, &run)) return 1;
  out[0] = blocks;
  out[1] = run;
  out[2] = static_cast<long long>(blocks) * kRunWords;
  return 0;
}

// K2: the plan of n sorted words, one cooperative launch.  `scratch`
// (scratch_len int32 words, kRunWords a block) holds the blocks' run
// summaries; the grid takes at most scratch_len / kRunWords blocks.
DT_EXPORT int dt_plan_scans(const uint64_t* words, int n, int32_t* keys,
                            int32_t* rank, uint8_t* is_read,
                            uint8_t* is_write, int32_t* fwd, uint8_t* win,
                            int32_t* scratch, long long scratch_len,
                            void* stream) {
  if (n == 0) return 0;
  int blocks, run;
  if (n < 0 || !plan_layout(n, scratch_len / kRunWords, &blocks, &run))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&words, &n,  &run,      &scratch, &keys,
                  &rank,  &is_read, &is_write, &fwd,     &win};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(plan_kernel), dim3(blocks),
      dim3(kPlanThreads), args, kPlanTile * 8, dt_stream(stream));
  return e != cudaSuccess ? static_cast<int>(e) : dt_status();
}
