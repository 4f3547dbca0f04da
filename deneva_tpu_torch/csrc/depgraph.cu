// K15a + K15b + K16: DGCC's exact-key dependency graph and its waves.
//
// K15a replaces deneva_tpu/cc/depgraph.py:54 lane_sort, the 2-key
// lax.sort of the epoch's doubled lanes by (combined key as UNSIGNED 32
// bits, position) carrying the owning txn id.  Each lane packs into one
// word  key << (P + T) | pos << T | tid  (pos < 2^P, tid < 2^T, P + T <=
// 32), and the stable LSD radix sort of radix.cuh orders its bits [T, P +
// T + 32): (key, pos) ties keep their lane order, the order of the plain
// version's stable sort (DGCC's ties are one txn's duplicate lanes; the
// audit's are level-visibility reads of one key by several txns).  Where
// P + T > 32 (the audit at B = 16,384 with many levels) the wide mode
// sorts  key << 32 | pos  by its bits [0, P) and [32, 64) with the tid as
// the scatter's payload.  The key is the combined key as an unsigned
// word, so LANE_PAD = 0xFFFFFFFF sorts last (a signed compare would put
// it first and break every segment).  An optional device flag `due`
// makes every launch return at once (the audit's cadence gate).
//   Bound: bytes.  One read of the three lane arrays and one write of the
//   three sorted ones; the one-sweep sort reads the words once for its
//   histograms and once a pass, and writes them once a pass (6 passes at
//   B = 2048 for DGCC, 7 for the audit).
//
// K15b replaces :63 segment_bounds, :70 prev_writer (both scans) and the
// edge census of cc/dgcc.py:111-122: the segment heads from adjacent
// keys, the nearest preceding live writer and reader of each lane inside
// its key segment, and the count of dependency lanes.  Inside a segment
// the lanes ascend by position, so "nearest preceding writer" is the
// largest writer lane index below the lane: three global max-scans of
// lane indices (writers and readers shifted by one lane, so the scans are
// exclusive; heads inclusive) across tiles with a carry pass, as K2.
//   Bound: bytes (read the sorted lanes once, write head, pw, pr).
//
// K16 replaces cc/dgcc.py:127-154, the level relaxation to a fixpoint
// (<= 2 * dgcc_levels + 4 rounds, Jacobi: every round reads the previous
// round's levels and scatter-maxes the candidates into new ones).  One
// launch of one thread-block cluster runs the whole loop, so the round
// count and the changed flag never leave the device.  Only the lanes up
// to the last live one are split, evenly, over every thread of the
// cluster: each keeps its contiguous run as packed words (sid,
// is_write, live, segment offset) in shared memory, laid out so each
// round reads them without bank conflicts (in scratch, read coalesced,
// where they do not fit beside the levels), and the two exclusive segmented
// maxima of a round (seg_excl_max, :89) become plain max-scans of
// segment << 10 | level + 1 (levels are <= 256, so a running max carries
// its segment and stale segments decode to "none"), carried across CTAs
// through distributed shared memory; each CTA then merges its share of
// the txns' candidates over every CTA's copy of the levels.
//   Bound: operations, data dependent: rounds x live lanes x ~24 integer
//   ops; what a round costs is its barriers, three cluster-wide ones.
#include "cluster.cuh"
#include "common.cuh"
#include "radix.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kLanePad = 0xFFFFFFFFu;
constexpr int kScanThreads = 1024;
constexpr int kRelaxThreads = 1024;

struct MaxOp {
  __device__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};
struct SumOp {
  __device__ int32_t operator()(int32_t a, int32_t b) const { return a + b; }
};

// -- K15a -----------------------------------------------------------------

// wide: word = key << 32 | pos, payload = tid; else the packed word.
__global__ void lane_pack_kernel(const int64_t* __restrict__ keys,
                                 const int32_t* __restrict__ pos,
                                 const int32_t* __restrict__ tid, int n,
                                 int pos_bits, int tid_bits, int wide,
                                 const uint8_t* __restrict__ due,
                                 uint64_t* __restrict__ out,
                                 int32_t* __restrict__ pay) {
  if (due != nullptr && !*due) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t k = static_cast<uint32_t>(keys[i]);
  const uint64_t p = static_cast<uint32_t>(pos[i]);
  if (wide) {
    out[i] = k << 32 | p;
    pay[i] = tid[i];
  } else {
    out[i] = (k << (pos_bits + tid_bits)) | (p << tid_bits) |
             static_cast<uint64_t>(static_cast<uint32_t>(tid[i]));
  }
}

__global__ void lane_unpack_kernel(const uint64_t* __restrict__ words,
                                   const int32_t* __restrict__ pay, int n,
                                   int pos_bits, int tid_bits, int wide,
                                   const uint8_t* __restrict__ due,
                                   int64_t* __restrict__ sk,
                                   int32_t* __restrict__ sp,
                                   int32_t* __restrict__ sid) {
  if (due != nullptr && !*due) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t w = words[i];
  if (wide) {
    sk[i] = static_cast<int64_t>(w >> 32);
    sp[i] = static_cast<int32_t>(w & 0xFFFFFFFFull);
    sid[i] = pay[i];
  } else {
    sk[i] = static_cast<int64_t>(w >> (pos_bits + tid_bits));
    sp[i] = static_cast<int32_t>((w >> tid_bits) & ((1ull << pos_bits) - 1));
    sid[i] = static_cast<int32_t>(w & ((1ull << tid_bits) - 1));
  }
}

// -- K15b -----------------------------------------------------------------

// Scan inputs of lane i: the previous lane's index if it is a live writer
// (wp) / live reader (rp), else -1; i if it heads its key segment (h).
__device__ __forceinline__ void census_inputs(const int64_t* sk,
                                              const int32_t* sp, int i, int n,
                                              int32_t& wp, int32_t& rp,
                                              int32_t& h) {
  wp = rp = h = -1;
  if (i >= n) return;
  const int64_t k = sk[i];
  if (i == 0) {
    h = 0;
    return;
  }
  const int64_t kp = sk[i - 1];
  if (kp != k) h = i;
  if (kp != static_cast<int64_t>(kLanePad)) {
    if (sp[i - 1] & 1)
      wp = i - 1;
    else
      rp = i - 1;
  }
}

__global__ void census_agg_kernel(const int64_t* __restrict__ sk,
                                  const int32_t* __restrict__ sp, int n,
                                  int32_t* __restrict__ agg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t wp, rp, h;
  census_inputs(sk, sp, i, n, wp, rp, h);
  const int32_t mw = dt_block_reduce(wp, MaxOp(), -1);
  const int32_t mr = dt_block_reduce(rp, MaxOp(), -1);
  const int32_t mh = dt_block_reduce(h, MaxOp(), -1);
  if (threadIdx.x == 0) {
    agg[3 * blockIdx.x] = mw;
    agg[3 * blockIdx.x + 1] = mr;
    agg[3 * blockIdx.x + 2] = mh;
  }
}

// One block: carry[3 * t + c] = max of agg[c] over tiles < t (-1 for t = 0);
// zeroes the edge count before the tile pass adds to it.
__global__ void census_carry_kernel(const int32_t* __restrict__ agg, int nb,
                                    int32_t* __restrict__ carry,
                                    int32_t* __restrict__ edge_cnt) {
  __shared__ int32_t part[3][kScanThreads];
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * per, nb);
  const int end = min(beg + per, nb);
  int32_t m[3] = {-1, -1, -1};
  for (int t = beg; t < end; ++t)
    for (int c = 0; c < 3; ++c) m[c] = max(m[c], agg[3 * t + c]);
  for (int c = 0; c < 3; ++c) part[c][threadIdx.x] = m[c];
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    int32_t o[3];
    for (int c = 0; c < 3; ++c)
      o[c] = threadIdx.x >= off ? part[c][threadIdx.x - off] : -1;
    __syncthreads();
    for (int c = 0; c < 3; ++c)
      part[c][threadIdx.x] = max(part[c][threadIdx.x], o[c]);
    __syncthreads();
  }
  int32_t run[3];
  for (int c = 0; c < 3; ++c)
    run[c] = threadIdx.x ? part[c][threadIdx.x - 1] : -1;
  for (int t = beg; t < end; ++t)
    for (int c = 0; c < 3; ++c) {
      carry[3 * t + c] = run[c];
      run[c] = max(run[c], agg[3 * t + c]);
    }
  if (threadIdx.x == 0) *edge_cnt = 0;
}

__global__ void census_tile_kernel(const int64_t* __restrict__ sk,
                                   const int32_t* __restrict__ sp,
                                   const int32_t* __restrict__ sid, int n,
                                   const int32_t* __restrict__ carry,
                                   uint8_t* __restrict__ head,
                                   int32_t* __restrict__ pw,
                                   int32_t* __restrict__ pr,
                                   int32_t* __restrict__ edge_cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t wp, rp, h, unused;
  census_inputs(sk, sp, i, n, wp, rp, h);
  const int32_t* c = carry + 3 * blockIdx.x;
  wp = max(dt_block_incl_scan(wp, MaxOp(), -1, unused), c[0]);
  rp = max(dt_block_incl_scan(rp, MaxOp(), -1, unused), c[1]);
  h = max(dt_block_incl_scan(h, MaxOp(), -1, unused), c[2]);
  int32_t dep = 0;
  if (i < n) {
    // the nearest earlier writer / reader, if it lies in i's segment
    const int32_t w = wp >= h ? sid[wp] : -1;
    const int32_t r = rp >= h ? sid[rp] : -1;
    const int32_t me = sid[i];
    const bool live = sk[i] != static_cast<int64_t>(kLanePad);
    const bool sw = sp[i] & 1;
    head[i] = h == i;
    pw[i] = w;
    pr[i] = r;
    dep = live && ((w >= 0 && w != me) || (sw && r >= 0 && r != me));
  }
  const int32_t cnt = dt_block_reduce(dep, SumOp(), 0);
  if (threadIdx.x == 0 && cnt) atomicAdd(edge_cnt, cnt);
}

// -- K16 ------------------------------------------------------------------

constexpr int kSidMask = 0x7FFF;   // sid < b <= 25,600 < 2^15
constexpr int kRelaxCtas = 4;       // the cluster K16 runs in where it fits

struct RelaxOut {
  int32_t* lv;
  uint8_t* changed;
  int32_t* iters;
};

// Exclusive block max-scans of two values per thread (-1 for thread 0);
// ta / tb take the block's maxima.  wt is reused only after later
// barriers.
__device__ __forceinline__ void block_excl_max2(int32_t& a, int32_t& b,
                                                int32_t& ta, int32_t& tb,
                                                int32_t (*wt)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t ia = a, ib = b;
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t oa = __shfl_up_sync(0xffffffffu, ia, off);
    const int32_t ob = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia = max(ia, oa);
      ib = max(ib, ob);
    }
  }
  if (lane == 31) {
    wt[warp][0] = ia;
    wt[warp][1] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int32_t xa = lane < nw ? wt[lane][0] : -1;
    int32_t xb = lane < nw ? wt[lane][1] : -1;
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t oa = __shfl_up_sync(0xffffffffu, xa, off);
      const int32_t ob = __shfl_up_sync(0xffffffffu, xb, off);
      if (lane >= off) {
        xa = max(xa, oa);
        xb = max(xb, ob);
      }
    }
    wt[lane][0] = xa;
    wt[lane][1] = xb;
  }
  __syncthreads();
  int32_t ea = __shfl_up_sync(0xffffffffu, ia, 1);
  int32_t eb = __shfl_up_sync(0xffffffffu, ib, 1);
  if (lane == 0) ea = eb = -1;
  a = max(warp ? wt[warp - 1][0] : -1, ea);
  b = max(warp ? wt[warp - 1][1] : -1, eb);
  ta = wt[nw - 1][0];
  tb = wt[nw - 1][1];
}

// A lane word: sid | is_write << 15 | live << 16 | dseg << 17, dseg the
// heads counted from the thread's first lane through this one (< 2^15:
// a run holds at most 2,048 lanes), so seg = s_base + dseg.
__device__ __forceinline__ uint32_t lane_word(int32_t sid, bool w, bool live,
                                              int32_t dseg) {
  return (static_cast<uint32_t>(sid) & kSidMask) | (w ? 1u << 15 : 0u) |
         (live ? 1u << 16 : 0u) | static_cast<uint32_t>(dseg) << 17;
}

// Pass 1 of a round over one lane: its value seg << 10 | lv + 1 (-1 for
// a dead lane) into the chunk maxima; returned for pass 2.
__device__ __forceinline__ int32_t relax_max(uint32_t x, int32_t s_base,
                                             const int32_t* lv, int32_t& mw,
                                             int32_t& mr) {
  if (!((x >> 16) & 1u)) return -1;
  const int32_t e = (s_base + static_cast<int32_t>(x >> 17)) << 10 |
                    (lv[x & kSidMask] + 1);
  if ((x >> 15) & 1u)
    mw = max(mw, e);
  else
    mr = max(mr, e);
  return e;
}

// Pass 2 over one lane (e from pass 1): its candidate from the exclusive
// maxima cw / cr (a running max carries its segment; another segment's
// decodes to none), into nxt, then e into the running maxima.
__device__ __forceinline__ void relax_cand(uint32_t x, int32_t e, int rounds,
                                           int32_t* nxt, int32_t& cw,
                                           int32_t& cr) {
  if (e < 0) return;
  const int32_t s = e >> 10, l = (e & 1023) - 1;
  const bool isw = (x >> 15) & 1u;
  const int32_t exw = (cw >> 10) == s ? (cw & 1023) - 1 : -1;
  const int32_t exr = (cr >> 10) == s ? (cr & 1023) - 1 : -1;
  int32_t cand = isw ? max(max(exw, exr), 0) : (exw >= 0 ? exw + 1 : 0);
  cand = min(cand, rounds);
  if (cand > l) atomicMax(&nxt[x & kSidMask], cand);   // nxt starts at lv
  if (isw)
    cw = max(cw, e);
  else
    cr = max(cr, e);
}

// One cluster of C CTAs (C = 1: one block, block barriers only).  The
// lanes [0, n_end), n_end the last live lane + 1 (the live lanes are a
// prefix of the sorted lanes: dead lanes sort last), split evenly over
// the cluster's C x 1024 threads, each a contiguous run of at most `cap`
// packed lane words, laid out k-major (word k of thread t at k * 1024 +
// t in shared memory when kShared, else at k * C * 1024 + (global
// thread) in `meta`), so a warp's k-th words are one conflict-free or
// coalesced load; pass 1 leaves each lane's value beside its word for
// pass 2.  Each CTA holds lv and nxt of all b txns.  A round: (1) the
// run's two maxima, a block exclusive max-scan, and the block totals
// stored into every higher CTA, which folds in the lower ones' as its
// carry; (2) the candidates, atomicMax into the CTA's own nxt; (3) the
// CTA's nxt stored into every other CTA, and each CTA takes the max over
// the C copies (the same in every CTA, so the changed flag is too).
// Data between CTAs moves by remote stores counted on the receiver's
// mbarriers (cluster.cuh), with buffers and barriers paired by round
// parity.  Jacobi, as the reference.
template <int C, bool kShared>
__global__ void __launch_bounds__(kRelaxThreads, 1)
    relax_kernel(const uint8_t* __restrict__ head,
                 const int32_t* __restrict__ sid,
                 const uint8_t* __restrict__ sw,
                 const uint8_t* __restrict__ live, int n, int b, int rounds,
                 int max_iter, int cap, uint32_t* __restrict__ meta,
                 RelaxOut out) {
  extern __shared__ __align__(16) int32_t sm[];
  __shared__ int32_t wt[32][2];
  __shared__ __align__(8) uint64_t mb[6];   // lane end, heads, carry x2,
                                            // merge x2
  __shared__ int32_t xe[C], xh[C], xc[2][C][2];
  const int cr = C == 1 ? 0 : static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, T = blockDim.x;
  const int P = C * T, g = cr * T + tid;
  const int b8 = (b + 7) & ~7;
  int32_t* lv = sm;
  int32_t* nxt = sm + b8;
  // the other CTAs' nxt as 16-bit levels (<= 256): [parity][CTA][b8]
  uint16_t* recv = reinterpret_cast<uint16_t*>(sm + 2 * b8);
  const int stride = kShared ? T : P;
  uint32_t* words = kShared ? reinterpret_cast<uint32_t*>(
                                  sm + 2 * b8 + (C - 1) * b8) + tid
                            : meta + g;
  int32_t* ecache = reinterpret_cast<int32_t*>(words) +
                    static_cast<size_t>(cap) * stride;
  for (int j = tid; j < b8; j += T) lv[j] = nxt[j] = 0;
  if (C > 1) mbar_init(mb, 6);
  __syncthreads();
  if (C > 1) cluster_start();

  // the lanes' end over the cluster: CTA r takes a slice of `live`
  const int sl = (n + C - 1) / C, lo = min(cr * sl, n), hi = min(lo + sl, n);
  int32_t e = 0;
  for (int i = lo + tid; i < hi; i += T)
    if (live[i]) e = i + 1;
  e = dt_block_reduce(e, MaxOp(), 0);
  if (tid == 0) {
    xe[cr] = e;
    if (C > 1) {
      mbar_expect(mb, 4u * (C - 1));
      for (int q = 0; q < C; ++q)
        if (q != cr) st_remote(remote(&xe[cr], q), e, remote(mb, q));
    }
  }
  if (C > 1) mbar_wait(mb, 0);
  __syncthreads();
  int32_t n_end = 0;
  for (int q = 0; q < C; ++q) n_end = max(n_end, xe[q]);
  const int per = (n_end + P - 1) / P;
  const int beg = min(g * per, n_end), cnt = min(beg + per, n_end) - beg;

  // the lane words, and the segment ids by one prefix count of heads
  int32_t h = 0;
  for (int k = 0; k < cnt; ++k) {
    const int i = beg + k;
    h += head[i];
    words[static_cast<size_t>(k) * stride] = lane_word(sid[i], sw[i], live[i],
                                                       h);
  }
  int32_t tot;
  const int32_t incl = dt_block_incl_scan(h, SumOp(), 0, tot);
  int32_t carry = 0;
  if (C > 1) {
    if (tid == 0) {
      mbar_expect(mb + 1, 4u * cr);
      for (int q = cr + 1; q < C; ++q)
        st_remote(remote(&xh[cr], q), tot, remote(mb + 1, q));
    }
    mbar_wait(mb + 1, 0);
    for (int q = 0; q < cr; ++q) carry += xh[q];
  }
  const int32_t s_base = carry + incl - h - 1;

  int changed = 1, iter = 0;
  while (changed && iter < max_iter) {
    const int p = iter & 1;
    const uint32_t ph = (iter >> 1) & 1;
    int32_t mw = -1, mr = -1;
    for (int k = 0; k < cnt; ++k) {
      const size_t at = static_cast<size_t>(k) * stride;
      ecache[at] = relax_max(words[at], s_base, lv, mw, mr);
    }
    int32_t tw, tr;
    block_excl_max2(mw, mr, tw, tr, wt);
    if (C > 1) {
      if (tid == 0) {
        mbar_expect(mb + 2 + p, 8u * cr);
        for (int q = cr + 1; q < C; ++q) {
          st_remote(remote(&xc[p][cr][0], q), tw, remote(mb + 2 + p, q));
          st_remote(remote(&xc[p][cr][1], q), tr, remote(mb + 2 + p, q));
        }
      }
      mbar_wait(mb + 2 + p, ph);
      for (int q = 0; q < cr; ++q) {
        mw = max(mw, xc[p][q][0]);
        mr = max(mr, xc[p][q][1]);
      }
    }
    for (int k = 0; k < cnt; ++k) {
      const size_t at = static_cast<size_t>(k) * stride;
      relax_cand(words[at], ecache[at], rounds, nxt, mw, mr);
    }
    __syncthreads();
    if (C > 1) {
      // this CTA's nxt, eight levels to 16 bytes, into its slot of every
      // other CTA's receive buffer
      const int q8 = b8 / 8;
      if (tid == 0) mbar_expect(mb + 4 + p, 16u * q8 * (C - 1));
      for (int x = tid; x < q8 * (C - 1); x += T) {
        const int qi = x / q8, j = x % q8;
        const int q = qi < cr ? qi : qi + 1;
        const int slot = cr < q ? cr : cr - 1;
        const int32_t* v = nxt + 8 * j;
        const uint4 w = make_uint4(
            static_cast<uint32_t>(v[0]) | static_cast<uint32_t>(v[1]) << 16,
            static_cast<uint32_t>(v[2]) | static_cast<uint32_t>(v[3]) << 16,
            static_cast<uint32_t>(v[4]) | static_cast<uint32_t>(v[5]) << 16,
            static_cast<uint32_t>(v[6]) | static_cast<uint32_t>(v[7]) << 16);
        st_remote4(remote(recv + (p * (C - 1) + slot) * b8 + 8 * j, q), w,
                   remote(mb + 4 + p, q));
      }
      mbar_wait(mb + 4 + p, ph);
      __syncthreads();   // every thread has read nxt for its stores
    }
    int diff = 0;
    for (int t = tid; t < b; t += T) {
      int32_t m = nxt[t];
      for (int s2 = 0; s2 < C - 1; ++s2)
        m = max(m, static_cast<int32_t>(recv[(p * (C - 1) + s2) * b8 + t]));
      diff |= m != lv[t];
      lv[t] = m;
      nxt[t] = m;
    }
    changed = __syncthreads_or(diff);
    ++iter;
  }
  const int bc = (b + C - 1) / C, t0 = min(cr * bc, b), t1 = min(t0 + bc, b);
  for (int t = t0 + tid; t < t1; t += T) out.lv[t] = lv[t];
  if (cr == 0 && tid == 0) {
    *out.changed = changed != 0;
    *out.iters = iter;
  }
}

// Where a cluster of C CTAs keeps its data: the levels, nxt and the
// 16-bit receive buffers in shared memory, and the lane words and their
// values (a run of at most `cap` = ceil(n / (C x 1024)) lanes a thread)
// beside them where they fit, else in `scratch` words of global memory.
// Both instantiations' static shared memory counts against the card's
// per-block limit.  False where the levels do not fit.
struct RelaxLayout {
  int ctas, shared, cap;
  size_t smem;
  long long scratch;
};

template <int C>
bool relax_layout(int n, int b, RelaxLayout& l) {
  const size_t b8 = (static_cast<size_t>(b) + 7) & ~static_cast<size_t>(7);
  const size_t levels = (C + 1) * b8 * sizeof(int32_t);
  const int cap = (n + C * kRelaxThreads - 1) / (C * kRelaxThreads);
  const size_t lanes = 2 * static_cast<size_t>(cap) * kRelaxThreads *
                       sizeof(uint32_t);
  if (levels > dt_smem_room(relax_kernel<C, false>)) return false;
  const bool shared = levels + lanes <= dt_smem_room(relax_kernel<C, true>);
  l = {C, shared, cap, shared ? levels + lanes : levels,
       shared ? 0 : 2LL * cap * C * kRelaxThreads};
  return true;
}

// The largest cluster of at most `max_ctas` (1, 2, 4 or 8; 0 for
// kRelaxCtas) CTAs whose levels fit; a cluster of one fits every b <=
// 25,600.  False where none does.
bool choose_relax(int n, int b, int max_ctas, RelaxLayout& l) {
  const int top = max_ctas == 0 ? kRelaxCtas : max_ctas;
  return (top >= 8 && relax_layout<8>(n, b, l)) ||
         (top >= 4 && relax_layout<4>(n, b, l)) ||
         (top >= 2 && relax_layout<2>(n, b, l)) || relax_layout<1>(n, b, l);
}

template <int C, bool kShared>
int launch_relax_as(const uint8_t* head, const int32_t* sid,
                    const uint8_t* sw, const uint8_t* live, int n, int b,
                    int rounds, int max_iter, uint32_t* meta, RelaxOut out,
                    const RelaxLayout& l, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      relax_kernel<C, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kRelaxThreads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, relax_kernel<C, kShared>, head, sid, sw, live,
                           n, b, rounds, max_iter, l.cap, meta, out);
  return static_cast<int>(err);
}

template <int C>
int launch_relax(const uint8_t* head, const int32_t* sid, const uint8_t* sw,
                 const uint8_t* live, int n, int b, int rounds, int max_iter,
                 uint32_t* meta, RelaxOut out, const RelaxLayout& l,
                 cudaStream_t s) {
  return l.shared ? launch_relax_as<C, true>(head, sid, sw, live, n, b,
                                             rounds, max_iter, meta, out, l, s)
                  : launch_relax_as<C, false>(head, sid, sw, live, n, b,
                                              rounds, max_iter, meta, out, l,
                                              s);
}

bool relax_sizes_ok(int n, int b, int max_ctas) {
  return n >= 0 && n < (1 << 21) && b >= 1 && b <= 25600 &&
         (max_ctas == 0 || max_ctas == 1 || max_ctas == 2 || max_ctas == 4 ||
          max_ctas == 8);
}

}  // namespace

// K15a: sort n lanes (keys int64 in [0, 2^32), pos < 2^pos_bits <= 2^31,
// tid < 2^tid_bits) by (key, pos), ties in lane order.  Packed when
// pos_bits + tid_bits <= 32, else `wide` (pay / pay_tmp: n int32 each);
// `words` and `tmp` are n-word scratch, `counts` the sort's scratch
// (radix.cuh sort_pairs_bits); `due` may be null.
DT_EXPORT int dt_lane_sort(const int64_t* keys, const int32_t* pos,
                           const int32_t* tid, int n, int pos_bits,
                           int tid_bits, int wide, const uint8_t* due,
                           uint64_t* words, uint64_t* tmp, int32_t* pay,
                           int32_t* pay_tmp, uint32_t* counts, int64_t* sk,
                           int32_t* sp, int32_t* sid, void* stream) {
  if (pos_bits < 1 || pos_bits > 31 || tid_bits < 1) return 1;
  if (!wide && pos_bits + tid_bits > 32) return 1;
  cudaStream_t s = dt_stream(stream);
  lane_pack_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(
      keys, pos, tid, n, pos_bits, tid_bits, wide, due, words, pay);
  uint64_t* a = words;
  uint64_t* b = tmp;
  int32_t* pa = wide ? pay : nullptr;
  int32_t* pb = wide ? pay_tmp : nullptr;
  if (wide) {
    dt_radix::sort_pairs_bits(a, b, pa, pb, n, 0, pos_bits, counts, s, due);
    dt_radix::sort_pairs_bits(a, b, pa, pb, n, 32, 64, counts, s, due);
  } else {
    dt_radix::sort_pairs_bits(a, b, pa, pb, n, tid_bits,
                              pos_bits + tid_bits + 32, counts, s, due);
  }
  lane_unpack_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(
      a, pa, n, pos_bits, tid_bits, wide, due, sk, sp, sid);
  return dt_status();
}

// K15b: census of sorted lanes.  `scratch` holds 6 * ceil(n / 1024) int32.
DT_EXPORT int dt_seg_scans(const int64_t* sk, const int32_t* sp,
                           const int32_t* sid, int n, uint8_t* head,
                           int32_t* pw, int32_t* pr, int32_t* edge_cnt,
                           int32_t* scratch, void* stream) {
  cudaStream_t s = dt_stream(stream);
  const int nb = (n + kScanThreads - 1) / kScanThreads;
  int32_t* agg = scratch;
  int32_t* carry = scratch + 3 * nb;
  census_agg_kernel<<<nb, kScanThreads, 0, s>>>(sk, sp, n, agg);
  census_carry_kernel<<<1, kScanThreads, 0, s>>>(agg, nb, carry, edge_cnt);
  census_tile_kernel<<<nb, kScanThreads, 0, s>>>(sk, sp, sid, n, carry, head,
                                                 pw, pr, edge_cnt);
  return dt_status();
}

// K16's layout for n lanes and b txns in a cluster of at most `max_ctas`
// (0: the library's choice; 1, 2, 4 or 8) CTAs: out[0] the cluster's
// CTAs, out[1] 1 where the lane words sit in shared memory, out[2] the
// int32 words of scratch dt_dgcc_relax needs.  Launches nothing.
DT_EXPORT int dt_dgcc_relax_layout(int n, int b, int max_ctas,
                                   long long* out) {
  RelaxLayout l;
  if (!relax_sizes_ok(n, b, max_ctas) || !choose_relax(n, b, max_ctas, l))
    return 1;
  out[0] = l.ctas;
  out[1] = l.shared;
  out[2] = l.scratch;
  return 0;
}

// K16: relax the levels of b txns over n sorted lanes to a fixpoint or
// max_iter rounds in one launch of the cluster dt_dgcc_relax_layout
// chooses; writes the levels, the last round's changed flag and the
// rounds run.  `meta` is `meta_len` int32 words of scratch (at least
// what the layout reports; a shorter one is refused before any launch).
// rounds <= 256 and n < 2^21 keep seg << 10 | level + 1 inside an int32;
// b <= 25,600 keeps lv and nxt in shared memory and a sid in 15 bits.  A
// cluster launch the card refuses returns its error.
DT_EXPORT int dt_dgcc_relax(const uint8_t* head, const int32_t* sid,
                            const uint8_t* sw, const uint8_t* live, int n,
                            int b, int rounds, int max_iter, int max_ctas,
                            uint32_t* meta, long long meta_len, int32_t* lv,
                            uint8_t* changed, int32_t* iters, void* stream) {
  RelaxLayout l;
  if (rounds < 1 || rounds > 256 || !relax_sizes_ok(n, b, max_ctas) ||
      !choose_relax(n, b, max_ctas, l) || meta_len < l.scratch)
    return 1;
  const RelaxOut out = {lv, changed, iters};
  const cudaStream_t s = dt_stream(stream);
  switch (l.ctas) {
    case 1:
      return launch_relax<1>(head, sid, sw, live, n, b, rounds, max_iter,
                             meta, out, l, s);
    case 2:
      return launch_relax<2>(head, sid, sw, live, n, b, rounds, max_iter,
                             meta, out, l, s);
    case 4:
      return launch_relax<4>(head, sid, sw, live, n, b, rounds, max_iter,
                             meta, out, l, s);
    default:
      return launch_relax<8>(head, sid, sw, live, n, b, rounds, max_iter,
                             meta, out, l, s);
  }
}
