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
// block runs the whole loop, so the round count and the changed flag
// never leave the device: the levels live in shared memory, each thread
// owns a contiguous run of lanes, and the two exclusive segmented maxima
// of a round (seg_excl_max, :89) become plain max-scans of
// segment << 10 | level + 1 (levels are <= 256, so a running max carries
// its segment and stale segments decode to "none").
//   Bound: operations, data dependent: rounds x lanes x ~10 integer ops;
//   one SM does them, the price of keeping the loop on the device.
#include "common.cuh"
#include "radix.cuh"

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

// Exclusive block max-scan of one value per thread (-1 for thread 0).
__device__ __forceinline__ int32_t block_excl_max(int32_t v, int32_t* buf) {
  int32_t unused;
  const int32_t incl = dt_block_incl_scan(v, MaxOp(), -1, unused);
  buf[threadIdx.x] = incl;
  __syncthreads();
  const int32_t out = threadIdx.x ? buf[threadIdx.x - 1] : -1;
  __syncthreads();
  return out;
}

// meta[i] = segment << 1 | is_write for a live lane, -1 for a dead one.
// Dynamic shared memory: lv[b], nxt[b].
__global__ void __launch_bounds__(kRelaxThreads)
    relax_kernel(const uint8_t* __restrict__ head,
                 const int32_t* __restrict__ sid,
                 const uint8_t* __restrict__ sw,
                 const uint8_t* __restrict__ live, int n, int b, int rounds,
                 int max_iter, int32_t* __restrict__ meta,
                 int32_t* __restrict__ lv_out,
                 uint8_t* __restrict__ changed_out,
                 int32_t* __restrict__ iters_out) {
  extern __shared__ int32_t sm[];
  __shared__ int32_t buf[kRelaxThreads];
  int32_t* lv = sm;
  int32_t* nxt = sm + b;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * per, n);
  const int end = min(beg + per, n);

  // segment ids: the heads counted up to each lane, minus one
  int32_t cnt = 0;
  for (int i = beg; i < end; ++i) cnt += head[i];
  int32_t unused;
  int32_t seg = dt_block_incl_scan(cnt, SumOp(), 0, unused) - cnt - 1;
  for (int i = beg; i < end; ++i) {
    seg += head[i];
    meta[i] = live[i] ? (seg << 1 | (sw[i] ? 1 : 0)) : -1;
  }
  for (int j = threadIdx.x; j < b; j += blockDim.x) lv[j] = nxt[j] = 0;
  __syncthreads();

  int changed = 1;
  int iter = 0;
  while (changed && iter < max_iter) {
    // chunk maxima of seg << 10 | lv + 1 over writer and reader lanes
    int32_t mw = -1, mr = -1;
    for (int i = beg; i < end; ++i) {
      const int32_t mt = meta[i];
      if (mt < 0) continue;
      const int32_t e = (mt >> 1) << 10 | (lv[sid[i]] + 1);
      if (mt & 1)
        mw = max(mw, e);
      else
        mr = max(mr, e);
    }
    int32_t cw = block_excl_max(mw, buf);
    int32_t cr = block_excl_max(mr, buf);
    for (int i = beg; i < end; ++i) {
      const int32_t mt = meta[i];
      if (mt < 0) continue;
      const int32_t s = mt >> 1;
      const int32_t exw = (cw >> 10) == s ? (cw & 1023) - 1 : -1;
      const int32_t exr = (cr >> 10) == s ? (cr & 1023) - 1 : -1;
      int32_t cand = (mt & 1) ? max(max(exw, exr), 0)
                              : (exw >= 0 ? exw + 1 : 0);
      cand = min(cand, rounds);
      const int32_t t = sid[i];
      atomicMax(&nxt[t], cand);
      const int32_t e = s << 10 | (lv[t] + 1);
      if (mt & 1)
        cw = max(cw, e);
      else
        cr = max(cr, e);
    }
    __syncthreads();
    int diff = 0;
    for (int j = threadIdx.x; j < b; j += blockDim.x) diff |= nxt[j] != lv[j];
    changed = __syncthreads_or(diff);
    for (int j = threadIdx.x; j < b; j += blockDim.x) lv[j] = nxt[j];
    __syncthreads();
    ++iter;
  }
  for (int j = threadIdx.x; j < b; j += blockDim.x) lv_out[j] = lv[j];
  if (threadIdx.x == 0) {
    *changed_out = changed != 0;
    *iters_out = iter;
  }
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

// K16: relax the levels of b txns over n sorted lanes to a fixpoint or
// max_iter rounds; writes the levels, the last round's changed flag and
// the rounds run.  `meta` is n int32 of scratch.  rounds <= 256 and n <
// 2^21 keep seg << 10 | level + 1 inside an int32.
DT_EXPORT int dt_dgcc_relax(const uint8_t* head, const int32_t* sid,
                            const uint8_t* sw, const uint8_t* live, int n,
                            int b, int rounds, int max_iter, int32_t* meta,
                            int32_t* lv, uint8_t* changed, int32_t* iters,
                            void* stream) {
  if (rounds < 1 || rounds > 256 || n >= (1 << 21) || b < 1) return 1;
  const size_t smem = 2 * static_cast<size_t>(b) * sizeof(int32_t);
  if (smem > 200 * 1024) return 1;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(relax_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 1;
  relax_kernel<<<1, kRelaxThreads, smem, dt_stream(stream)>>>(
      head, sid, sw, live, n, b, rounds, max_iter, meta, lv, changed, iters);
  return dt_status();
}
