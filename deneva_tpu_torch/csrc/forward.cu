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
// Both follow from two global inclusive max-scans of lane indices — L,
// the last write lane at or before i, and G, the head of i's group — done
// as a multi-block scan (tile aggregates, one scan of the carries, a
// per-tile scan with carry-in), then one elementwise pass that gathers
// L[G[i]-1] for fwd and, at each key's tail t, marks win[L[t]].
//   Bound: bytes (read the words, write the plan); ~5 passes over N.
#include "common.cuh"
#include "radix.cuh"

namespace {

constexpr int kScanThreads = 1024;           // one lane per thread
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

// Per-lane scan inputs: W = i if lane i writes else -1; H = i if lane i
// heads its (key, rank) group else -1.
__device__ __forceinline__ void scan_inputs(const uint64_t* words, int i,
                                            int n, int32_t& wi, int32_t& hi) {
  wi = -1;
  hi = -1;
  if (i < n) {
    const uint64_t w = words[i];
    wi = (w & 1ull) ? i : -1;
    hi = (i == 0 || (w >> 1) != (words[i - 1] >> 1)) ? i : -1;
  }
}

struct MaxOp {
  __device__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};

// Pass 1: per-tile maxima of W and H; win cleared for pass 4's scatter.
__global__ void scan_agg_kernel(const uint64_t* __restrict__ words, int n,
                                int32_t* __restrict__ agg_w,
                                int32_t* __restrict__ agg_h,
                                uint8_t* __restrict__ win) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t wi, hi;
  scan_inputs(words, i, n, wi, hi);
  if (i < n) win[i] = 0;
  const int32_t mw = dt_block_reduce(wi, MaxOp(), -1);
  const int32_t mh = dt_block_reduce(hi, MaxOp(), -1);
  if (threadIdx.x == 0) {
    agg_w[blockIdx.x] = mw;
    agg_h[blockIdx.x] = mh;
  }
}

// Pass 2 (one block): carry[b] = max of agg[0..b-1], -1 for b = 0.
__global__ void scan_carry_kernel(const int32_t* __restrict__ agg_w,
                                  const int32_t* __restrict__ agg_h, int nb,
                                  int32_t* __restrict__ carry_w,
                                  int32_t* __restrict__ carry_h) {
  __shared__ int32_t pw[1024], ph[1024];
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int beg = min(threadIdx.x * per, nb), end = min(beg + per, nb);
  int32_t mw = -1, mh = -1;
  for (int i = beg; i < end; ++i) {
    mw = max(mw, agg_w[i]);
    mh = max(mh, agg_h[i]);
  }
  pw[threadIdx.x] = mw;
  ph[threadIdx.x] = mh;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const int32_t a = threadIdx.x >= off ? pw[threadIdx.x - off] : -1;
    const int32_t b = threadIdx.x >= off ? ph[threadIdx.x - off] : -1;
    __syncthreads();
    pw[threadIdx.x] = max(pw[threadIdx.x], a);
    ph[threadIdx.x] = max(ph[threadIdx.x], b);
    __syncthreads();
  }
  int32_t rw = threadIdx.x ? pw[threadIdx.x - 1] : -1;
  int32_t rh = threadIdx.x ? ph[threadIdx.x - 1] : -1;
  for (int i = beg; i < end; ++i) {
    carry_w[i] = rw;
    carry_h[i] = rh;
    rw = max(rw, agg_w[i]);
    rh = max(rh, agg_h[i]);
  }
}

// Pass 3: L[i] = last write lane <= i, G[i] = head of i's group.
__global__ void scan_tile_kernel(const uint64_t* __restrict__ words, int n,
                                 const int32_t* __restrict__ carry_w,
                                 const int32_t* __restrict__ carry_h,
                                 int32_t* __restrict__ last_w,
                                 int32_t* __restrict__ head) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t wi, hi, unused;
  scan_inputs(words, i, n, wi, hi);
  wi = max(dt_block_incl_scan(wi, MaxOp(), -1, unused), carry_w[blockIdx.x]);
  hi = max(dt_block_incl_scan(hi, MaxOp(), -1, unused), carry_h[blockIdx.x]);
  if (i < n) {
    last_w[i] = wi;
    head[i] = hi;
  }
}

// Pass 4: unpack the plan; fwd from L[G[i]-1]; win at each key's tail.
__global__ void plan_kernel(const uint64_t* __restrict__ words, int n,
                            const int32_t* __restrict__ last_w,
                            const int32_t* __restrict__ head,
                            int32_t* __restrict__ keys,
                            int32_t* __restrict__ rank,
                            uint8_t* __restrict__ is_read,
                            uint8_t* __restrict__ is_write,
                            int32_t* __restrict__ fwd,
                            uint8_t* __restrict__ win) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t w = words[i];
  const uint32_t k = key_of(w);
  const bool wr = w & 1ull;
  keys[i] = static_cast<int32_t>(k);
  rank[i] = rank_of(w);
  is_write[i] = wr;
  is_read[i] = (k != kBigKey) && !wr;
  int32_t f = -1;
  const int32_t g = head[i];
  if (g > 0) {
    const int32_t j = last_w[g - 1];
    if (j >= 0) {
      const uint64_t wj = words[j];
      if (key_of(wj) == k) f = rank_of(wj);
    }
  }
  fwd[i] = f;
  if (i == n - 1 || key_of(words[i + 1]) != k) {
    const int32_t j = last_w[i];
    if (j >= 0 && key_of(words[j]) == k) win[j] = 1;
  }
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

// K2: plan of sorted words.  `scratch` holds 4 * ceil(N / kScanThreads)
// + 2 * N int32.
DT_EXPORT int dt_plan_scans(const uint64_t* words, int n, int32_t* keys,
                            int32_t* rank, uint8_t* is_read,
                            uint8_t* is_write, int32_t* fwd, uint8_t* win,
                            int32_t* scratch, void* stream) {
  cudaStream_t s = dt_stream(stream);
  const int nb = (n + kScanThreads - 1) / kScanThreads;
  int32_t* agg_w = scratch;
  int32_t* agg_h = agg_w + nb;
  int32_t* carry_w = agg_h + nb;
  int32_t* carry_h = carry_w + nb;
  int32_t* last_w = carry_h + nb;
  int32_t* head = last_w + n;
  scan_agg_kernel<<<nb, kScanThreads, 0, s>>>(words, n, agg_w, agg_h, win);
  scan_carry_kernel<<<1, 1024, 0, s>>>(agg_w, agg_h, nb, carry_w, carry_h);
  scan_tile_kernel<<<nb, kScanThreads, 0, s>>>(words, n, carry_w, carry_h,
                                               last_w, head);
  plan_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(words, n, last_w, head, keys,
                                                rank, is_read, is_write, fwd,
                                                win);
  return dt_status();
}
