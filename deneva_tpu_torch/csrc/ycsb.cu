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
// write flags stay put).  One thread per element; the split keys are
// hashed once per block.
//   Zipf: the quantile is evaluated in float32 op by op as the reference
//   does (round-to-nearest intrinsics, so nvcc contracts nothing into an
//   FMA), except that the power is taken in float64 and rounded to
//   float32 — the plain version does the same
//   (deneva_tpu_torch/ops/sampling.py).
//   HOT: split(k1, 3) -> h1, h2, h3; a Bernoulli from h1 picks the hot or
//   the cold range, and jax.random.randint draws from h2 or h3, each split
//   again in two for its high and low words, folded by remainders in
//   wrapping uint32 (jax/_src/random.py:581 _randint).  Only the chosen
//   range is drawn: the other is a pure function never read.  No pow, so
//   the keys equal the reference's bit for bit.
//   key_order: a second launch, one thread per txn, insertion-sorts its
//   req_per_query (<= 64) keys in registers.
//   Bound: operations — up to six 20-round threefry hashes (or two and a
//   pow) per element against 5 output bytes.
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

__global__ void generate_kernel(const int64_t* __restrict__ gen_key,
                                int total, int req, int theta_zero,
                                int n_rows, float n_f, float zetan, float eta,
                                float alpha, float thresh1, int hot_max,
                                float access_perc, float p_write,
                                int write_gate, float p_txn_write,
                                int32_t* __restrict__ keys,
                                uint8_t* __restrict__ is_write) {
  // k1, k2, k3, then HOT's h1, h2a, h2b, h3a, h3b
  __shared__ uint32_t sk[16];
  if (threadIdx.x == 0) {
    const uint32_t g0 = static_cast<uint32_t>(gen_key[0]);
    const uint32_t g1 = static_cast<uint32_t>(gen_key[1]);
    for (uint32_t c = 0; c < 3; ++c) dt_split_key(g0, g1, c, sk + 2 * c);
    if (hot_max > 0) {
      uint32_t h[6];
      for (uint32_t c = 0; c < 3; ++c) dt_split_key(sk[0], sk[1], c, h + 2 * c);
      sk[6] = h[0];
      sk[7] = h[1];
      dt_split_key(h[2], h[3], 0u, sk + 8);
      dt_split_key(h[2], h[3], 1u, sk + 10);
      dt_split_key(h[4], h[5], 0u, sk + 12);
      dt_split_key(h[4], h[5], 1u, sk + 14);
    }
  }
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int32_t v;
    if (hot_max > 0) {
      const bool hot =
          dt_bits_to_uniform(dt_random_bits(sk[6], sk[7], (uint64_t)i)) <
          access_perc;
      v = hot ? dt_randint_at(sk + 8, sk + 10, i, 0, hot_max)
              : dt_randint_at(sk + 12, sk + 14, i, hot_max, n_rows);
    } else if (theta_zero) {
      const float u =
          dt_bits_to_uniform(dt_random_bits(sk[0], sk[1], (uint64_t)i));
      v = min(__float2int_rz(__fmul_rn(u, n_f)), n_rows - 1);
    } else {
      const float u =
          dt_bits_to_uniform(dt_random_bits(sk[0], sk[1], (uint64_t)i));
      const float uz = __fmul_rn(u, zetan);
      const float base = __fadd_rn(__fsub_rn(__fmul_rn(eta, u), eta), 1.0f);
      const float pw = __double2float_rn(
          pow(static_cast<double>(base), static_cast<double>(alpha)));
      const int32_t spread = __float2int_rz(__fmul_rn(n_f, pw));
      v = uz < 1.0f ? 0 : (uz < thresh1 ? 1 : spread);
      v = max(0, min(v, n_rows - 1));
    }
    keys[i] = v;
    bool w = dt_bits_to_uniform(dt_random_bits(sk[2], sk[3], (uint64_t)i)) <
             p_write;
    if (write_gate)
      w = w && dt_bits_to_uniform(dt_random_bits(
                   sk[4], sk[5], static_cast<uint64_t>(i / req))) <
                   p_txn_write;
    is_write[i] = w;
  }
}

constexpr int kMaxSortedReq = 64;

__global__ void sort_rows_kernel(int32_t* __restrict__ keys, int n, int req) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int32_t* row = keys + static_cast<size_t>(r) * req;
  int32_t k[kMaxSortedReq];
  for (int c = 0; c < req; ++c) {
    const int32_t x = row[c];
    int d = c;
    for (; d > 0 && k[d - 1] > x; --d) k[d] = k[d - 1];
    k[d] = x;
  }
  for (int c = 0; c < req; ++c) row[c] = k[c];
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

// K4b: n txns of req draws into keys int32 / is_write bool [n, req].
// hot_max > 0 selects HOT keys, else zipf; write_gate applies the per-txn
// draw; key_order sorts each row (req <= 64).
DT_EXPORT int dt_ycsb_generate(const int64_t* gen_key, int n, int req,
                               int n_rows, int theta_zero, float n_f,
                               float zetan, float eta, float alpha,
                               float thresh1, int hot_max, float access_perc,
                               float p_write, int write_gate,
                               float p_txn_write, int key_order,
                               int32_t* keys, uint8_t* is_write,
                               void* stream) {
  if (key_order && req > kMaxSortedReq)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = dt_stream(stream);
  const int total = n * req;
  generate_kernel<<<dt_blocks(total, 256), 256, 0, s>>>(
      gen_key, total, req, theta_zero, n_rows, n_f, zetan, eta, alpha,
      thresh1, hot_max, access_perc, p_write, write_gate, p_txn_write, keys,
      is_write);
  if (key_order)
    sort_rows_kernel<<<dt_blocks(n, 128), 128, 0, s>>>(keys, n, req);
  return dt_status();
}
