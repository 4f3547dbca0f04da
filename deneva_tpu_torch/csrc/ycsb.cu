// K3 + K4b: YCSB's forward-execute and query generation.
//
// K3 replaces deneva_tpu/workloads/ycsb.py:78 _forward_execute_f0 (value
// law :57 _field_fingerprint, :65 _field_bytes) over a sorted ForwardPlan:
// read lanes gather F0 at their slot — a forwarded read (fwd >= 0) takes
// f(key, fwd) instead — and fold into a wrapping uint32 checksum; each
// key's final writer (win) stores f(key, rank) — only at a slot below cap:
// under part_cnt > 1 the winners of keys another partition owns carry the
// trash slot, and the trash row is never written (its gathers read the
// loader's 0).  A read with fwd < 0 must
// see the epoch-start value of a slot the same epoch's winner overwrites,
// so the gather + checksum launch completes before the winners' store
// launch runs (stream order).  Each key has exactly one winner, so the
// store is a duplicate-free direct scatter (the reference's `mono`
// cummax trick only spares XLA a sort inside its scatter).
//   Bound: bytes — the plan's 19 B/lane plus one F0 row per non-forwarded
//   read and per winner.  Fingerprint mode is one thread per lane;
//   full-row mode (uint8[rows, tup]) is one thread per 4-byte word of a
//   lane's row, so a row moves as tup/4 coalesced 32-bit accesses
//   (tup = 100 is not a multiple of 16, so 16-byte vectors do not align).
//   The checksum is integer and order-free: a block reduction plus one
//   atomicAdd per block is exact.
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
#include "common.cuh"
#include "threefry.cuh"
#include "value_law.cuh"

namespace {

struct AddOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

__device__ __forceinline__ void flush(uint32_t s, uint32_t wc,
                                      uint32_t* acc) {
  s = dt_block_reduce(s, AddOp(), 0u);
  wc = dt_block_reduce(wc, AddOp(), 0u);
  if (threadIdx.x == 0) {
    atomicAdd(&acc[0], s);
    atomicAdd(&acc[1], wc);
  }
}

__global__ void read_fp_kernel(const uint32_t* __restrict__ f0,
                               const int32_t* __restrict__ keys,
                               const uint8_t* __restrict__ is_read,
                               const uint8_t* __restrict__ is_write,
                               const int32_t* __restrict__ fwd,
                               const int32_t* __restrict__ slots, int n,
                               uint32_t* __restrict__ acc) {
  uint32_t s = 0u, wc = 0u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (is_read[i]) {
      const int32_t f = fwd[i];
      s += f >= 0 ? fp_law(static_cast<uint32_t>(keys[i]),
                           static_cast<uint32_t>(f))
                  : f0[slots[i]];
    }
    wc += is_write[i];
  }
  flush(s, wc, acc);
}

__global__ void write_fp_kernel(uint32_t* __restrict__ f0,
                                const int32_t* __restrict__ keys,
                                const int32_t* __restrict__ rank,
                                const uint8_t* __restrict__ win,
                                const int32_t* __restrict__ slots, int n,
                                int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && win[i] && slots[i] < cap)
    f0[slots[i]] = fp_law(static_cast<uint32_t>(keys[i]),
                          static_cast<uint32_t>(rank[i]));
}

__global__ void read_row_kernel(const uint8_t* __restrict__ f0, int tup,
                                const int32_t* __restrict__ keys,
                                const uint8_t* __restrict__ is_read,
                                const uint8_t* __restrict__ is_write,
                                const int32_t* __restrict__ fwd,
                                const int32_t* __restrict__ slots, int n,
                                uint32_t* __restrict__ acc) {
  const int words = tup >> 2;
  const long long total = static_cast<long long>(n) * words;
  uint32_t s = 0u, wc = 0u;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(t / words);
    const int u = static_cast<int>(t - static_cast<long long>(i) * words);
    if (u == 0) wc += is_write[i];
    if (is_read[i]) {
      const int32_t f = fwd[i];
      uint32_t x;
      if (f >= 0) {
        x = word_law(fp_law(static_cast<uint32_t>(keys[i]),
                            static_cast<uint32_t>(f)),
                     4u * static_cast<uint32_t>(u));
      } else {
        x = *reinterpret_cast<const uint32_t*>(
            f0 + static_cast<size_t>(slots[i]) * tup + 4 * u);
      }
      s += byte_sum(x);
    }
  }
  flush(s, wc, acc);
}

__global__ void write_row_kernel(uint8_t* __restrict__ f0, int tup,
                                 const int32_t* __restrict__ keys,
                                 const int32_t* __restrict__ rank,
                                 const uint8_t* __restrict__ win,
                                 const int32_t* __restrict__ slots, int n,
                                 int cap) {
  const int words = tup >> 2;
  const long long total = static_cast<long long>(n) * words;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int i = static_cast<int>(t / words);
  const int u = static_cast<int>(t - static_cast<long long>(i) * words);
  if (!win[i] || slots[i] >= cap) return;
  *reinterpret_cast<uint32_t*>(f0 + static_cast<size_t>(slots[i]) * tup +
                               4 * u) =
      word_law(fp_law(static_cast<uint32_t>(keys[i]),
                      static_cast<uint32_t>(rank[i])),
               4u * static_cast<uint32_t>(u));
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
// with tup % 4 == 0.  acc receives (checksum, write lanes).  Winners store
// only at slots < cap (the trash slot).
DT_EXPORT int dt_forward_execute(void* f0, int tup, const int32_t* keys,
                                 const int32_t* rank, const uint8_t* is_read,
                                 const uint8_t* is_write, const int32_t* fwd,
                                 const uint8_t* win, const int32_t* slots,
                                 int n, int cap, uint32_t* acc,
                                 void* stream) {
  cudaStream_t s = dt_stream(stream);
  cudaMemsetAsync(acc, 0, 2 * sizeof(uint32_t), s);
  if (tup == 0) {
    auto* tab = static_cast<uint32_t*>(f0);
    read_fp_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(tab, keys, is_read,
                                                     is_write, fwd, slots, n,
                                                     acc);
    write_fp_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(tab, keys, rank, win,
                                                      slots, n, cap);
  } else {
    auto* tab = static_cast<uint8_t*>(f0);
    const long long total = static_cast<long long>(n) * (tup >> 2);
    read_row_kernel<<<dt_blocks(total, 256), 256, 0, s>>>(
        tab, tup, keys, is_read, is_write, fwd, slots, n, acc);
    write_row_kernel<<<dt_blocks(total, 256), 256, 0, s>>>(
        tab, tup, keys, rank, win, slots, n, cap);
  }
  return dt_status();
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
