// A stand-alone probe of where K13b's and K4b's time went before slice
// 17, built as its own shared library and driven by `chip_smoke.py
// --slice17` on real inputs (not part of the kernel library).
//
// K13b as it was: four stream operations a call — a memset of the two
// k-bucket histograms, a memset of the P counts, the histogram pass (a
// lane's bucket to an N-sized scratch, one atomic per warp-group and
// histogram) and the verdict pass (each lane walks its row's buckets
// again).  `k17p_density` runs any subset of the four, by a bit each.
//
// K4b as it was: one thread per draw over dt_blocks(total, 256) blocks,
// thread 0 of every block hashing the split keys in series, then (under
// key_order) a second launch that insertion-sorts each row in local
// memory.  `k17p_generate` runs the whole of it or one piece: an empty
// launch of the same grid, the prologue alone, the hashes without the
// zipf power, the power alone (on uniforms made from the index by a
// multiply, no hash), or the row sort alone.  A piece stores what it
// computes, so the compiler keeps its work.  Zipf-only copies of the
// whole kernel, its prologue and its hashes without the power are
// compiled (not launched) for their SASS: a draw's instructions by pipe.
#include <cmath>

#include "common.cuh"
#include "hashing.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// -- K13b, the slice-8 kernel ---------------------------------------------

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

// -- K4b, the slice-4 kernel and its pieces --------------------------------

enum GenPiece : int {
  kWhole = 0,      // the kernel as it was
  kEmpty = 1,      // an empty launch of the same grid
  kPrologue = 2,   // thread 0's split keys and the barrier only
  kNoPow = 3,      // every hash, the zipf power replaced by its base
  kPowOnly = 4,    // the zipf power alone, on uniforms made without a hash
};

// kZipfOnly compiles the zipf branch alone, for the SASS counts of a
// draw (the timed kernel keeps the runtime branches it had).
template <int kPiece, bool kZipfOnly>
__global__ void generate_kernel(const int64_t* __restrict__ gen_key,
                                int total, int req, int theta_zero,
                                int n_rows, float n_f, float zetan, float eta,
                                float alpha, float thresh1, int hot_max,
                                float access_perc, float p_write,
                                int write_gate, float p_txn_write,
                                int32_t* __restrict__ keys,
                                uint8_t* __restrict__ is_write) {
  if (kPiece == kEmpty) return;
  __shared__ uint32_t sk[16];
  if (kPiece != kPowOnly) {
    if (threadIdx.x == 0) {
      const uint32_t g0 = static_cast<uint32_t>(gen_key[0]);
      const uint32_t g1 = static_cast<uint32_t>(gen_key[1]);
      for (uint32_t c = 0; c < 3; ++c) dt_split_key(g0, g1, c, sk + 2 * c);
      if (!kZipfOnly && hot_max > 0) {
        uint32_t h[6];
        for (uint32_t c = 0; c < 3; ++c)
          dt_split_key(sk[0], sk[1], c, h + 2 * c);
        sk[6] = h[0];
        sk[7] = h[1];
        dt_split_key(h[2], h[3], 0u, sk + 8);
        dt_split_key(h[2], h[3], 1u, sk + 10);
        dt_split_key(h[4], h[5], 0u, sk + 12);
        dt_split_key(h[4], h[5], 1u, sk + 14);
      }
    }
    __syncthreads();
  }
  if (kPiece == kPrologue) {
    if (threadIdx.x == 0) {
      uint32_t x = 0u;
      for (int c = 0; c < 16; ++c) x ^= sk[c];
      keys[blockIdx.x % total] = static_cast<int32_t>(x);
    }
    return;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int32_t v;
    if (kPiece == kPowOnly) {
      const float u = dt_bits_to_uniform(static_cast<uint32_t>(i) *
                                         2654435761u);
      const float base = __fadd_rn(__fsub_rn(__fmul_rn(eta, u), eta), 1.0f);
      const float pw = __double2float_rn(
          pow(static_cast<double>(base), static_cast<double>(alpha)));
      keys[i] = __float2int_rz(__fmul_rn(n_f, pw));
      continue;
    }
    if (!kZipfOnly && hot_max > 0) {
      const bool hot =
          dt_bits_to_uniform(dt_random_bits(sk[6], sk[7], (uint64_t)i)) <
          access_perc;
      v = hot ? dt_randint_at(sk + 8, sk + 10, i, 0, hot_max)
              : dt_randint_at(sk + 12, sk + 14, i, hot_max, n_rows);
    } else if (!kZipfOnly && theta_zero) {
      const float u =
          dt_bits_to_uniform(dt_random_bits(sk[0], sk[1], (uint64_t)i));
      v = min(__float2int_rz(__fmul_rn(u, n_f)), n_rows - 1);
    } else {
      const float u =
          dt_bits_to_uniform(dt_random_bits(sk[0], sk[1], (uint64_t)i));
      const float uz = __fmul_rn(u, zetan);
      const float base = __fadd_rn(__fsub_rn(__fmul_rn(eta, u), eta), 1.0f);
      const float pw =
          kPiece == kNoPow ? base
                           : __double2float_rn(pow(static_cast<double>(base),
                                                   static_cast<double>(alpha)));
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

template <int kPiece>
void launch_generate(const int64_t* gen_key, int total, int req,
                     int theta_zero, int n_rows, float n_f, float zetan,
                     float eta, float alpha, float thresh1, int hot_max,
                     float access_perc, float p_write, int write_gate,
                     float p_txn_write, int32_t* keys, uint8_t* is_write,
                     cudaStream_t s) {
  generate_kernel<kPiece, false><<<dt_blocks(total, kThreads), kThreads, 0,
                                   s>>>(
      gen_key, total, req, theta_zero, n_rows, n_f, zetan, eta, alpha,
      thresh1, hot_max, access_perc, p_write, write_gate, p_txn_write, keys,
      is_write);
}

// The zipf-only pieces, compiled for their SASS and never launched.
template __global__ void generate_kernel<kWhole, true>(
    const int64_t*, int, int, int, int, float, float, float, float, float,
    int, float, float, int, float, int32_t*, uint8_t*);
template __global__ void generate_kernel<kPrologue, true>(
    const int64_t*, int, int, int, int, float, float, float, float, float,
    int, float, float, int, float, int32_t*, uint8_t*);
template __global__ void generate_kernel<kNoPow, true>(
    const int64_t*, int, int, int, int, float, float, float, float, float,
    int, float, float, int, float, int32_t*, uint8_t*);

}  // namespace

// The slice-8 K13b's stream operations selected by `ops`: bit 0 the
// histograms' memset, bit 1 the counts' memset, bit 2 the histogram pass,
// bit 3 the verdict pass.  `scratch` holds 2k + b*a int32.
DT_EXPORT int k17p_density(int ops, const int32_t* table_ids,
                           const int32_t* keys, const uint8_t* valid,
                           const uint8_t* is_read, const uint8_t* is_write,
                           const uint8_t* active, const int32_t* owner, int b,
                           int a, int k, int p, int inc_arm, int32_t* scratch,
                           int32_t* out, void* stream) {
  if ((k & (k - 1)) != 0 || p < 1 || p > 1024) return 1;
  cudaStream_t s = dt_stream(stream);
  const int n = b * a;
  int32_t* wcol = scratch;
  int32_t* ucol = scratch + k;
  int32_t* bkt = scratch + 2 * k;
  if (ops & 1)
    cudaMemsetAsync(scratch, 0, 2 * static_cast<size_t>(k) * sizeof(int32_t),
                    s);
  if (ops & 2)
    cudaMemsetAsync(out, 0, static_cast<size_t>(p) * sizeof(int32_t), s);
  if (ops & 4)
    density_hist_kernel<<<dt_blocks(n, kThreads), kThreads, 0, s>>>(
        table_ids, keys, valid, is_read, is_write, active, n, a,
        static_cast<uint32_t>(k - 1), inc_arm, wcol, ucol, bkt);
  if (ops & 8)
    density_conf_kernel<<<dt_blocks(n, kThreads), kThreads,
                          p * sizeof(int32_t), s>>>(bkt, is_write, owner, n,
                                                    a, p, wcol, ucol, out);
  return dt_status();
}

// The slice-4 K4b (piece 0, with the row sort under key_order) or one of
// its pieces (1-4 as GenPiece; 5 the row sort alone, on `keys` as they
// are).  Arguments as dt_ycsb_generate's.
DT_EXPORT int k17p_generate(int piece, const int64_t* gen_key, int n,
                            int req, int n_rows, int theta_zero, float n_f,
                            float zetan, float eta, float alpha,
                            float thresh1, int hot_max, float access_perc,
                            float p_write, int write_gate, float p_txn_write,
                            int key_order, int32_t* keys, uint8_t* is_write,
                            void* stream) {
  if (key_order && req > kMaxSortedReq) return 1;
  const cudaStream_t s = dt_stream(stream);
  const int total = n * req;
#define K17P_GEN(P)                                                         \
  launch_generate<P>(gen_key, total, req, theta_zero, n_rows, n_f, zetan,   \
                     eta, alpha, thresh1, hot_max, access_perc, p_write,    \
                     write_gate, p_txn_write, keys, is_write, s)
  switch (piece) {
    case 0:
      K17P_GEN(kWhole);
      if (key_order)
        sort_rows_kernel<<<dt_blocks(n, 128), 128, 0, s>>>(keys, n, req);
      break;
    case 1: K17P_GEN(kEmpty); break;
    case 2: K17P_GEN(kPrologue); break;
    case 3: K17P_GEN(kNoPow); break;
    case 4: K17P_GEN(kPowOnly); break;
    case 5:
      sort_rows_kernel<<<dt_blocks(n, 128), 128, 0, s>>>(keys, n, req);
      break;
    default: return 1;
  }
#undef K17P_GEN
  return dt_status();
}
