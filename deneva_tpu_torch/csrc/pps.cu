// K20: PPS query generation, one epoch of Product-Parts-Suppliers queries.
//
// Replaces deneva_tpu/workloads/pps.py:184 PPSWorkload.generate, on the
// reference's threefry stream bit for bit: split(rng, 4) -> k0..k3; the
// type is the count of cumulative-mix entries (float32, eight of them) at
// or below uniform(k0), clipped to 7; part, product and supplier keys are
// randint(k1, 0, parts), randint(k2, 0, products), randint(k3, 0,
// suppliers).  uniform is jax's (mantissa bits under exponent 0, minus
// 1.0); randint is jax's (the two keys of split(k) folded by remainders in
// wrapping uint32, the multiplier wrapping to 0 above span 2^16).
// Design: the block's first threads derive the ten keys of the split tree
// into shared memory, one level per pass; then one thread per txn draws
// its four fields.
//   Bound: operations — 7 threefry hashes per txn against 16 output bytes.
#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// keys: K0..K3 = split(rng, 4); then split(Kj, 2) for j = 1..3
enum Key { K0, K1, K2, K3, K1A, K1B, K2A, K2B, K3A, K3B, kNumKeys };

__global__ void pps_generate_kernel(const int64_t* __restrict__ rng, int n,
                                    const float* __restrict__ cum,
                                    int n_parts, int n_products,
                                    int n_suppliers,
                                    int32_t* __restrict__ txn_type,
                                    int32_t* __restrict__ part_key,
                                    int32_t* __restrict__ product_key,
                                    int32_t* __restrict__ supplier_key) {
  __shared__ uint32_t sk[2 * kNumKeys];
  __shared__ float scum[8];
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < 4) {
    dt_split_key(static_cast<uint32_t>(rng[0]), static_cast<uint32_t>(rng[1]),
                 static_cast<uint32_t>(tid), sk + 2 * tid);
  } else if (tid >= 32 && tid < 40) {
    scum[tid - 32] = cum[tid - 32];
  }
  __syncthreads();
  if (tid < 6) {
    const int src = K1 + tid / 2;
    dt_split_key(sk[2 * src], sk[2 * src + 1], static_cast<uint32_t>(tid % 2),
                 sk + 2 * (K1A + tid));
  }
  __syncthreads();
  const int t = blockIdx.x * kThreads + tid;
  if (t >= n) return;
  const uint64_t i = static_cast<uint64_t>(t);
  const float r = dt_bits_to_uniform(dt_random_bits(sk[2 * K0], sk[2 * K0 + 1],
                                                    i));
  int type = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) type += r >= scum[k] ? 1 : 0;
  txn_type[t] = type < 7 ? type : 7;
  part_key[t] = dt_randint_at(sk + 2 * K1A, sk + 2 * K1B, i, 0, n_parts);
  product_key[t] = dt_randint_at(sk + 2 * K2A, sk + 2 * K2B, i, 0,
                                 n_products);
  supplier_key[t] = dt_randint_at(sk + 2 * K3A, sk + 2 * K3B, i, 0,
                                  n_suppliers);
}

}  // namespace

// K20: n PPS queries from the raw threefry key rng int64[2]; cum is the
// float32 cumulative mix of the eight txn types (on the device).
DT_EXPORT int dt_pps_generate(const int64_t* rng, int n, const float* cum,
                              int n_parts, int n_products, int n_suppliers,
                              int32_t* txn_type, int32_t* part_key,
                              int32_t* product_key, int32_t* supplier_key,
                              void* stream) {
  if (n_parts < 1 || n_products < 1 || n_suppliers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return dt_status();
  pps_generate_kernel<<<dt_blocks(n, kThreads), kThreads, 0,
                        dt_stream(stream)>>>(
      rng, n, cum, n_parts, n_products, n_suppliers, txn_type, part_key,
      product_key, supplier_key);
  return dt_status();
}
