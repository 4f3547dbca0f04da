// Threefry-2x32 (20 rounds), bit-identical to jax's threefry2x32 with
// jax_threefry_partitionable=True (jax/_src/prng.py:1092 threefry_2x32,
// the unrolled lowering: rotations {13,15,26,6} / {17,29,16,24}, key
// schedule (k0, k1, k0^k1^0x1BD11BDA), injection i+1 after round block i).
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t dt_rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define DT_TF_ROUND(r)   \
  x0 += x1;              \
  x1 = dt_rotl32(x1, r); \
  x1 ^= x0;

// Hash the counter pair (x0, x1) in place under key (k0, k1).
__device__ __forceinline__ void dt_threefry2x32(uint32_t k0, uint32_t k1,
                                                uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  DT_TF_ROUND(13) DT_TF_ROUND(15) DT_TF_ROUND(26) DT_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  DT_TF_ROUND(17) DT_TF_ROUND(29) DT_TF_ROUND(16) DT_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  DT_TF_ROUND(13) DT_TF_ROUND(15) DT_TF_ROUND(26) DT_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  DT_TF_ROUND(17) DT_TF_ROUND(29) DT_TF_ROUND(16) DT_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  DT_TF_ROUND(13) DT_TF_ROUND(15) DT_TF_ROUND(26) DT_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
}

#undef DT_TF_ROUND

// 32 random bits of flat element `idx` of a draw under key (k0, k1):
// counters (idx >> 32, idx & 0xffffffff), result bits1 ^ bits2
// (jax/_src/prng.py:1184 _threefry_random_bits_partitionable).
__device__ __forceinline__ uint32_t dt_random_bits(uint32_t k0, uint32_t k1,
                                                   uint64_t idx) {
  uint32_t x0 = static_cast<uint32_t>(idx >> 32);
  uint32_t x1 = static_cast<uint32_t>(idx);
  dt_threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.uniform float32 in [0, 1) (jax/_src/random.py:435 _uniform):
// mantissa bits under exponent 0, bitcast, minus 1.0.
__device__ __forceinline__ float dt_bits_to_uniform(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
  return fmaxf(__fsub_rn(f, 1.0f), 0.0f);
}

// jax.random.split's key `i` of (k0, k1): counters (0, i).
__device__ __forceinline__ void dt_split_key(uint32_t k0, uint32_t k1,
                                             uint32_t i, uint32_t* out) {
  uint32_t x0 = 0u, x1 = i;
  dt_threefry2x32(k0, k1, x0, x1);
  out[0] = x0;
  out[1] = x1;
}

// jax.random.randint's value at flat index `idx` for [lo, hi): the two
// split keys' draws (ka the high word's, kb the low word's) folded into
// the span in wrapping uint32 arithmetic (jax/_src/random.py:581
// _randint; the multiplier (2^16 % span)^2 % span wraps to 0 above 2^16).
__device__ __forceinline__ int32_t dt_randint_at(const uint32_t* ka,
                                                 const uint32_t* kb,
                                                 uint64_t idx, int32_t lo,
                                                 int32_t hi) {
  const uint32_t span = hi > lo ? static_cast<uint32_t>(hi - lo) : 1u;
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t higher = dt_random_bits(ka[0], ka[1], idx);
  const uint32_t lower = dt_random_bits(kb[0], kb[1], idx);
  const uint32_t off = ((higher % span) * mult + lower % span) % span;
  return lo + static_cast<int32_t>(off);
}

// x % d for every uint32 x and d >= 1 by a multiply-high, with magic =
// floor((2^64 - 1) / d) + 1 mod 2^64 from the host (0 for d = 1): the
// remainder is the top word of (magic * x mod 2^64) * d (Lemire, Kaser
// and Kurz, "Faster remainder by direct computation", 2019: exact for
// 32-bit x and d with a 64-bit magic).
__device__ __forceinline__ uint32_t dt_fastmod(uint32_t x,
                                               unsigned long long magic,
                                               uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(magic * x, d));
}

// dt_randint_at's fold of the two words into [0, span) with the
// multiplier (2^16 % span)^2 % span and the span's magic as launch
// constants.
__device__ __forceinline__ uint32_t dt_randint_fold(uint32_t higher,
                                                    uint32_t lower,
                                                    uint32_t span,
                                                    uint32_t mult,
                                                    unsigned long long magic) {
  const uint32_t t =
      dt_fastmod(higher, magic, span) * mult + dt_fastmod(lower, magic, span);
  return dt_fastmod(t, magic, span);
}
