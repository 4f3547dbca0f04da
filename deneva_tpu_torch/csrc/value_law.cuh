// YCSB's value law, shared by the forward-execute kernels (ycsb.cu) and
// the MVCC version read (version.cu): deneva_tpu/workloads/ycsb.py:57
// _field_fingerprint f(key, version) and :65 _field_bytes, the 100-byte
// payload derived from it, moved here as little-endian 4-byte words.
#pragma once

#include <cstdint>

constexpr uint32_t kMulKey = 2654435761u;
constexpr uint32_t kMulVer = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fp_law(uint32_t k, uint32_t v) {
  return ((k * kMulKey) ^ (v * kMulVer)) | 1u;
}

__device__ __forceinline__ uint32_t byte_law(uint32_t fp, uint32_t b) {
  return ((fp * (b * kMulKey + kMulVer)) >> 13) & 0xFFu;
}

// bytes b0..b0+3 of the payload of fingerprint fp, little-endian
__device__ __forceinline__ uint32_t word_law(uint32_t fp, uint32_t b0) {
  return byte_law(fp, b0) | (byte_law(fp, b0 + 1) << 8) |
         (byte_law(fp, b0 + 2) << 16) | (byte_law(fp, b0 + 3) << 24);
}

__device__ __forceinline__ uint32_t byte_sum(uint32_t x) {
  return (x & 0xFFu) + ((x >> 8) & 0xFFu) + ((x >> 16) & 0xFFu) + (x >> 24);
}
