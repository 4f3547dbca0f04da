// Key hashing shared by the conflict kernels (conflict.cu), the T/O
// watermark kernels (timestamp.cu) and the audit kernels (audit.cu):
// deneva_tpu/ops/hashing.py:25
// combine_key then :37 bucket_hash (murmur3 fmix32 of ident ^ MULTS[family]),
// masked to a power-of-two bucket count.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t family_mult(int f) {
  switch (f & 3) {
    case 0: return 2654435761u;
    case 1: return 2246822519u;
    case 2: return 3266489917u;
    default: return 668265263u;
  }
}

// combine_key: the 32-bit identity of a (table, key) access.
__device__ __forceinline__ uint32_t combine_ident(int32_t table,
                                                  int32_t key) {
  return (static_cast<uint32_t>(key) * 2654435761u) ^
         (static_cast<uint32_t>(table) * 0x9E3779B9u);
}

// bucket_hash of an identity.
__device__ __forceinline__ uint32_t bucket_of_ident(uint32_t ident,
                                                    int family,
                                                    uint32_t kmask) {
  uint32_t h = ident ^ family_mult(family);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h & kmask;
}

__device__ __forceinline__ uint32_t bucket_of(int32_t table, int32_t key,
                                              int family, uint32_t kmask) {
  return bucket_of_ident(combine_ident(table, key), family, kmask);
}
