// Thread-block cluster primitives shared by K8 (conflict.cu), K11b
// (maat.cu) and K16 (depgraph.cu): mbarriers, the cluster's start, remote
// stores that signal the receiving CTA's mbarrier, and bulk copies into
// shared memory that complete on one.
//
// A round of either kernel hands data to the other CTAs of its cluster.
// cluster.sync() would order that, but its release fence costs ~700 ns
// on an H100 80GB HBM3 (700 W) against ~110 ns for a relaxed cluster
// barrier and 45 ns for __syncthreads.  So data moves by st.async: each
// remote store counts its bytes against an mbarrier in the receiving CTA,
// which waits for the bytes it expects that round and then reads them.
// The one cluster barrier, relaxed, comes after the mbarriers are made:
// from then on every CTA runs and may be written to.  A sender reuses a
// receiver's buffer only after the receiver has answered the round that
// read it, so a buffer pair (by round parity) and a barrier pair suffice.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 makes `n` mbarriers of one arrival each; the caller then makes
// them visible (a block or cluster barrier).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(bar + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// The one local arrival of a phase, with the bytes it waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete; what the remote
// stores of that phase wrote is visible after it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Every CTA of the cluster has started and made its mbarriers.
__device__ __forceinline__ void cluster_start() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;" ::
          : "memory");
}

// The shared::cluster address of `p` in CTA `rank`.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// Store 4 or 16 bytes into another CTA and count them on its mbarrier.
__device__ __forceinline__ void st_remote(uint32_t addr, uint32_t v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_remote4(uint32_t addr, uint4 v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Bulk asynchronous copies of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global memory into this CTA's shared memory, in
// chunks of kBulkChunk, completing on mbarrier `bar` (whose expected
// bytes the caller set).  One thread issues them.
constexpr uint32_t kBulkChunk = 32768;

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  for (uint32_t off = 0; off < bytes; off += kBulkChunk) {
    const uint32_t n = min(kBulkChunk, bytes - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(d + off)),
        "l"(s + off), "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

}  // namespace
