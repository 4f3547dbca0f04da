// Shared definitions of the deneva_tpu_torch kernels.
//
// Every entry point has a plain C signature (loaded with ctypes by
// deneva_tpu_torch/kernels.py), launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after its launches.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define DT_EXPORT extern "C" __attribute__((visibility("default")))

static inline cudaStream_t dt_stream(void* s) {
  return reinterpret_cast<cudaStream_t>(s);
}

static inline int dt_status() { return static_cast<int>(cudaGetLastError()); }

// The dynamic shared memory a block of `kernel` may take on the current
// device: the per-block opt-in limit less the kernel's static shared
// memory (a launch asking for more is refused).  0 where a query fails.
template <typename F>
static inline size_t dt_smem_room(F* kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes a = {};
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&a, kernel) != cudaSuccess)
    return 0;
  const size_t lim = static_cast<size_t>(optin);
  return a.sharedSizeBytes < lim ? lim - a.sharedSizeBytes : 0;
}

// Phase stamps of a kernel that takes a `stamps` pointer (null: none):
// slots 0 and 1 the %globaltimer (ns) at its entry and exit, slots from
// 2 clock64() at each phase boundary, so a phase's share of the
// measured time is its share of the clocks.  Thread 0 of one block only.
__device__ __forceinline__ long long dt_globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Blocks for one thread per element (at least one block).
static inline int dt_blocks(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return static_cast<int>(b < 1 ? 1 : b);
}

// Block-wide reduction helpers (blockDim.x a multiple of 32, <= 1024).
template <typename T, typename Op>
__device__ __forceinline__ T dt_warp_reduce(T v, Op op) {
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, typename Op>
__device__ T dt_block_reduce(T v, Op op, T identity) {
  __shared__ T part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = dt_warp_reduce(v, op);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = threadIdx.x < nw ? part[threadIdx.x] : identity;
  if (warp == 0) v = dt_warp_reduce(v, op);
  __syncthreads();
  return v;  // valid in thread 0
}

// Block-wide inclusive scan of one value per thread under an associative,
// commutative op; `total` receives the whole block's result.
template <typename T, typename Op>
__device__ T dt_block_incl_scan(T v, Op op, T identity, T& total) {
  __shared__ T warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = op(o, v);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T t = lane < nw ? warp_tot[lane] : identity;
    for (int off = 1; off < 32; off <<= 1) {
      const T o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t = op(o, t);
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v = op(warp_tot[warp - 1], v);
  total = warp_tot[nw - 1];
  __syncthreads();
  return v;
}
