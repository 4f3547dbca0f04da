// A stand-alone probe of where K3's time went before slice 15, built as
// its own shared library and driven by `chip_smoke.py --slice15` on the
// main path's real plan (not part of the kernel library).  It holds a
// copy of the slice-1 gather + checksum launch, once as it was (a block
// reduction, then one atomicAdd per block on each of the two totals) and
// once with those atomics replaced by a plain store of each block's
// partials to a slot of its own, in both table modes; the slice-1
// winners' store launch and checksum memset; an empty launch; and a
// cooperative launch of the occupancy grid (or fewer blocks) at 256, 512
// or 1024 threads a block that passes `syncs` grid barriers.  The split
// of the old K3 and the price of the new one's grid barrier come from
// timing these side by side.
#include <cooperative_groups.h>

#include "common.cuh"
#include "value_law.cuh"

namespace cg = cooperative_groups;

namespace {

struct AddOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

template <bool kAtomics>
__device__ __forceinline__ void flush(uint32_t s, uint32_t wc,
                                      uint32_t* acc) {
  s = dt_block_reduce(s, AddOp(), 0u);
  wc = dt_block_reduce(wc, AddOp(), 0u);
  if (threadIdx.x == 0) {
    if (kAtomics) {
      atomicAdd(&acc[0], s);
      atomicAdd(&acc[1], wc);
    } else {
      acc[2 + 2 * blockIdx.x] = s;
      acc[3 + 2 * blockIdx.x] = wc;
    }
  }
}

template <bool kAtomics>
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
  flush<kAtomics>(s, wc, acc);
}

template <bool kAtomics>
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
  flush<kAtomics>(s, wc, acc);
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

__global__ void empty_kernel(uint32_t* sink) {
  if (sink != nullptr && threadIdx.x == 12345) *sink = 1u;
}

__global__ void barrier_kernel(int syncs, uint32_t* sink) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < syncs; ++i) g.sync();
  if (sink != nullptr && threadIdx.x == 12345) *sink = 1u;
}

}  // namespace

// Blocks of the slice-1 gather launch for n lanes (full rows: n * tup / 4
// threads), the length its partials need in `acc` (2 + 2 * blocks).
DT_EXPORT int k3p_gather_blocks(int n, int tup) {
  return tup == 0 ? dt_blocks(n, 256)
                  : dt_blocks(static_cast<long long>(n) * (tup >> 2), 256);
}

// The slice-1 gather + checksum launch alone; atomics == 0 stores each
// block's partials to acc[2 + 2b], acc[3 + 2b] instead.
DT_EXPORT int k3p_gather(void* f0, int tup, const int32_t* keys,
                         const uint8_t* is_read, const uint8_t* is_write,
                         const int32_t* fwd, const int32_t* slots, int n,
                         uint32_t* acc, int atomics, void* stream) {
  const cudaStream_t s = dt_stream(stream);
  const int blocks = k3p_gather_blocks(n, tup);
  if (tup == 0) {
    auto* t = static_cast<const uint32_t*>(f0);
    if (atomics)
      read_fp_kernel<true><<<blocks, 256, 0, s>>>(t, keys, is_read, is_write,
                                                  fwd, slots, n, acc);
    else
      read_fp_kernel<false><<<blocks, 256, 0, s>>>(t, keys, is_read,
                                                   is_write, fwd, slots, n,
                                                   acc);
  } else {
    auto* t = static_cast<const uint8_t*>(f0);
    if (atomics)
      read_row_kernel<true><<<blocks, 256, 0, s>>>(
          t, tup, keys, is_read, is_write, fwd, slots, n, acc);
    else
      read_row_kernel<false><<<blocks, 256, 0, s>>>(
          t, tup, keys, is_read, is_write, fwd, slots, n, acc);
  }
  return dt_status();
}

// The slice-1 checksum memset alone.
DT_EXPORT int k3p_memset(uint32_t* acc, void* stream) {
  cudaMemsetAsync(acc, 0, 2 * sizeof(uint32_t), dt_stream(stream));
  return dt_status();
}

// The slice-1 winners' store launch alone.
DT_EXPORT int k3p_store(void* f0, int tup, const int32_t* keys,
                        const int32_t* rank, const uint8_t* win,
                        const int32_t* slots, int n, int cap, void* stream) {
  const cudaStream_t s = dt_stream(stream);
  if (tup == 0) {
    write_fp_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(
        static_cast<uint32_t*>(f0), keys, rank, win, slots, n, cap);
  } else {
    write_row_kernel<<<dt_blocks(static_cast<long long>(n) * (tup >> 2), 256),
                       256, 0, s>>>(static_cast<uint8_t*>(f0), tup, keys,
                                    rank, win, slots, n, cap);
  }
  return dt_status();
}

// One empty launch of `blocks` x 256 threads.
DT_EXPORT int k3p_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, 256, 0, dt_stream(stream)>>>(nullptr);
  return dt_status();
}

// The occupancy grid of `threads`-thread blocks of the barrier kernel
// (the blocks per SM times the SMs); 0 where a query fails.
DT_EXPORT int k3p_coop_grid(int threads) {
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, barrier_kernel,
                                                    threads, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

// One cooperative launch of `blocks` x `threads` (at most the occupancy
// grid) that passes `syncs` grid barriers.
DT_EXPORT int k3p_grid_sync(int blocks, int threads, int syncs,
                            void* stream) {
  uint32_t* sink = nullptr;
  void* args[] = {&syncs, &sink};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(barrier_kernel), dim3(blocks), dim3(threads),
      args, 0, dt_stream(stream));
  return e != cudaSuccess ? static_cast<int>(e) : dt_status();
}
