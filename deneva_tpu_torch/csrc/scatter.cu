// K10 dt_last_writer: per target slot, the masked lane with the highest
// (order, lane) wins.
//
// Replaces deneva_tpu/ops/scatter.py:33 last_writer.  The reference takes a
// three-key sort tournament plus an unsort below capacity and a
// scatter-max arena over capacity + 1 slots at or above it; both compute
// win[i] = mask[i] && (order[i], i) == max{(order[j], j) : mask[j],
// slot[j] == slot[i]}.  This kernel computes that function in O(N) with
// no arena: an open-addressing table of T >= 2N entries keyed by slot
// (linear probing, atomicCAS to claim a key) holds, per slot, the 64-bit
// atomicMax of ((order - INT32_MIN) << 32 | lane); a second pass marks
// the lanes whose word is their slot's maximum.  Unmasked lanes never
// insert, so they compete as (INT32_MIN, -1) and never win.
//   Bound: bytes — the lanes' slot, order and mask read once and the win
//   flags written once; the table (T x 12 bytes) stays in L2.
#include "common.cuh"

namespace {

constexpr int32_t kEmpty = -1;   // slots are >= 0

__device__ __forceinline__ uint32_t slot_hash(int32_t s, uint32_t mask) {
  uint32_t h = static_cast<uint32_t>(s) * 2654435761u;
  return (h ^ (h >> 16)) & mask;
}

__device__ __forceinline__ unsigned long long lane_word(int32_t order,
                                                        int lane) {
  const uint32_t o = static_cast<uint32_t>(order) ^ 0x80000000u;
  return (static_cast<unsigned long long>(o) << 32) |
         static_cast<uint32_t>(lane);
}

__global__ void insert_kernel(const int32_t* __restrict__ slots,
                              const int32_t* __restrict__ order,
                              const uint8_t* __restrict__ mask, int n,
                              int32_t* __restrict__ tkeys,
                              unsigned long long* __restrict__ tvals, int T) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  const int32_t s = slots[i];
  const uint32_t tmask = static_cast<uint32_t>(T - 1);
  uint32_t h = slot_hash(s, tmask);
  while (true) {
    const int32_t prev = atomicCAS(&tkeys[h], kEmpty, s);
    if (prev == kEmpty || prev == s) {
      atomicMax(&tvals[h], lane_word(order[i], i));
      return;
    }
    h = (h + 1) & tmask;
  }
}

__global__ void mark_kernel(const int32_t* __restrict__ slots,
                            const int32_t* __restrict__ order,
                            const uint8_t* __restrict__ mask, int n,
                            const int32_t* __restrict__ tkeys,
                            const unsigned long long* __restrict__ tvals,
                            int T, uint8_t* __restrict__ win) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool w = false;
  if (mask[i]) {
    const int32_t s = slots[i];
    const uint32_t tmask = static_cast<uint32_t>(T - 1);
    uint32_t h = slot_hash(s, tmask);
    while (tkeys[h] != s) h = (h + 1) & tmask;
    w = tvals[h] == lane_word(order[i], i);
  }
  win[i] = w;
}

}  // namespace

DT_EXPORT int dt_last_writer(const int32_t* slots, const int32_t* order,
                             const uint8_t* mask, int n, int32_t* tkeys,
                             unsigned long long* tvals, int T, uint8_t* win,
                             void* stream) {
  const cudaStream_t s = dt_stream(stream);
  cudaMemsetAsync(tkeys, 0xFF, static_cast<size_t>(T) * sizeof(int32_t), s);
  cudaMemsetAsync(tvals, 0, static_cast<size_t>(T) * sizeof(unsigned long long),
                  s);
  const int threads = 256;
  insert_kernel<<<dt_blocks(n, threads), threads, 0, s>>>(slots, order, mask, n,
                                                         tkeys, tvals, T);
  mark_kernel<<<dt_blocks(n, threads), threads, 0, s>>>(slots, order, mask, n,
                                                       tkeys, tvals, T, win);
  return dt_status();
}
