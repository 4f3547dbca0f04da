// K21: the contention router's cross-group defer.
//
// Replaces deneva_tpu/cc/router.py:149 cross_group_defer.  In a mixed-
// assignment epoch each txn belongs to the backend group of its home
// partition; a txn defers when one of its accessed buckets is written by
// an active txn of another group, or one of its written buckets is
// touched by one.  The reference computes this from the bf16 [B, K]
// family-1 views u1 / w1 in 2 + 4G einsums with f32 sums and a > 0.5
// test; the kernel works from the lanes instead (K13b's shape):
//
//   pass 1 (one thread per lane): the u-lanes (valid & active & (read |
//     write)) and w-lanes (valid & active & write) add one to their
//     bucket's count of their group and of the total, int32[G + 1][2][K]
//     in global memory (atomics; the counts are at most B * A);
//   pass 2 (one warp per txn): a u-lane at bucket k defers its txn when
//     tot_w[k] - w[g][k] > 0, a w-lane when tot_u[k] - u[g][k] > 0; an
//     inactive txn never defers.
//
// Every value is a small non-negative integer, so the test equals the
// reference's > 0.5 on exact f32 sums of exact bf16 counts.  A txn whose
// group lies outside [0, G) counts in the totals only and never defers,
// as the reference's per-group where() leaves it.
//   Bound: bytes — each lane's bucket and three flag bytes read twice,
//   the counts written and read once, and B output bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void count_kernel(const int32_t* __restrict__ bucket,
                             const uint8_t* __restrict__ valid,
                             const uint8_t* __restrict__ is_read,
                             const uint8_t* __restrict__ is_write,
                             const uint8_t* __restrict__ active,
                             const int32_t* __restrict__ group, int b, int a,
                             int k, int g_cnt, int32_t* __restrict__ cnt) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(b) * a) return;
  const int t = static_cast<int>(i / a);
  if (!valid[i] || !active[t]) return;
  const bool w = is_write[i];
  if (!w && !is_read[i]) return;
  const int c = bucket[i];
  const int g = group[t];
  int32_t* tot = cnt + static_cast<size_t>(g_cnt) * 2 * k;
  atomicAdd(&tot[c], 1);
  if (w) atomicAdd(&tot[k + c], 1);
  if (g < 0 || g >= g_cnt) return;
  int32_t* mine = cnt + static_cast<size_t>(g) * 2 * k;
  atomicAdd(&mine[c], 1);
  if (w) atomicAdd(&mine[k + c], 1);
}

__global__ void defer_kernel(const int32_t* __restrict__ bucket,
                             const uint8_t* __restrict__ valid,
                             const uint8_t* __restrict__ is_read,
                             const uint8_t* __restrict__ is_write,
                             const uint8_t* __restrict__ active,
                             const int32_t* __restrict__ group, int b, int a,
                             int k, int g_cnt,
                             const int32_t* __restrict__ cnt,
                             uint8_t* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= b) return;
  const int g = group[warp];
  bool hit = false;
  if (active[warp] && g >= 0 && g < g_cnt) {
    const int32_t* tot = cnt + static_cast<size_t>(g_cnt) * 2 * k;
    const int32_t* mine = cnt + static_cast<size_t>(g) * 2 * k;
    for (int j = lane; j < a; j += 32) {
      const size_t i = static_cast<size_t>(warp) * a + j;
      if (!valid[i]) continue;
      const bool w = is_write[i];
      if (!w && !is_read[i]) continue;
      const int c = bucket[i];
      // my access vs another group's writes; my write vs its accesses
      if (tot[k + c] - mine[k + c] > 0) hit = true;
      if (w && tot[c] - mine[c] > 0) hit = true;
    }
  }
  hit = __any_sync(0xffffffffu, hit);
  if (lane == 0) out[warp] = hit;
}

}  // namespace

// K21: bucket int32[B, A] (the incidence's family-1 bucket per lane),
// valid / is_read / is_write bool[B, A], active bool[B], group int32[B];
// cnt int32[(G + 1) * 2 * K] scratch; out bool[B].
DT_EXPORT int dt_cross_group_defer(const int32_t* bucket, const uint8_t* valid,
                                   const uint8_t* is_read,
                                   const uint8_t* is_write,
                                   const uint8_t* active,
                                   const int32_t* group, int b, int a, int k,
                                   int g_cnt, int32_t* cnt, uint8_t* out,
                                   void* stream) {
  if (b <= 0 || a <= 0 || k <= 0 || g_cnt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = dt_stream(stream);
  cudaMemsetAsync(cnt, 0,
                  static_cast<size_t>(g_cnt + 1) * 2 * k * sizeof(int32_t),
                  s);
  const long long lanes = static_cast<long long>(b) * a;
  count_kernel<<<dt_blocks(lanes, kThreads), kThreads, 0, s>>>(
      bucket, valid, is_read, is_write, active, group, b, a, k, g_cnt, cnt);
  defer_kernel<<<dt_blocks(static_cast<long long>(b) * 32, kThreads),
                 kThreads, 0, s>>>(bucket, valid, is_read, is_write, active,
                                   group, b, a, k, g_cnt, cnt, out);
  return dt_status();
}
