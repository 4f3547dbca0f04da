// K13a: transaction repair's invalidated-read frontier.
//
// Replaces deneva_tpu/cc/base.py:193 committed_write_frontier: per hash
// family the bf16 matvec committed[1, B] x w[B, K] with f32 accumulation,
// compared > 0, gathered at each lane's bucket (family 1's bucket hashed
// from the lane's key), ANDed across families and masked to the losers'
// valid, non-order_free read lanes.  Out: bool[B, A].  The lane mask
// (`is_read`) is the caller's selector: cc/base.py:548
// audit_mutate_verdict takes the same launch over the write lanes of every
// txn (all rows as `losers`).
//
// The incidence views hold access counts (>= 0), so a column's sum over
// the committed rows is positive exactly when one committed row holds a
// non-zero count: the kernel ORs the columns instead of multiplying, and
// reads only the committed rows.
//   Bound: bytes.  The function reads w1 (and w2) once, B x K bf16 each
//   (32 MiB at B = 2048, K = 8192), and the lanes' B x A words; the
//   column pass streams 16-byte rows of the committed txns only, with
//   32-row chunks in the grid's y so that B = 2048 gives 256 blocks.
#include "common.cuh"
#include "hashing.cuh"

namespace {

constexpr int kColThreads = 256;
constexpr int kRowsPerBlock = 32;

// wrote[c] = 1 where a committed row of w holds a non-zero count in
// column c; each thread owns 8 adjacent columns (one 16-byte load a row).
__global__ void wrote_kernel(const uint8_t* __restrict__ committed,
                             const uint16_t* __restrict__ w, int b, int k,
                             uint8_t* __restrict__ wrote) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g * 8 >= k) return;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int r1 = min(b, r0 + kRowsPerBlock);
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int r = r0; r < r1; ++r) {
    if (!committed[r]) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        w + static_cast<size_t>(r) * k + static_cast<size_t>(g) * 8);
    acc.x |= v.x;
    acc.y |= v.y;
    acc.z |= v.z;
    acc.w |= v.w;
  }
  const uint32_t words[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // bf16 magnitude bits; counts are never negative
    if ((words[j >> 1] >> (16 * (j & 1))) & 0x7FFFu) wrote[g * 8 + j] = 1;
  }
}

__global__ void lanes_kernel(const uint8_t* __restrict__ wrote1,
                             const uint8_t* __restrict__ wrote2,
                             const int32_t* __restrict__ bucket1,
                             const int32_t* __restrict__ table_ids,
                             const int32_t* __restrict__ keys,
                             const uint8_t* __restrict__ valid,
                             const uint8_t* __restrict__ is_read,
                             const uint8_t* __restrict__ losers,
                             const uint8_t* __restrict__ order_free, int b,
                             int a, uint32_t kmask,
                             uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b * a) return;
  const bool m = valid[i] && is_read[i] && losers[i / a] &&
                 !(order_free != nullptr && order_free[i]);
  bool hit = wrote1[bucket1[i]] != 0;
  if (wrote2 != nullptr)
    hit = hit && wrote2[bucket_of(table_ids[i], keys[i], 1, kmask)] != 0;
  out[i] = m && hit;
}

}  // namespace

// `w2` and `order_free` may be null (one family; no escrow lanes).
// `wrote` holds (w2 ? 2 : 1) * k zeroed bytes; k a power of two, k % 8 == 0.
DT_EXPORT int dt_repair_frontier(const uint8_t* committed, const uint16_t* w1,
                                 const uint16_t* w2, const int32_t* bucket1,
                                 const int32_t* table_ids,
                                 const int32_t* keys, const uint8_t* valid,
                                 const uint8_t* is_read,
                                 const uint8_t* losers,
                                 const uint8_t* order_free, int b, int a,
                                 int k, uint8_t* wrote, uint8_t* out,
                                 void* stream) {
  if (k % 8 != 0 || (k & (k - 1)) != 0) return 1;
  cudaStream_t s = dt_stream(stream);
  const dim3 grid((k / 8 + kColThreads - 1) / kColThreads,
                  (b + kRowsPerBlock - 1) / kRowsPerBlock);
  wrote_kernel<<<grid, kColThreads, 0, s>>>(committed, w1, b, k, wrote);
  uint8_t* wrote2 = nullptr;
  if (w2 != nullptr) {
    wrote2 = wrote + k;
    wrote_kernel<<<grid, kColThreads, 0, s>>>(committed, w2, b, k, wrote2);
  }
  lanes_kernel<<<dt_blocks(static_cast<long long>(b) * a, 256), 256, 0, s>>>(
      wrote, wrote2, bucket1, table_ids, keys, valid, is_read, losers,
      order_free, b, a, static_cast<uint32_t>(k - 1), out);
  return dt_status();
}
