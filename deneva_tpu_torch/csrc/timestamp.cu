// K12a, K12b: the T/O watermarks of TIMESTAMP and MVCC.
//
// K12a dt_watermark_check replaces deneva_tpu/cc/timestamp.py:112 _wm_bucket,
// :164 _readonly, :174 _stale_read_lanes and :202 _watermark_aborts.  One
// warp per txn: each lane hashes one access into the watermark space
// (family 0, hashing.cuh), gathers its bucket's rts / wts and applies the
// read and write rules; under MVCC a pure read that meets a newer wts also
// reads its bucket's H ring entries for the oldest retained boundary.  The
// warp any-reduces the lanes, derives the read-only flag and, under MVCC,
// clears read-only txns.  Escrow (order_free) lanes follow the reference's
// relaxed rules.  The reference reduces his over all K buckets every
// epoch; the kernel reads only the rows its lanes touch — the same result.
//   Bound: bytes — the lanes' keys, flags and ts, one rts / wts word per
//   access (ring rows only for stale pure reads), two flags per txn.
//
// K12b dt_commit_watermarks replaces :271 _commit_watermarks.  One thread
// per lane; committed reads atomicMax their ts into rts, committed writes
// into wts (masked lanes of the reference carry 0, a no-op against
// watermarks >= 0, so they are skipped).  Under MVCC the reference builds a
// K-wide epoch_w and rewrites all K x H ring entries; here each bucket's
// epoch boundary costs O(lanes) in two launches:
//   1. written lanes also atomicMax their ts into a K-wide scratch that is
//      all zeros between epochs;
//   2. each written lane atomicExch-es its bucket's scratch back to 0; the
//      one lane that receives a non-zero value writes his[b, pos[b]] and
//      advances pos[b] = (pos[b] + 1) % H.
// The scratch ends the epoch all zeros again, and each written bucket gets
// exactly the reference's max(ts) boundary.
//   Bound: bytes — the lanes read once, one word of rts / wts (and of the
//   scratch, his, pos) per touched bucket.
#include "common.cuh"
#include "hashing.cuh"

namespace {

__global__ void watermark_check_kernel(
    const int32_t* __restrict__ table_ids, const int32_t* __restrict__ keys,
    const uint8_t* __restrict__ is_read, const uint8_t* __restrict__ is_write,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ active,
    const uint8_t* __restrict__ order_free, const int32_t* __restrict__ ts,
    const uint8_t* __restrict__ ro_hint, int B, int A,
    const int32_t* __restrict__ rts, const int32_t* __restrict__ wts,
    const int32_t* __restrict__ his, int K, int H,
    uint8_t* __restrict__ wm_abort, uint8_t* __restrict__ ro_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;   // whole warps leave together
  const bool act = active[row] != 0;
  const int32_t t = ts[row];
  const uint32_t kmask = static_cast<uint32_t>(K - 1);
  bool bad = false, wrote = false;
  for (int l = lane; act && l < A; l += 32) {
    const size_t at = static_cast<size_t>(row) * A + l;
    if (!valid[at]) continue;
    const bool r = is_read[at] != 0, w = is_write[at] != 0;
    if (!r && !w) continue;
    const bool of = order_free != nullptr && order_free[at] != 0;
    wrote |= w;
    const uint32_t b = bucket_of(table_ids[at], keys[at], 0, kmask);
    const int32_t wts_at = wts[b];
    if (r && !of) {
      if (his == nullptr || w) {
        bad |= wts_at > t;          // T/O read, or an MVCC read-modify-write
      } else if (wts_at > t) {      // MVCC pure read: is its version kept?
        int32_t m = his[static_cast<size_t>(b) * H];
        for (int h = 1; h < H; ++h)
          m = min(m, his[static_cast<size_t>(b) * H + h]);
        bad |= t < m;
      }
    }
    if (w) bad |= rts[b] > t || (!of && wts_at > t);
  }
  bad = __any_sync(0xffffffffu, bad);
  wrote = __any_sync(0xffffffffu, wrote);
  if (lane == 0) {
    const bool mvcc = his != nullptr;
    const bool ro = ro_hint != nullptr ? ro_hint[row] != 0 : !wrote;
    wm_abort[row] = bad && !(mvcc && ro);
    ro_out[row] = mvcc && ro;
  }
}

// the lane's bucket when it is a committed access that records anything
__device__ __forceinline__ bool committed_lane(
    int i, int A, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ commit, const uint8_t* __restrict__ is_read,
    const uint8_t* __restrict__ is_write,
    const uint8_t* __restrict__ order_free, bool& r, bool& w) {
  if (!valid[i] || !commit[i / A]) return false;
  r = is_read[i] != 0 && !(order_free != nullptr && order_free[i] != 0);
  w = is_write[i] != 0;
  return r || w;
}

__global__ void commit_max_kernel(
    const int32_t* __restrict__ table_ids, const int32_t* __restrict__ keys,
    const uint8_t* __restrict__ is_read, const uint8_t* __restrict__ is_write,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ commit,
    const uint8_t* __restrict__ order_free, const int32_t* __restrict__ ts,
    int n, int A, int32_t* __restrict__ rts, int32_t* __restrict__ wts,
    int K, int32_t* __restrict__ scratch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool r, w;
  if (i >= n || !committed_lane(i, A, valid, commit, is_read, is_write,
                                order_free, r, w))
    return;
  const uint32_t b =
      bucket_of(table_ids[i], keys[i], 0, static_cast<uint32_t>(K - 1));
  const int32_t t = ts[i / A];
  if (r) atomicMax(&rts[b], t);
  if (w) {
    atomicMax(&wts[b], t);
    if (scratch != nullptr) atomicMax(&scratch[b], t);
  }
}

__global__ void commit_ring_kernel(
    const int32_t* __restrict__ table_ids, const int32_t* __restrict__ keys,
    const uint8_t* __restrict__ is_read, const uint8_t* __restrict__ is_write,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ commit,
    const uint8_t* __restrict__ order_free, int n, int A, int K,
    int32_t* __restrict__ his, int32_t* __restrict__ pos,
    int32_t* __restrict__ scratch, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool r, w;
  if (i >= n || !committed_lane(i, A, valid, commit, is_read, is_write,
                                order_free, r, w) || !w)
    return;
  const uint32_t b =
      bucket_of(table_ids[i], keys[i], 0, static_cast<uint32_t>(K - 1));
  const int32_t boundary = atomicExch(&scratch[b], 0);
  if (boundary != 0) {
    const int32_t p = pos[b];
    his[static_cast<size_t>(b) * H + p] = boundary;
    pos[b] = p + 1 == H ? 0 : p + 1;
  }
}

}  // namespace

DT_EXPORT int dt_watermark_check(
    const int32_t* table_ids, const int32_t* keys, const uint8_t* is_read,
    const uint8_t* is_write, const uint8_t* valid, const uint8_t* active,
    const uint8_t* order_free, const int32_t* ts, const uint8_t* ro_hint,
    int B, int A, const int32_t* rts, const int32_t* wts, const int32_t* his,
    int K, int H, uint8_t* wm_abort, uint8_t* ro, void* stream) {
  const int threads = 256, rows = threads / 32;
  watermark_check_kernel<<<dt_blocks(B, rows), threads, 0,
                           dt_stream(stream)>>>(
      table_ids, keys, is_read, is_write, valid, active, order_free, ts,
      ro_hint, B, A, rts, wts, his, K, H, wm_abort, ro);
  return dt_status();
}

DT_EXPORT int dt_commit_watermarks(
    const int32_t* table_ids, const int32_t* keys, const uint8_t* is_read,
    const uint8_t* is_write, const uint8_t* valid, const uint8_t* commit,
    const uint8_t* order_free, const int32_t* ts, int B, int A, int32_t* rts,
    int32_t* wts, int K, int32_t* his, int32_t* pos, int32_t* scratch, int H,
    void* stream) {
  const cudaStream_t s = dt_stream(stream);
  const int n = B * A, threads = 256;
  commit_max_kernel<<<dt_blocks(n, threads), threads, 0, s>>>(
      table_ids, keys, is_read, is_write, valid, commit, order_free, ts, n, A,
      rts, wts, K, his != nullptr ? scratch : nullptr);
  if (his != nullptr)
    commit_ring_kernel<<<dt_blocks(n, threads), threads, 0, s>>>(
        table_ids, keys, is_read, is_write, valid, commit, order_free, n, A,
        K, his, pos, scratch, H);
  return dt_status();
}
