// K12c, K12d: MVCC's per-row version ring on YCSB's F0 column.
//
// K12c dt_version_read replaces deneva_tpu/storage/table.py:230
// VersionRing.rows and :241 version_from as the MVCC read arm of
// deneva_tpu/workloads/ycsb.py:552-579 uses them.  One thread per read
// lane: a committed read gathers its F0 value from the epoch-start table
// (one uint32, or the row's tup/4 four-byte words as K3 moves them) and
// its slot's H ring entries; v* is the largest entry <= the txn's ts
// (0 = the load-time base) and has_newer says some entry is larger, in
// which case the value is rebuilt from the law f(key, v*) (value_law.cuh).
// The uint32 checksum (a byte sum in full-row mode) wraps, so a block
// reduction plus one atomicAdd per block is exact in any order.  It must
// run before any store of the epoch, as K3's gather does.
//   Bound: bytes — per lane its key, slot, flag and txn ts; per committed
//   read one F0 value (4 or tup bytes) and one ring row (4H bytes).
//
// K12d dt_version_push replaces :257 VersionRing.push_rows.  One thread per
// lane: a winner (one per row per epoch, from K10) re-reads its row's H
// entries, takes the first minimum (jnp.argmin's tie order) and stores its
// order there.  Re-reading instead of reusing the reference's pre-gathered
// rows is exact: only this launch writes the ring, one lane per row, after
// K12c's reads in stream order.  Non-winning lanes write nothing (the
// reference steers them onto the ring's last row with unspecified values).
//   Bound: bytes — the lanes' slot, order and flag, and one ring row read
//   and one entry written per winner.
#include "common.cuh"
#include "value_law.cuh"

namespace {

struct AddOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

__global__ void version_read_kernel(const uint8_t* __restrict__ f0, int tup,
                                    const int32_t* __restrict__ keys,
                                    const int32_t* __restrict__ slots,
                                    const uint8_t* __restrict__ rmask,
                                    const int32_t* __restrict__ ver_ts, int A,
                                    const int32_t* __restrict__ ring, int H,
                                    int n, uint32_t* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t s = 0u;
  if (i < n && rmask[i]) {
    const int32_t slot = slots[i];
    const int32_t t = ver_ts[i / A];
    int32_t vstar = 0;
    bool newer = false;
    for (int h = 0; h < H; ++h) {
      const int32_t e = ring[static_cast<size_t>(slot) * H + h];
      if (e > t)
        newer = true;
      else
        vstar = max(vstar, e);
    }
    const uint32_t fp = fp_law(static_cast<uint32_t>(keys[i]),
                               static_cast<uint32_t>(vstar));
    if (tup == 0) {
      s = newer ? fp : reinterpret_cast<const uint32_t*>(f0)[slot];
    } else {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          f0 + static_cast<size_t>(slot) * tup);
      for (int u = 0; u < tup / 4; ++u)
        s += byte_sum(newer ? word_law(fp, 4u * static_cast<uint32_t>(u))
                            : row[u]);
    }
  }
  s = dt_block_reduce(s, AddOp(), 0u);
  if (threadIdx.x == 0) atomicAdd(acc, s);
}

__global__ void version_push_kernel(const int32_t* __restrict__ slots, int n,
                                    const int32_t* __restrict__ wts,
                                    const uint8_t* __restrict__ mask,
                                    int32_t* __restrict__ ring, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  int32_t* row = ring + static_cast<size_t>(slots[i]) * H;
  int p = 0;
  int32_t m = row[0];
  for (int h = 1; h < H; ++h)
    if (row[h] < m) {
      m = row[h];
      p = h;
    }
  row[p] = wts[i];
}

}  // namespace

DT_EXPORT int dt_version_read(const void* f0, int tup, const int32_t* keys,
                              const int32_t* slots, const uint8_t* rmask,
                              const int32_t* ver_ts, int A,
                              const int32_t* ring, int H, int n,
                              uint32_t* acc, void* stream) {
  const cudaStream_t s = dt_stream(stream);
  cudaMemsetAsync(acc, 0, sizeof(uint32_t), s);
  const int threads = 256;
  version_read_kernel<<<dt_blocks(n, threads), threads, 0, s>>>(
      static_cast<const uint8_t*>(f0), tup, keys, slots, rmask, ver_ts, A,
      ring, H, n, acc);
  return dt_status();
}

DT_EXPORT int dt_version_push(const int32_t* slots, int n, const int32_t* wts,
                              const uint8_t* mask, int32_t* ring, int H,
                              void* stream) {
  const int threads = 256;
  version_push_kernel<<<dt_blocks(n, threads), threads, 0,
                        dt_stream(stream)>>>(slots, n, wts, mask, ring, H);
  return dt_status();
}
