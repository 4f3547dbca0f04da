// K14c + K14d: the batched table writes of TPC-C's executor.
//
// K14c replaces deneva_tpu/storage/table.py:126 DeviceTable.scatter_add:
// many lanes add into many columns of one table (W_YTD, D_YTD, the
// customer's balance / YTD / count, D_NEXT_O_ID, S_REMOTE_CNT), exact
// under duplicate slots; a masked lane, or a slot outside [0, capacity),
// adds nothing (the reference steers it onto its trash row).
// Design: a call with only int32 columns takes one thread per lane and
// atomicAdd — integer addition is exact in any order.  A float32 column
// must match the reference's scatter-add, which on the CPU adds a slot's
// lanes one after another in lane order onto the old value; no float
// atomic and no tree sum gives that rounding.  So a call with a float
// column runs in one block: (slot, lane) keys bitonic-sorted in shared
// memory, the values staged there in sorted order, and one thread per
// slot segment adds its lanes in order (__fadd_rn, so nvcc contracts
// nothing).  Int32 columns of the same call add in that walk too.  A
// call with more lanes than one block's shared memory holds (8,192 for
// three columns) runs as chunks of lanes, one launch after another on
// the stream; each chunk adds onto what the chunks before it left, so
// every slot still sums its lanes in lane order.
//   Bound: bytes — each lane's slot, mask and values read once, each
//   touched row read and written once.  The ordered path is latency-
//   bound instead: its longest segment (all payments of one warehouse)
//   is a serial chain of shared-memory adds.
//
// K14d replaces :137 DeviceTable.append: an exclusive scan of the insert
// mask from the device-resident row_cnt gives each inserted row its slot;
// a ring table's cursor runs free in int32 and slots take a floor
// modulo of the capacity, otherwise rows past capacity drop and the
// cursor clamps; every column's row is written and row_cnt advanced on
// the device, so the host never syncs.
//   Bound: bytes — the mask read, one row of every column written per
//   inserted lane, one slot written per lane.  One block scanning every
//   lane would be serial scans on one SM (ORDER-LINE's 30,720 lanes are
//   15 tiles), so the lanes form tiles of 2,048, one block each (512
//   threads, lane u * 512 + t of a tile on thread t, so a warp's loads
//   and, but at the ring's wrap, its stores are coalesced).
//   A tile ranks its inserted lanes by warp ballots and a scan of the
//   64 (item, warp) counts; every column's value of a thread's 4 lanes
//   is loaded while the block ranks them, so a call waits on one round
//   of loads whatever its column count.
//   One tile (n <= 2,048, three of TPC-C's four tables at 64 warehouses)
//   is one block that reads and writes row_cnt itself.  More tiles take
//   two launches: a count kernel (16-byte loads, a popc of the non-zero
//   bytes) writes each tile's count and copies row_cnt to scratch; the
//   write kernel's block sums the counts of the tiles before it, and only
//   the last tile writes row_cnt, so no block reads the cursor after it
//   moves.  No atomics, no memset.  At TPC-C's sizes the bytes take
//   under 0.2 us; what bounds a call is latency: its launches, one round
//   of loads, two barriers and the stores (PERF.md).
#include "common.cuh"

namespace {

constexpr int kMaxCols = 16;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit
constexpr unsigned long long kNoKey = ~0ull;

struct Cols {
  void* col[kMaxCols];
  const void* val[kMaxCols];
  int is_float[kMaxCols];
  int k;
};

struct AddOp {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

__device__ __forceinline__ bool live_slot(const int32_t* slots,
                                          const uint8_t* mask, int i,
                                          int capacity, int32_t& s) {
  s = slots[i];
  return (mask == nullptr || mask[i] != 0) && s >= 0 && s < capacity;
}

__global__ void scatter_add_atomic_kernel(const int32_t* __restrict__ slots,
                                          const uint8_t* __restrict__ mask,
                                          int n, int capacity, Cols c) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    int32_t s;
    if (!live_slot(slots, mask, i, capacity, s)) continue;
    for (int j = 0; j < c.k; ++j)
      atomicAdd(static_cast<int*>(c.col[j]) + s,
                static_cast<const int*>(c.val[j])[i]);
  }
}

// One block.  Shared memory: np2 sort keys, then c.k rows of np2 values.
__global__ void scatter_add_ordered_kernel(const int32_t* __restrict__ slots,
                                           const uint8_t* __restrict__ mask,
                                           int n, int np2, int capacity,
                                           Cols c) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;
  uint32_t* sval = reinterpret_cast<uint32_t*>(smem + np2);
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    int32_t s = 0;
    const bool ok = i < n && live_slot(slots, mask, i, capacity, s);
    key[i] = ok ? (static_cast<unsigned long long>(static_cast<uint32_t>(s))
                   << 32) | static_cast<uint32_t>(i)
                : kNoKey;
  }
  __syncthreads();
  // bitonic sort, ascending: (slot, lane), dropped lanes last
  for (int size = 2; size <= np2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (np2 >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = key[lo], b = key[hi];
        if ((a > b) == up) {
          key[lo] = b;
          key[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  // stage every column's value in sorted order
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const unsigned long long kk = key[p];
    if (kk == kNoKey) continue;
    const uint32_t lane = static_cast<uint32_t>(kk);
    for (int j = 0; j < c.k; ++j)
      sval[j * np2 + p] = static_cast<const uint32_t*>(c.val[j])[lane];
  }
  __syncthreads();
  // one thread per slot segment: its lanes in lane order onto the row
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const unsigned long long kk = key[p];
    if (kk == kNoKey) continue;
    const uint32_t s = static_cast<uint32_t>(kk >> 32);
    if (p > 0 && static_cast<uint32_t>(key[p - 1] >> 32) == s) continue;
    int end = p + 1;
    while (end < n && static_cast<uint32_t>(key[end] >> 32) == s) ++end;
    for (int j = 0; j < c.k; ++j) {
      const uint32_t* v = sval + j * np2;
      if (c.is_float[j]) {
        float* col = static_cast<float*>(c.col[j]);
        float acc = col[s];
        for (int q = p; q < end; ++q) acc = __fadd_rn(acc, __uint_as_float(v[q]));
        col[s] = acc;
      } else {
        uint32_t* col = static_cast<uint32_t*>(c.col[j]);
        uint32_t acc = col[s];
        for (int q = p; q < end; ++q) acc += v[q];
        col[s] = acc;
      }
    }
  }
}

constexpr int kAppendThreads = 512;
constexpr int kAppendItems = 4;                  // lanes a thread holds
constexpr int kAppendTile = kAppendThreads * kAppendItems;
constexpr int kAppendWarps = kAppendThreads / 32;
static_assert(kAppendItems * kAppendWarps == 64, "two counts a lane");

// Non-zero bytes of a word (a bool mask holds 0 or 1; any non-zero byte
// inserts, as `mask[i] != 0`).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return __popc((((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u);
}

// scratch[t] = inserted lanes of tile t; scratch[tiles] = *row_cnt.
__global__ void __launch_bounds__(kAppendThreads)
append_count_kernel(const uint8_t* __restrict__ mask, int n, int vec,
                    const int32_t* __restrict__ row_cnt,
                    int32_t* __restrict__ scratch) {
  const long long t0 = static_cast<long long>(blockIdx.x) * kAppendTile;
  const int len = static_cast<int>(min(static_cast<long long>(kAppendTile),
                                       n - t0));
  uint32_t c = 0u;
  if (vec && len == kAppendTile) {
    const uint4* m4 = reinterpret_cast<const uint4*>(mask + t0);
    for (int q = threadIdx.x; q < kAppendTile / 16; q += kAppendThreads) {
      const uint4 w = m4[q];
      c += nonzero_bytes(w.x) + nonzero_bytes(w.y) + nonzero_bytes(w.z) +
           nonzero_bytes(w.w);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kAppendThreads)
      c += mask[t0 + i] != 0 ? 1u : 0u;
  }
  c = dt_block_reduce(c, AddOp(), 0u);
  if (threadIdx.x == 0) {
    scratch[blockIdx.x] = static_cast<int32_t>(c);
    if (blockIdx.x == 0) scratch[gridDim.x] = *row_cnt;
  }
}

// One block a tile.  SINGLE: the only tile, which reads the cursor from
// row_cnt; otherwise from scratch (append_count_kernel's), with the
// tiles' counts before it.
template <bool SINGLE>
__global__ void __launch_bounds__(kAppendThreads)
append_write_kernel(const uint8_t* __restrict__ mask, int n,
                    int32_t* __restrict__ row_cnt,
                    const int32_t* __restrict__ scratch, int capacity,
                    int ring, Cols c, int32_t* __restrict__ slots_out) {
  __shared__ uint32_t off_s[kAppendItems * kAppendWarps];
  __shared__ uint32_t pre_s, tot_s;
  __shared__ int32_t base_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long t0 = static_cast<long long>(blockIdx.x) * kAppendTile;
  long long at[kAppendItems];
#pragma unroll
  for (int u = 0; u < kAppendItems; ++u) at[u] = t0 + u * kAppendThreads + t;
  // every column's value of the thread's lanes, loaded beside the mask
  // and consumed after the rank: one round of loads (the lanes that
  // insert nothing load too; their values go nowhere)
  uint32_t v[kMaxCols][kAppendItems];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j)
#pragma unroll
    for (int u = 0; u < kAppendItems; ++u)
      if (j < c.k && at[u] < n)
        v[j][u] = __ldg(static_cast<const uint32_t*>(c.val[j]) + at[u]);
  // item-major lane order: (item u, warp w) counts, then their scan
  uint32_t bal[kAppendItems];
  bool m[kAppendItems];
#pragma unroll
  for (int u = 0; u < kAppendItems; ++u) {
    m[u] = at[u] < n && mask[at[u]] != 0;
    bal[u] = __ballot_sync(0xffffffffu, m[u]);
    if (lane == 0) off_s[u * kAppendWarps + warp] = __popc(bal[u]);
  }
  // the tile's base: the cursor, and the inserted lanes of the tiles
  // before it
  if (SINGLE) {
    if (t == 0) {
      pre_s = 0u;
      base_s = *row_cnt;
    }
  } else {
    uint32_t pre = 0u;
    for (int q = t; q < static_cast<int>(blockIdx.x); q += kAppendThreads)
      pre += static_cast<uint32_t>(scratch[q]);
    pre = dt_block_reduce(pre, AddOp(), 0u);
    if (t == 0) {
      pre_s = pre;
      base_s = scratch[gridDim.x];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t a = off_s[2 * lane], b = off_s[2 * lane + 1];
    uint32_t incl = a + b;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    off_s[2 * lane] = incl - a - b;
    off_s[2 * lane + 1] = incl - b;
    if (lane == 31) tot_s = incl;
  }
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(base_s) + pre_s;
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kAppendItems; ++u) {
    int32_t slot = capacity;
    if (m[u]) {
      // row_cnt + offset in wrapping int32, as the reference's cursor
      const int32_t s = static_cast<int32_t>(
          base + off_s[u * kAppendWarps + warp] + __popc(bal[u] & below));
      if (ring) {
        const int32_t r = s % capacity;
        slot = r < 0 ? r + capacity : r;
      } else if (s < capacity) {
        slot = s;
      }
    }
    if (at[u] < n) slots_out[at[u]] = slot;
    if (static_cast<uint32_t>(slot) < static_cast<uint32_t>(capacity)) {
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < c.k) static_cast<uint32_t*>(c.col[j])[slot] = v[j][u];
    }
  }
  if (t == 0 && blockIdx.x == gridDim.x - 1) {
    int32_t cnt = static_cast<int32_t>(base + tot_s);
    if (!ring && cnt > capacity) cnt = capacity;
    *row_cnt = cnt;
  }
}

int fill_cols(Cols& c, int k, void* const* cols, const void* const* vals,
              const int* is_float) {
  if (k < 0 || k > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  c.k = k;
  for (int j = 0; j < k; ++j) {
    c.col[j] = cols[j];
    c.val[j] = vals[j];
    c.is_float[j] = is_float == nullptr ? 0 : is_float[j];
  }
  return 0;
}

}  // namespace

// K14c: n lanes (slot, optional mask) add vals[j][lane] into cols[j][slot]
// for k columns, each int32 (is_float[j] == 0) or float32.  `cols`, `vals`
// and `is_float` are host arrays of k entries.
DT_EXPORT int dt_scatter_add(const int32_t* slots, const uint8_t* mask, int n,
                             int capacity, int k, void* const* cols,
                             const void* const* vals, const int* is_float,
                             void* stream) {
  Cols c;
  if (k < 1 || fill_cols(c, k, cols, vals, is_float) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return dt_status();
  bool any_float = false;
  for (int j = 0; j < k; ++j) any_float = any_float || c.is_float[j] != 0;
  const cudaStream_t s = dt_stream(stream);
  if (!any_float) {
    scatter_add_atomic_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(slots, mask, n,
                                                                capacity, c);
    return dt_status();
  }
  // lanes per launch: the largest power of two whose sort keys and
  // staged values fit one block's shared memory
  const size_t lane_bytes = 8 + 4 * static_cast<size_t>(k);
  int chunk = 1;
  while (2 * static_cast<size_t>(chunk) * lane_bytes <= kMaxSmem) chunk <<= 1;
  int np2 = 1;
  while (np2 < n && np2 < chunk) np2 <<= 1;
  const size_t smem = static_cast<size_t>(np2) * lane_bytes;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(scatter_add_ordered_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  for (int off = 0; off < n; off += chunk) {
    const int m = n - off < chunk ? n - off : chunk;
    int p2 = 1;
    while (p2 < m) p2 <<= 1;
    Cols cc = c;
    for (int j = 0; j < k; ++j)
      cc.val[j] = static_cast<const uint32_t*>(c.val[j]) + off;
    scatter_add_ordered_kernel<<<1, 1024, static_cast<size_t>(p2) * lane_bytes,
                                 s>>>(slots + off,
                                      mask == nullptr ? nullptr : mask + off,
                                      m, p2, capacity, cc);
  }
  return dt_status();
}

// K14d: append the rows of the n masked lanes (k 4-byte columns) at
// prefix-sum slots from *row_cnt; writes each lane's slot (capacity where
// nothing was written) and advances *row_cnt, all on the device.
// `scratch` holds `scratch_len` int32, at least a count a tile and one
// more when n > kAppendTile (else it may be null).
DT_EXPORT int dt_append(const uint8_t* mask, int n, int32_t* row_cnt,
                        int capacity, int ring, int k, void* const* cols,
                        const void* const* vals, int32_t* scratch,
                        int scratch_len, int32_t* slots, void* stream) {
  Cols c;
  if (capacity <= 0 || n < 0 || fill_cols(c, k, cols, vals, nullptr) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = dt_stream(stream);
  const int tiles = (n + kAppendTile - 1) / kAppendTile;
  if (tiles <= 1) {
    append_write_kernel<true><<<1, kAppendThreads, 0, s>>>(
        mask, n, row_cnt, nullptr, capacity, ring, c, slots);
    return dt_status();
  }
  if (scratch == nullptr || scratch_len < tiles + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  append_count_kernel<<<tiles, kAppendThreads, 0, s>>>(mask, n, vec, row_cnt,
                                                       scratch);
  append_write_kernel<false><<<tiles, kAppendThreads, 0, s>>>(
      mask, n, row_cnt, scratch, capacity, ring, c, slots);
  return dt_status();
}
