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
// the device, so the host never syncs.  One block loops over the lanes
// in chunks of 1024 (the block scan of common.cuh plus a carry).
//   Bound: bytes — the mask read, one row of every column written per
//   inserted lane, one slot written per lane.
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

__global__ void append_kernel(const uint8_t* __restrict__ mask, int n,
                              int32_t* __restrict__ row_cnt, int capacity,
                              int ring, Cols c,
                              int32_t* __restrict__ slots_out) {
  __shared__ int32_t base_s;
  if (threadIdx.x == 0) base_s = *row_cnt;
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(base_s);
  uint32_t carry = 0u;  // inserted lanes before this chunk
  for (int start = 0; start < n; start += blockDim.x) {
    const int i = start + threadIdx.x;
    const uint32_t m = (i < n && mask[i] != 0) ? 1u : 0u;
    uint32_t total;
    const uint32_t incl = dt_block_incl_scan(m, AddOp(), 0u, total);
    if (i < n) {
      int32_t slot = capacity;
      if (m) {
        // row_cnt + offset in wrapping int32, as the reference's cursor
        const int32_t s = static_cast<int32_t>(base + carry + incl - 1u);
        if (ring) {
          int32_t r = s % capacity;
          slot = r < 0 ? r + capacity : r;
        } else if (s < capacity) {
          slot = s;
        }
      }
      slots_out[i] = slot;
      if (slot < capacity)
        for (int j = 0; j < c.k; ++j)
          static_cast<uint32_t*>(c.col[j])[slot] =
              static_cast<const uint32_t*>(c.val[j])[i];
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    int32_t cnt = static_cast<int32_t>(base + carry);
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
DT_EXPORT int dt_append(const uint8_t* mask, int n, int32_t* row_cnt,
                        int capacity, int ring, int k, void* const* cols,
                        const void* const* vals, int32_t* slots,
                        void* stream) {
  Cols c;
  if (capacity <= 0 || fill_cols(c, k, cols, vals, nullptr) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  append_kernel<<<1, 1024, 0, dt_stream(stream)>>>(mask, n, row_cnt, capacity,
                                                   ring, c, slots);
  return dt_status();
}
