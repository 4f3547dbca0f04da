// K14c + K14d: the batched table writes of TPC-C's executor.
//
// K14c replaces deneva_tpu/storage/table.py:126 DeviceTable.scatter_add:
// many lanes add into many columns of a table (W_YTD, D_YTD, the
// customer's balance / YTD / count, D_NEXT_O_ID, S_REMOTE_CNT), exact
// under duplicate slots; a masked lane, or a slot outside [0, capacity),
// adds nothing (the reference steers it onto its trash row).  One launch
// takes up to three tables (TPC-C's Payment: WAREHOUSE, DISTRICT and
// CUSTOMER), one block each; the tables are disjoint, so the blocks are
// independent.
// Design: a one-table call with only int32 columns takes one thread per
// lane and atomicAdd — integer addition is exact in any order.  A float32
// column must match the reference's scatter-add, which on the CPU adds a
// slot's lanes one after another in lane order onto the old value; no
// float atomic and no tree sum gives that rounding.  So such a call groups
// its lanes by slot with a stable LSD radix sort in one block: 32-bit keys
// (the slot, or capacity for a lane that adds nothing), one pass per 8
// bits of capacity's width (1 at 64 warehouses' WAREHOUSE, 2 for DISTRICT,
// 3 for CUSTOMER's 1,920,000 rows), each pass a warp rank by eight
// ballots, one scan of the 256 digits' warp counts and a scatter
// in shared memory; the lane order comes from the sort's stability.  The
// lanes sit in registers, warp-striped, IPT a thread.  Then every column's
// value is staged in sorted order with its row's old value (one round of
// loads for up to four columns), the segments' heads are listed in order
// (warp ballots), and one thread a head adds its lanes in order onto the
// old value and writes the row once (__fadd_rn, so nvcc contracts
// nothing; int32 columns of the call add in the same walk).  A call with
// more lanes than a block holds (4,096 up to 5 columns, 2,048 up to 11,
// else 1,024) runs as chunks of lanes, one launch after another on the
// stream; each chunk adds onto what the chunks before it left, so every
// slot still sums its lanes in lane order.
//   Bound: bytes — each lane's slot, mask and values read once, each
//   touched row read and written once.  The ordered path is latency-
//   bound instead: a few barriers a pass, and its longest segment (all
//   payments of one warehouse) is a serial chain of adds.
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

constexpr int kMaxTabs = 3;
constexpr int kAddThreads = 256;
constexpr int kAddWarps = kAddThreads / 32;
constexpr int kBins = 256;                     // 8-bit digits
constexpr int kStageCols = 4;                  // columns staged at once
constexpr size_t kAddSmem = 200 * 1024;        // dynamic shared, ordered path
static_assert(kAddThreads == kBins, "one digit per thread");

struct AddTab {
  const int32_t* slots;
  int capacity;
  int passes;                                  // 8-bit digit passes
  Cols c;
};

struct AddTabs {
  AddTab t[kMaxTabs];
};

// One block a table (blockIdx.x), lanes [off, off + 256 IPT) of n.
// Shared: keys and lanes of the chunk in sorted order (the lanes' words
// then hold the segments' heads), then each column's values in that
// order, then each column's old row values.
// The lanes of the warp whose 8-bit digit equals d: eight ballots, which
// cost the same whatever the digits (__match_any_sync slows with the
// number of distinct values).
__device__ __forceinline__ uint32_t same_digit(uint32_t d) {
  uint32_t peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t v = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? v : ~v;
  }
  return peers;
}

template <int IPT>
__global__ void __launch_bounds__(kAddThreads)
scatter_add_ordered_kernel(const uint8_t* __restrict__ mask, int off, int n,
                           int kmax, const __grid_constant__ AddTabs tabs) {
  constexpr int kChunk = kAddThreads * IPT;
  constexpr int kSpan = 32 * IPT;              // positions of a warp
  extern __shared__ uint32_t sm[];
  uint32_t* skey = sm;
  uint32_t* slane = sm + kChunk;              // kChunk + 1 words
  uint32_t* sval = sm + 2 * kChunk + 1;
  uint32_t* sold = sval + static_cast<size_t>(kmax) * kChunk;
  __shared__ uint32_t wcnt[kAddWarps][kBins];
  __shared__ uint32_t dstart[kBins];
  const AddTab& tb = tabs.t[blockIdx.x];
  const Cols& c = tb.c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t cap = static_cast<uint32_t>(tb.capacity);
  const int m = min(kChunk, n - off);
  // every lane's slot and mask loaded at once (a pad lane reads lane 0)
  uint32_t key[IPT], ln[IPT];
  int32_t sl[IPT];
  uint8_t mk[IPT];
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    const int pos = warp * kSpan + u * 32 + lane;
    const int i = off + (pos < m ? pos : 0);
    sl[u] = tb.slots[i];
    mk[u] = mask == nullptr ? 1 : mask[i];
    ln[u] = pos;
  }
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    const bool ok = ln[u] < m && mk[u] != 0 && sl[u] >= 0 &&
                    sl[u] < tb.capacity;
    key[u] = ok ? static_cast<uint32_t>(sl[u]) : cap;  // cap: adds nothing
  }
  for (int p = 0; p < tb.passes; ++p) {
    const int shift = 8 * p;
    for (int d = lane; d < kBins; d += 32) wcnt[warp][d] = 0u;
    __syncwarp();
    uint32_t dg[IPT], rk[IPT], peers[IPT];
#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      dg[u] = (key[u] >> shift) & (kBins - 1);
      peers[u] = same_digit(dg[u]);
    }
    // stable rank inside the warp, positions in (item, lane) order: the
    // highest lane of a digit's peers adds their count to the warp's (the
    // warp issues item u's adds before item u + 1's)
#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      const int leader = 31 - __clz(peers[u]);
      uint32_t before = 0u;
      if (lane == leader)
        before = atomicAdd(&wcnt[warp][dg[u]], __popc(peers[u]));
      before = __shfl_sync(0xffffffffu, before, leader);
      rk[u] = before + __popc(peers[u] & ((1u << lane) - 1u));
    }
    __syncthreads();
    // thread t owns digit t: its warps' offsets, then the digits' starts
    uint32_t cnt = 0u;
#pragma unroll
    for (int w = 0; w < kAddWarps; ++w) {
      const uint32_t x = wcnt[w][tid];
      wcnt[w][tid] = cnt;
      cnt += x;
    }
    uint32_t unused;
    dstart[tid] = dt_block_incl_scan(cnt, AddOp(), 0u, unused) - cnt;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      const uint32_t at = dstart[dg[u]] + wcnt[warp][dg[u]] + rk[u];
      skey[at] = key[u];
      slane[at] = ln[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      const int pos = warp * kSpan + u * 32 + lane;
      key[u] = skey[pos];
      ln[u] = slane[pos];
    }
  }
  // each column's value of every lane in sorted order, and its row's old
  // value (a dropped or pad lane reads lane 0 and the row at capacity, the
  // trash row, and uses neither): a round of loads for kStageCols columns
  for (int j0 = 0; j0 < c.k; j0 += kStageCols) {
    uint32_t v[kStageCols][IPT], o[kStageCols][IPT];
#pragma unroll
    for (int jj = 0; jj < kStageCols; ++jj) {
      if (j0 + jj >= c.k) break;
      const uint32_t* val = static_cast<const uint32_t*>(c.val[j0 + jj]);
      const uint32_t* col = static_cast<const uint32_t*>(c.col[j0 + jj]);
#pragma unroll
      for (int u = 0; u < IPT; ++u) {
        v[jj][u] = val[off + (ln[u] < m ? ln[u] : 0)];
        o[jj][u] = col[key[u]];
      }
    }
#pragma unroll
    for (int jj = 0; jj < kStageCols; ++jj) {
      if (j0 + jj >= c.k) break;
#pragma unroll
      for (int u = 0; u < IPT; ++u) {
        const int pos = warp * kSpan + u * 32 + lane;
        sval[(j0 + jj) * kChunk + pos] = v[jj][u];
        sold[(j0 + jj) * kChunk + pos] = o[jj][u];
      }
    }
  }
  // the segments' heads in position order, into `heads` (over the lanes,
  // no longer needed); heads[n_heads] = the live lanes, so a segment ends
  // where the next begins
  uint32_t* heads = slane;
  uint32_t wh[IPT];
  uint32_t n_head = 0u, n_live = 0u;
#pragma unroll
  for (int u = 0; u < IPT; ++u) {
    const int pos = warp * kSpan + u * 32 + lane;
    const bool live = key[u] != cap;
    const bool head = live && (pos == 0 || skey[pos - 1] != key[u]);
    const uint32_t hb = __ballot_sync(0xffffffffu, head);
    wh[u] = head ? n_head + __popc(hb & ((1u << lane) - 1u)) : ~0u;
    n_head += __popc(hb);
    n_live += __popc(__ballot_sync(0xffffffffu, live));
  }
  if (lane == 0) {
    wcnt[0][warp] = n_head;
    wcnt[1][warp] = n_live;
  }
  __syncthreads();
  uint32_t base = 0u, total = 0u, live_total = 0u;
  for (int w = 0; w < kAddWarps; ++w) {
    base += w < warp ? wcnt[0][w] : 0u;
    total += wcnt[0][w];
    live_total += wcnt[1][w];
  }
#pragma unroll
  for (int u = 0; u < IPT; ++u)
    if (wh[u] != ~0u) heads[base + wh[u]] = warp * kSpan + u * 32 + lane;
  if (tid == 0) heads[total] = live_total;
  __syncthreads();
  // a head's thread adds its segment's lanes in order onto the old value
  for (uint32_t h = tid; h < total; h += kAddThreads) {
    const uint32_t pos = heads[h], end = heads[h + 1];
    const uint32_t s = skey[pos];
    for (int j = 0; j < c.k; ++j) {
      const uint32_t* v = sval + j * kChunk;
      uint32_t acc = sold[j * kChunk + pos];
      if (c.is_float[j]) {
        float a = __uint_as_float(acc);
        for (uint32_t q = pos; q < end; ++q)
          a = __fadd_rn(a, __uint_as_float(v[q]));
        acc = __float_as_uint(a);
      } else {
        for (uint32_t q = pos; q < end; ++q) acc += v[q];
      }
      static_cast<uint32_t*>(c.col[j])[s] = acc;
    }
  }
}

template <int IPT>
int launch_ordered(const uint8_t* mask, int n, int tabs, int kmax,
                   const AddTabs& at, cudaStream_t s) {
  constexpr int kChunk = kAddThreads * IPT;
  const size_t smem = (static_cast<size_t>(2 + 2 * kmax) * kChunk + 1) * 4;
  // dynamic and static shared memory together may pass the default 48 KB
  if (cudaFuncSetAttribute(scatter_add_ordered_kernel<IPT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return dt_status();
  for (int off = 0; off < n; off += kChunk)
    scatter_add_ordered_kernel<IPT><<<tabs, kAddThreads, smem, s>>>(
        mask, off, n, kmax, at);
  return dt_status();
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

// K14c: n lanes add, for each of `tabs` tables (at most kMaxTabs, with
// disjoint columns), vals[j][lane] into cols[j][slots_t[lane]] for its
// k[t] columns, each int32 (is_float[j] == 0) or float32, unless the
// shared mask (or null) drops the lane or the slot lies outside
// [0, capacity[t]).  `slots`, `capacity` and `k` are host arrays of `tabs`
// entries; `cols`, `vals` and `is_float` host arrays of sum(k) entries,
// table by table.
DT_EXPORT int dt_scatter_add(int tabs, const int32_t* const* slots,
                             const uint8_t* mask, int n, const int* capacity,
                             const int* k, void* const* cols,
                             const void* const* vals, const int* is_float,
                             void* stream) {
  if (tabs < 1 || tabs > kMaxTabs)
    return static_cast<int>(cudaErrorInvalidValue);
  AddTabs at;
  bool any_float = false;
  int kmax = 0;
  for (int t = 0, j0 = 0; t < tabs; j0 += k[t], ++t) {
    AddTab& tb = at.t[t];
    if (k[t] < 1 || capacity[t] < 1 ||
        fill_cols(tb.c, k[t], cols + j0, vals + j0, is_float + j0) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    tb.slots = slots[t];
    tb.capacity = capacity[t];
    int bits = 0;                              // keys in [0, capacity]
    while (bits < 31 && (capacity[t] >> bits) != 0) ++bits;
    tb.passes = (bits + 7) / 8;
    for (int j = 0; j < k[t]; ++j) any_float = any_float || tb.c.is_float[j];
    kmax = k[t] > kmax ? k[t] : kmax;
  }
  if (n <= 0) return dt_status();
  const cudaStream_t s = dt_stream(stream);
  if (tabs == 1 && !any_float) {
    scatter_add_atomic_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(
        slots[0], mask, n, capacity[0], at.t[0].c);
    return dt_status();
  }
  // the fewest lanes a thread that hold the call, while the chunk's keys,
  // lanes, values and old values fit the block's shared memory
  const size_t lane_bytes = 4 * (2 + 2 * static_cast<size_t>(kmax));
  if (n <= kAddThreads * 4 || lane_bytes * kAddThreads * 8 > kAddSmem)
    return launch_ordered<4>(mask, n, tabs, kmax, at, s);
  if (n <= kAddThreads * 8 || lane_bytes * kAddThreads * 16 > kAddSmem)
    return launch_ordered<8>(mask, n, tabs, kmax, at, s);
  return launch_ordered<16>(mask, n, tabs, kmax, at, s);
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
