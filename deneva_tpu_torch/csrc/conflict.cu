// K5+K6, K7, K8: the OCC sweep's conflict detection.
//
// K5+K6 dt_build_incidence replaces deneva_tpu/ops/hashing.py:25
// combine_key and :37 bucket_hash together with deneva_tpu/ops/conflict.py:47
// access_incidence, as deneva_tpu/cc/base.py:587 build_incidence calls
// them: every lane is hashed in one or two families, and each requested
// view (r, w, u, pr and their ordered copies) becomes a bf16[B, K] row of
// bucket counts; family 0's bucket ids are written as well.
//   Bound: bytes — the count rows (B x K bf16 per view and family) are
//   written whole, zeros included.  One warp owns one row: it zeroes the
//   row with 16-byte stores, then each lane hashes one access and the
//   lowest lane of each group of equal buckets (__match_any_sync) adds
//   the group's size, so no two lanes write one count and no atomics are
//   needed.  Counts are small integers, exact in bf16 up to 256 (A <= 256).
//
// K7 dt_overlap replaces deneva_tpu/ops/conflict.py:63 overlap:
// (A1 B1^T > 0) AND (A2 B2^T > 0) over bf16 count rows.
//   Precondition: every caller passes K5+K6 count rows (non-negative
//   integers <= 256), so (A B^T)[i, j] > 0 holds exactly when some bucket
//   k has A[i, k] > 0 and B[j, k] > 0: nothing cancels, nothing
//   underflows.  The kernel computes that bucket intersection.
//   Bound: bytes — reading the four B x K bf16 inputs once and writing the
//   bool matrix.  The dense product would be operations-bound (34 G at B
//   = 1024, K = 8192) while the rows hold a handful of non-zeros each, so
//   the tensor cores are not used.  Two launches:
//   (1) bitmaps of the B side: bits[f][k][w] bit j says B_f[32w + j, k] >
//       0.  A warp reads 32 rows of a 256-bucket chunk with 16-byte loads
//       (lane l holds buckets 8l..8l+7 of each row) and sets the bits in
//       registers; the eight warps of a block (eight consecutive words)
//       stage their words through shared memory (row stride 9, each lane
//       starting at another bucket: no bank conflicts) so each bucket's
//       eight words leave as one 32-byte store.  Every word is written
//       once: no atomics, no zeroing.  1 MB per family at N = 1024, 2 MB
//       at 2048: it stays in L2.
//   (2) rows of the A side: four warps split row i's buckets, stream
//       A_f[i, :] once with 16-byte loads, find the positive buckets by
//       ballot, and OR those buckets' bitmap rows (two words a lane: 2048
//       columns; wider N runs in segments of 2048 on grid.y) into
//       registers; shared memory ORs the four quarters, ANDs the
//       families, and the bool row leaves in 4-byte stores.
//   A bf16 count is positive when its bits are non-zero and its sign bit
//   is clear.  A dense row (many buckets) loops longer and stays exact.
//
// K8 dt_first_fit replaces deneva_tpu/ops/conflict.py:78 earlier_edges
// fused into :96 greedy_first_fit.  Two launches.
//   (1) The pack: E[i, j] = conflict[i, j] & active[i] & active[j] &
//       (rank, lane)_j < (rank, lane)_i as bits, and each row's edge
//       count, over a grid of 32 x 256 tiles: 16-byte loads of `conflict`
//       into shared memory beside the tile's ranks and flags, one ballot
//       per 32 columns.
//   (2) The sweep, in one thread-block cluster of C CTAs, launched to
//       overlap the pack's tail: CTA r owns a slice of the rows and holds
//       their edge bits in shared memory (one bulk asynchronous copy
//       behind an mbarrier; C = 1 up to B = 1,280, C = 2, 4, 8 up to
//       1,792, 2,688, 3,712; past that C = 8 reads the rows from L2),
//       with full copies of the win / lose / active sets.  A round is one
//       Jacobi step, exactly the reference's update order.  Round 0 reads
//       no row (a row wins iff it has no edge); later rounds list the
//       pending rows (active, not yet won or lost) and give each a lane
//       that ORs the row against the round's sets 16 bytes a step (W
//       padded to a multiple of 4 words).  The verdicts
//       land in the next sets, and every CTA stores its words into the
//       others through distributed shared memory (st.async, counted on
//       the receiver's mbarrier: no cluster-wide barrier a round).  A
//       round that changes nothing leaves every later round unchanged,
//       so the loop stops there, in every CTA at once.
//   Bound: bytes — reading the B x B bool conflict matrix once.
#include "cluster.cuh"
#include "common.cuh"
#include "hashing.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kViews = 8;   // r, w, u, pr, uo, ro, wo, pro

struct IncOut {
  __nv_bfloat16* p[2][kViews];
};

__global__ void incidence_kernel(const int32_t* __restrict__ table_ids,
                                 const int32_t* __restrict__ keys,
                                 const uint8_t* __restrict__ is_read,
                                 const uint8_t* __restrict__ is_write,
                                 const uint8_t* __restrict__ valid,
                                 const uint8_t* __restrict__ active,
                                 const uint8_t* __restrict__ order_free,
                                 int B, int A, int K, IncOut out,
                                 int32_t* __restrict__ bucket1) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int fam = blockIdx.y;
  if (row >= B) return;   // whole warps leave together
  const size_t base = static_cast<size_t>(row) * K;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int v = 0; v < kViews; ++v) {
    __nv_bfloat16* p = out.p[fam][v];
    if (p == nullptr) continue;
    uint4* r4 = reinterpret_cast<uint4*>(p + base);
    for (int c = lane; c < K / 8; c += 32) r4[c] = zero;
  }
  __syncwarp();
  const bool act = active[row] != 0;
  const uint32_t kmask = static_cast<uint32_t>(K - 1);
  for (int c0 = 0; c0 < A; c0 += 32) {
    const int l = c0 + lane;
    const bool in = l < A;
    const size_t at = static_cast<size_t>(row) * A + l;
    uint32_t b = 0u;
    bool r = false, w = false, of = true;
    if (in) {
      b = bucket_of(table_ids[at], keys[at], fam, kmask);
      if (fam == 0 && bucket1 != nullptr) bucket1[at] = static_cast<int32_t>(b);
      const bool v = act && valid[at] != 0;
      r = v && is_read[at] != 0;
      w = v && is_write[at] != 0;
      of = order_free == nullptr || order_free[at] == 0;
    }
    const bool pr = r && !w;
    const bool m[kViews] = {r, w, r || w, pr, (r || w) && of, r && of,
                            w && of, pr && of};
    const unsigned peers_all = __match_any_sync(0xffffffffu, b);
#pragma unroll
    for (int v = 0; v < kViews; ++v) {
      __nv_bfloat16* p = out.p[fam][v];
      if (p == nullptr) continue;
      const unsigned peers = peers_all & __ballot_sync(0xffffffffu, m[v]);
      if (m[v] && lane == __ffs(peers) - 1) {
        __nv_bfloat16* cell = p + base + b;
        *cell = __float2bfloat16(__bfloat162float(*cell) +
                                 static_cast<float>(__popc(peers)));
      }
    }
    __syncwarp();
  }
}

// ---- K7 -------------------------------------------------------------

constexpr int kChunk = 256;        // buckets of one warp-wide 16-byte load
constexpr int kBitsWarps = 8;      // words (32-row groups) per bitmap block
constexpr int kSegWords = 64;      // output words a warp keeps (2 a lane)
constexpr int kRowsPerBlock = 2;   // output rows per row block
constexpr int kQuarters = 4;       // warps splitting one row's buckets
constexpr int kInFlight = 8;       // 16-byte loads in flight per lane

// bit e of the result: bf16 e of the 8 in v is > 0
__device__ __forceinline__ uint32_t positive8(const uint4 v) {
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0u;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint32_t lo = x[h] & 0xFFFFu, hi = x[h] >> 16;
    m |= static_cast<uint32_t>(lo != 0u && !(lo & 0x8000u)) << (2 * h);
    m |= static_cast<uint32_t>(hi != 0u && !(hi & 0x8000u)) << (2 * h + 1);
  }
  return m;
}

__device__ __forceinline__ uint32_t pick8(const uint32_t (&w)[8], int c) {
  uint32_t v = w[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) v = c == i ? w[i] : v;
  return v;
}

// grid (ceil(K / 256), ceil(W / 8), families), 256 threads.
__global__ void __launch_bounds__(kBitsWarps * 32)
overlap_bits_kernel(const __nv_bfloat16* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ b2, int N, int K, int W,
                    uint32_t* __restrict__ bits) {
  __shared__ uint32_t s[kChunk * (kBitsWarps + 1)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fam = blockIdx.z;
  const __nv_bfloat16* Bm = fam ? b2 : b1;
  const int k0 = blockIdx.x * kChunk, col = k0 + 8 * lane;
  const int w = blockIdx.y * kBitsWarps + warp;
  uint32_t wd[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  if (w < W && col < K) {
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += kInFlight) {
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int j = w * 32 + j0 + u;
        v[u] = j < N ? *reinterpret_cast<const uint4*>(
                           Bm + static_cast<size_t>(j) * K + col)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const uint32_t m = positive8(v[u]);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if ((m >> c) & 1u) wd[c] |= 1u << (j0 + u);
      }
    }
  }
  // s[k][warp]: lane l writes bucket 8l + c, c rotated by l / 4
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = (i + (lane >> 2)) & 7;
    s[(8 * lane + c) * (kBitsWarps + 1) + warp] = pick8(wd, c);
  }
  __syncthreads();
  uint32_t* out = bits + static_cast<size_t>(fam) * K * W;
#pragma unroll
  for (int i = 0; i < kChunk * kBitsWarps / (kBitsWarps * 32); ++i) {
    const int e = threadIdx.x + i * kBitsWarps * 32;
    const int kk = e / kBitsWarps, ww = e % kBitsWarps;
    const int k = k0 + kk, wg = blockIdx.y * kBitsWarps + ww;
    if (k < K && wg < W)
      out[static_cast<size_t>(k) * W + wg] = s[kk * (kBitsWarps + 1) + ww];
  }
}

// OR into acc the bitmap rows of the positive buckets of A[row, :] that
// fall in this warp's quarter (chunks q, q + 4, ...); words s0 .. s0 + 63.
__device__ __forceinline__ void or_row(const __nv_bfloat16* __restrict__ A,
                                       const uint32_t* __restrict__ bits,
                                       int row, int K, int W, int s0, int q,
                                       int lane, uint32_t (&acc)[2]) {
  const int nch = (K + kChunk - 1) / kChunk;
  const __nv_bfloat16* a = A + static_cast<size_t>(row) * K;
  const bool in0 = s0 + lane < W, in1 = s0 + 32 + lane < W;
  for (int c0 = q; c0 < nch; c0 += kQuarters * kInFlight) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int col = (c0 + kQuarters * u) * kChunk + 8 * lane;
      v[u] = col < K ? *reinterpret_cast<const uint4*>(a + col)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const uint32_t m = positive8(v[u]);
      uint32_t any = __ballot_sync(0xffffffffu, m != 0u);
      while (any) {
        const int src = __ffs(any) - 1;
        any &= any - 1u;
        uint32_t mm = __shfl_sync(0xffffffffu, m, src);
        const int base = (c0 + kQuarters * u) * kChunk + 8 * src;
        while (mm) {
          const int k = base + __ffs(mm) - 1;
          mm &= mm - 1u;
          const uint32_t* p = bits + static_cast<size_t>(k) * W + s0;
          if (in0) acc[0] |= p[lane];
          if (in1) acc[1] |= p[32 + lane];
        }
      }
    }
  }
}

// grid (ceil(M / 2), ceil(N / 2048)), 256 threads: warp = (row, quarter).
__global__ void __launch_bounds__(kRowsPerBlock * kQuarters * 32)
overlap_rows_kernel(const __nv_bfloat16* __restrict__ a1,
                    const __nv_bfloat16* __restrict__ a2,
                    const uint32_t* __restrict__ bits, int M, int N, int K,
                    int W, uint8_t* __restrict__ out) {
  __shared__ uint32_t red[kRowsPerBlock][2][kQuarters][kSegWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / kQuarters, q = warp % kQuarters;
  const int row = blockIdx.x * kRowsPerBlock + r;
  const int s0 = blockIdx.y * kSegWords;
  const bool two = a2 != nullptr;
  uint32_t acc1[2] = {0u, 0u}, acc2[2] = {0u, 0u};
  if (row < M) {
    or_row(a1, bits, row, K, W, s0, q, lane, acc1);
    if (two)
      or_row(a2, bits + static_cast<size_t>(K) * W, row, K, W, s0, q, lane,
             acc2);
  }
  red[r][0][q][lane] = acc1[0];
  red[r][0][q][32 + lane] = acc1[1];
  red[r][1][q][lane] = acc2[0];
  red[r][1][q][32 + lane] = acc2[1];
  __syncthreads();
  // 128 threads a row, four columns a thread
  const int t = threadIdx.x % (kQuarters * 32);
  const int col0 = blockIdx.y * kSegWords * 32;
  const int cols = min(kSegWords * 32, N - col0);
  if (row >= M) return;
  uint8_t* o = out + static_cast<size_t>(row) * N + col0;
  const bool vec = (N & 3) == 0;
  for (int c = 4 * t; c < cols; c += 4 * kQuarters * 32) {
    const int wi = c >> 5;
    uint32_t f1 = 0u, f2 = 0u;
#pragma unroll
    for (int qq = 0; qq < kQuarters; ++qq) {
      f1 |= red[r][0][qq][wi];
      f2 |= red[r][1][qq][wi];
    }
    const uint32_t m = ((two ? f1 & f2 : f1) >> (c & 31)) & 0xFu;
    if (vec) {
      *reinterpret_cast<uint32_t*>(o + c) =
          (m & 1u) | ((m >> 1) & 1u) << 8 | ((m >> 2) & 1u) << 16 |
          ((m >> 3) & 1u) << 24;
    } else {
      for (int e = 0; e < 4 && c + e < cols; ++e)
        o[c + e] = static_cast<uint8_t>((m >> e) & 1u);
    }
  }
}

// ---- K8 -------------------------------------------------------------

constexpr int kPackRows = 32;      // rows of one pack tile (one per word)
constexpr int kPackCols = 256;     // columns of one pack tile (8 words)
constexpr int kFfThreads = 1024;
constexpr int kMaxCtas = 8;        // the portable cluster size

// Words of a sweep CTA's shared memory: when they sit there, the owned
// rows' edge words (32 own rows of W words) and the list of a round's
// pending owned rows (32 own; else in global scratch); then win[2][W],
// lose[2][W], act[W], flags[2][kMaxCtas], two list counters and three
// 8-byte mbarriers (the copy's and a round's exchange by parity) with
// their alignment slack.  W is a multiple of 4, so the sets start 16-byte
// aligned.
__host__ __device__ __forceinline__ size_t ff_smem_words(int W, int own,
                                                         int in_smem) {
  const size_t tile = in_smem ? 32 * static_cast<size_t>(own) * (W + 1) : 0;
  return tile + 5 * static_cast<size_t>(W) + 2 * kMaxCtas + 10;
}

// bits[i * W + w] bit l = E[i, 32 w + l] for i < 32 W (rows past B are
// zero), and cnt[x][i] = row i's edges among columns [256 x, 256 x +
// 256).  grid (ceil(W / 8), W), 256 threads: the block stages a 32 x 256
// byte tile of `conflict` with 16-byte loads (`vec`: B % 16 == 0 and an
// aligned base) and the tile's ranks and active flags; warp k ballots
// rows k, k + 8, k + 16, k + 24, eight words each, and lane q keeps the
// q-th ballot (a select, no shifted insert: ROADMAP watch item 35), so
// each row's eight words leave as one 32-byte store; eight lanes then sum
// their row's popcounts.
__global__ void __launch_bounds__(256)
pack_edges_kernel(const uint8_t* __restrict__ conflict,
                  const int32_t* __restrict__ rank,
                  const uint8_t* __restrict__ active, int B, int W, int vec,
                  uint32_t* __restrict__ bits, int32_t* __restrict__ cnt) {
  __shared__ __align__(16) uint8_t tile[kPackRows][kPackCols];
  __shared__ int32_t rk[kPackCols];
  __shared__ uint8_t ac[kPackCols];
  const int c0 = blockIdx.x * kPackCols, r0 = blockIdx.y * kPackRows;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  // the sweep may launch now; it waits for this grid before the bits
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  for (int e = t; e < kPackRows * kPackCols / 16; e += blockDim.x) {
    const int rr = e / (kPackCols / 16), cc = (e % (kPackCols / 16)) * 16;
    const int i = r0 + rr, j = c0 + cc;
    const uint8_t* src = conflict + static_cast<size_t>(i) * B + j;
    if (vec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (i < B && j < B) v = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(&tile[rr][cc]) = v;
    } else {
      for (int k = 0; k < 16; ++k)
        tile[rr][cc + k] = i < B && j + k < B ? src[k] : 0;
    }
  }
  for (int c = t; c < kPackCols; c += blockDim.x) {
    const int j = c0 + c;
    rk[c] = j < B ? rank[j] : 0;
    ac[c] = j < B ? active[j] : 0;
  }
  bool ai[4];
  int32_t ri[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int i = r0 + warp + 8 * h;
    ai[h] = i < B && active[i];
    ri[h] = i < B ? rank[i] : 0;
  }
  __syncthreads();
  uint32_t out = 0u;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int h = q >> 3, rr = warp + 8 * h, cc = 32 * (q & 7) + lane;
    const int i = r0 + rr, j = c0 + cc;
    const int32_t rj = rk[cc];
    const bool e = ai[h] && tile[rr][cc] && ac[cc] &&
                   (rj < ri[h] || (rj == ri[h] && j < i));
    const unsigned word = __ballot_sync(0xffffffffu, e);
    if (lane == q) out = word;
  }
  const int w = blockIdx.x * (kPackCols / 32) + (lane & 7);
  const int row = r0 + warp + 8 * (lane >> 3);
  if (w < W) bits[static_cast<size_t>(row) * W + w] = out;
  int n = w < W ? __popc(out) : 0;
  for (int off = 1; off < 8; off <<= 1)
    n += __shfl_xor_sync(0xffffffffu, n, off);
  if ((lane & 7) == 0)
    cnt[static_cast<size_t>(blockIdx.x) * 32 * W + row] = n;
}

__device__ __forceinline__ bool bit(const uint32_t* s, int i) {
  return (s[i >> 5] >> (i & 31)) & 1u;
}

// The edge tile's bulk copy (thread 0): `bytes` on barrier `bar`.
__device__ __forceinline__ void bulk_tile(uint32_t* dst, const uint32_t* src,
                                          uint32_t bytes, uint64_t* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// One cluster of C CTAs (C = 1 included).  CTA r owns words [r own,
// (r + 1) own) of the B-bit sets, i.e. rows [32 r own, 32 (r + 1) own),
// and keeps a full copy of win / lose (two of each: the round's sets and
// the next) and of act.  Round 0 needs no row: with nothing won or lost
// yet a row wins exactly when it has no edge, which the pack counted.
// Every later round lists the owned pending rows (active, not yet won or
// lost): with the rows in shared memory a lane ORs a listed row against
// the round's sets, 16 bytes a step (W is padded to 4 words), starting at
// chunk (lane mod W / 4) so that a quarter warp's loads hit distinct
// banks; with the rows in L2 a warp reads one listed row at a time, its
// words one coalesced load, and votes.  Verdicts land in the next sets.
// A CTA's next words then go to every other CTA with its changed flag by
// remote stores that count on the receiver's mbarrier (cluster.cuh), and
// the round ends when a CTA holds all of them (C = 1: at the block
// barrier that ORs the flag).  Every CTA ORs the same flags, so all leave in the
// same round.  The launch may overlap the pack's tail (programmatic
// dependent launch): everything before the copy reads only `active`.
template <bool kSmem>
__global__ void __launch_bounds__(kFfThreads, 1)
first_fit_kernel(const uint32_t* __restrict__ edges_g,
                 const int32_t* __restrict__ cnt, int parts,
                 int32_t* __restrict__ list_g,
                 const uint8_t* __restrict__ active, int B, int W,
                 int rounds, int own, uint8_t* __restrict__ win_o,
                 uint8_t* __restrict__ lose_o, uint8_t* __restrict__ und_o) {
  extern __shared__ __align__(128) uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int cr = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int w0 = min(cr * own, W), nown = min(own, W - w0);
  const int row0 = 32 * w0;
  const size_t tile_rows = 32 * static_cast<size_t>(own);
  uint32_t* edges_s = sm;
  int32_t* list = kSmem ? reinterpret_cast<int32_t*>(sm + tile_rows * W)
                        : list_g + static_cast<size_t>(cr) * tile_rows;
  uint32_t* const sets = sm + (kSmem ? tile_rows * (W + 1) : 0);
  uint32_t* act = sets + 4 * W;          // sets: win[0], win[1], lose[0..1]
  int32_t* flags = reinterpret_cast<int32_t*>(sets + 5 * W);
  int32_t* cnt_s = flags + 2 * kMaxCtas;
  const size_t at = (static_cast<size_t>(cnt_s + 2 -
                                         reinterpret_cast<int32_t*>(sm)) +
                     1) & ~static_cast<size_t>(1);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + at);   // copy, x[2]

  mbar_init(bar, 3);
  if (tid == 0) cnt_s[0] = cnt_s[1] = 0;
  for (int w = tid; w < W; w += blockDim.x) sets[w] = sets[2 * W + w] = 0u;
  for (int i0 = 0; i0 < 32 * W; i0 += blockDim.x) {
    const int i = i0 + tid;
    const unsigned a = __ballot_sync(0xffffffffu, i < B && active[i]);
    if (lane == 0 && i < 32 * W) act[i >> 5] = a;
  }
  __syncthreads();
  grid_dependency_wait();   // the pack's bits and counts are complete
  if (kSmem && tid == 0)
    bulk_tile(edges_s, edges_g + static_cast<size_t>(row0) * W,
              static_cast<uint32_t>(32u * nown * W * sizeof(uint32_t)), bar);
  // round 0's verdicts, into win[1]: an active row without edges wins
  for (int t = warp; t < nown; t += nwarps) {
    const int i = row0 + 32 * t + lane;
    int n = 0;
    for (int x = 0; x < parts; ++x)
      n += cnt[static_cast<size_t>(x) * 32 * W + i];
    const uint32_t bw = __ballot_sync(0xffffffffu, n == 0);
    if (lane == 0) sets[W + w0 + t] = act[w0 + t] & bw;
  }
  if (kSmem) mbar_wait(bar, 0);
  __syncthreads();
  if (C > 1) cluster_start();
  // bytes a round receives: the other CTAs' next words and flags
  uint32_t rx = 0;
  for (int q = 0; q < C; ++q)
    if (q != cr) rx += 4u * (2 * min(own, W - min(q * own, W)) + 1);

  int fin = 0;
  for (int r = 0; r < rounds; ++r) {
    const int par = r & 1;
    const uint32_t* wc = sets + par * W;
    const uint32_t* lc = sets + (2 + par) * W;
    uint32_t* wn = sets + (par ^ 1) * W;
    uint32_t* ln = sets + (2 + (par ^ 1)) * W;
    int dec = 0;
    if (r == 0) {
      // the next sets' owned words were written above; lose stays empty
      for (int t = tid; t < nown; t += blockDim.x) {
        ln[w0 + t] = 0u;
        dec |= wn[w0 + t] != 0u;
      }
    } else {
      // list the owned pending rows; carry the owned words to the next
      for (int t = warp; t < nown; t += nwarps) {
        const int w = w0 + t;
        const uint32_t a = wc[w], l = lc[w];
        const uint32_t pend = act[w] & ~a & ~l;
        if (lane == 0) {
          wn[w] = a;
          ln[w] = l;
        }
        if (pend == 0u) continue;
        int base = 0;
        if (lane == 0) base = atomicAdd(&cnt_s[par], __popc(pend));
        base = __shfl_sync(0xffffffffu, base, 0);
        if ((pend >> lane) & 1u)
          list[base + __popc(pend & ((1u << lane) - 1u))] = 32 * t + lane;
      }
      __syncthreads();
      const int n = cnt_s[par];
      if (tid == 0) cnt_s[par ^ 1] = 0;
      if (kSmem) {
        // a lane a listed row, 16 bytes a step from chunk (lane mod W / 4)
        // on: a quarter warp's loads hit distinct banks
        const int q = W >> 2;
        for (int x0 = 32 * warp; x0 < n; x0 += 32 * nwarps) {
          const int x = x0 + lane;
          const int k = x < n ? list[x] : list[x0];
          const uint4* row = reinterpret_cast<const uint4*>(
              edges_s + static_cast<size_t>(k) * W);
          uint32_t blk = 0u, hit = 0u;
          int c = lane % q;
          for (int d = 0; d < q; ++d) {
            const uint4 e = row[c];
            const uint4 l = reinterpret_cast<const uint4*>(lc)[c];
            const uint4 v = reinterpret_cast<const uint4*>(wc)[c];
            blk |= (e.x & ~l.x) | (e.y & ~l.y) | (e.z & ~l.z) | (e.w & ~l.w);
            hit |= (e.x & v.x) | (e.y & v.y) | (e.z & v.z) | (e.w & v.w);
            c = c + 1 == q ? 0 : c + 1;
          }
          const bool nw = x < n && blk == 0u;
          const bool nl = x < n && !nw && hit != 0u;
          if (nw) atomicOr(&wn[w0 + (k >> 5)], 1u << (k & 31));
          if (nl) atomicOr(&ln[w0 + (k >> 5)], 1u << (k & 31));
          dec |= nw || nl;
        }
      } else {
        // rows from L2: a warp a row, its words one coalesced read
        for (int x = warp; x < n; x += nwarps) {
          const int k = list[x];
          const uint32_t* row = edges_g + static_cast<size_t>(row0 + k) * W;
          bool blocked = false, hit = false;
          for (int ww = lane; ww < W; ww += 32) {
            const uint32_t e = row[ww];
            blocked |= (e & ~lc[ww]) != 0u;
            hit |= (e & wc[ww]) != 0u;
          }
          const bool nw = !__any_sync(0xffffffffu, blocked);
          const bool nl = !nw && __any_sync(0xffffffffu, hit);
          if (lane == 0 && nw) atomicOr(&wn[w0 + (k >> 5)], 1u << (k & 31));
          if (lane == 0 && nl) atomicOr(&ln[w0 + (k >> 5)], 1u << (k & 31));
          dec |= nw || nl;
        }
      }
    }
    int any = __syncthreads_or(dec);
    if (C > 1) {
      // the owned next words and the flag into every other CTA; then the
      // others' into this one
      uint64_t* xb = bar + 1 + par;
      if (tid == 0) mbar_expect(xb, rx);
      const int per_q = 2 * nown + 1;
      for (int e = tid; e < per_q * C; e += blockDim.x) {
        const int q = e / per_q, k = e % per_q;
        if (q == cr) continue;
        const uint32_t* at_w = k == 2 * nown
                                   ? reinterpret_cast<const uint32_t*>(
                                         flags + par * kMaxCtas + cr)
                                   : ((k & 1) ? ln : wn) + w0 + (k >> 1);
        const uint32_t v = k == 2 * nown ? static_cast<uint32_t>(any) : *at_w;
        st_remote(remote(at_w, q), v, remote(xb, q));
      }
      mbar_wait(xb, (r >> 1) & 1);
      for (int q = 0; q < C; ++q)
        if (q != cr) any |= flags[par * kMaxCtas + q];
    }
    fin = par ^ 1;
    if (!any) break;
  }
  const uint32_t* wf = sets + fin * W;
  const uint32_t* lf = sets + (2 + fin) * W;
  const int end = min(B, row0 + 32 * nown);
  for (int i = row0 + tid; i < end; i += blockDim.x) {
    const bool wi = bit(wf, i), li = bit(lf, i);
    win_o[i] = wi;
    lose_o[i] = li;
    und_o[i] = bit(act, i) && !wi && !li;
  }
}

// K8's layout at B txns: W words a row (B rounded up to 128 columns, so
// the sweep reads 16 bytes a lane), the fewest CTAs (1, 2, 4 or 8) whose
// shares of the edge rows fit their shared memory beside the sets, else 8
// CTAs reading the rows from L2; the scratch (int32 words): the bits,
// each row's edge counts by column tile and, with the rows in L2, each
// CTA's list of pending rows.  False where not even the sets fit.
struct FfLayout {
  int W, parts, ctas, own, in_smem;
  size_t smem;
  long long scratch;
};

bool first_fit_layout(int B, FfLayout& l) {
  const int W = 4 * ((B + 127) / 128);
  const int parts = (W + kPackCols / 32 - 1) / (kPackCols / 32);
  const long long bits = 32LL * W * (W + parts);
  const size_t room = dt_smem_room(first_fit_kernel<true>);
  for (int c = 1; c <= kMaxCtas; c *= 2) {
    const int own = (W + c - 1) / c;
    const size_t smem = ff_smem_words(W, own, 1) * sizeof(uint32_t);
    if (smem <= room) {
      l = {W, parts, c, own, 1, smem, bits};
      return true;
    }
  }
  const int own = (W + kMaxCtas - 1) / kMaxCtas;
  const size_t smem = ff_smem_words(W, own, 0) * sizeof(uint32_t);
  l = {W, parts, kMaxCtas, own, 0, smem, bits + 32LL * kMaxCtas * own};
  return smem <= dt_smem_room(first_fit_kernel<false>);
}

template <bool kSmem>
int launch_first_fit(const uint32_t* edges, const int32_t* cnt, int32_t* list,
                     const uint8_t* active, int B, int rounds,
                     const FfLayout& l, uint8_t* win, uint8_t* lose,
                     uint8_t* und, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      first_fit_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.ctas);
  cfg.blockDim = dim3(kFfThreads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, first_fit_kernel<kSmem>, edges, cnt, l.parts,
                           list, active, B, l.W, rounds, l.own, win, lose,
                           und);
  return static_cast<int>(err);
}

}  // namespace

DT_EXPORT int dt_build_incidence(const int32_t* table_ids, const int32_t* keys,
                                 const uint8_t* is_read, const uint8_t* is_write,
                                 const uint8_t* valid, const uint8_t* active,
                                 const uint8_t* order_free, int B, int A, int K,
                                 int families, void* const* outs,
                                 int32_t* bucket1, void* stream) {
  IncOut out;
  for (int f = 0; f < 2; ++f)
    for (int v = 0; v < kViews; ++v)
      out.p[f][v] = f < families
                        ? static_cast<__nv_bfloat16*>(outs[f * kViews + v])
                        : nullptr;
  const int threads = 256, rows = threads / 32;
  const dim3 grid(dt_blocks(B, rows), families);
  incidence_kernel<<<grid, threads, 0, dt_stream(stream)>>>(
      table_ids, keys, is_read, is_write, valid, active, order_free, B, A, K,
      out, bucket1);
  return dt_status();
}

// K7.  bits: families * K * ceil(N / 32) uint32 of scratch.
DT_EXPORT int dt_overlap(const __nv_bfloat16* a1, const __nv_bfloat16* b1,
                         const __nv_bfloat16* a2, const __nv_bfloat16* b2,
                         int M, int N, int K, uint32_t* bits, uint8_t* out,
                         void* stream) {
  if (M < 1 || N < 1 || K < 8 || K % 8) return 1;
  const cudaStream_t s = dt_stream(stream);
  const int W = (N + 31) / 32;
  const int fams = a2 != nullptr ? 2 : 1;
  const dim3 gb((K + kChunk - 1) / kChunk, (W + kBitsWarps - 1) / kBitsWarps,
                fams);
  overlap_bits_kernel<<<gb, kBitsWarps * 32, 0, s>>>(b1, b2, N, K, W, bits);
  const dim3 gr((M + kRowsPerBlock - 1) / kRowsPerBlock,
                (W + kSegWords - 1) / kSegWords);
  overlap_rows_kernel<<<gr, kRowsPerBlock * kQuarters * 32, 0, s>>>(
      a1, a2, bits, M, N, K, W, out);
  return dt_status();
}

// K8's layout at B txns: out[0] the cluster's CTAs, out[1] 1 where the
// edge rows sit in shared memory, out[2] the int32 words of scratch
// dt_first_fit needs.  Launches nothing.
DT_EXPORT int dt_first_fit_layout(int B, long long* out) {
  FfLayout l;
  if (B < 1 || !first_fit_layout(B, l)) return 1;
  out[0] = l.ctas;
  out[1] = l.in_smem;
  out[2] = l.scratch;
  return 0;
}

// K8: the pack, then the sweep in the cluster dt_first_fit_layout
// chooses.  edge_bits is `scratch_len` int32 words of scratch (at least
// what the layout reports; a shorter one is refused before any launch).
// A cluster launch the card refuses returns its error: there is no other
// route.
DT_EXPORT int dt_first_fit(const uint8_t* conflict, const int32_t* rank,
                           const uint8_t* active, int B, int rounds,
                           uint32_t* edge_bits, long long scratch_len,
                           uint8_t* win, uint8_t* lose, uint8_t* und,
                           void* stream) {
  FfLayout l;
  if (B < 1 || rounds < 0 || !first_fit_layout(B, l) ||
      scratch_len < l.scratch)
    return 1;
  const cudaStream_t s = dt_stream(stream);
  const int vec = B % 16 == 0 && reinterpret_cast<uintptr_t>(conflict) % 16 == 0;
  const size_t rows = 32 * static_cast<size_t>(l.W);
  int32_t* cnt = reinterpret_cast<int32_t*>(edge_bits + rows * l.W);
  int32_t* list = cnt + l.parts * rows;
  pack_edges_kernel<<<dim3(l.parts, l.W), 256, 0, s>>>(
      conflict, rank, active, B, l.W, vec, edge_bits, cnt);
  const int err = dt_status();
  if (err != 0) return err;
  return l.in_smem ? launch_first_fit<true>(edge_bits, cnt, list, active, B,
                                            rounds, l, win, lose, und, s)
                   : launch_first_fit<false>(edge_bits, cnt, list, active, B,
                                             rounds, l, win, lose, und, s);
}
