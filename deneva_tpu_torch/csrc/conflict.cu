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
// fused into :96 greedy_first_fit.  A first launch packs
// E[i, j] = conflict[i, j] & active[i] & active[j] & (rank, lane)_j <
// (rank, lane)_i into bits, one warp ballot per 32 columns.  The sweep
// runs in one block: win / lose / active are bit sets in shared memory,
// each thread owns rows, and a round is one Jacobi step (every row reads
// the previous round's sets; the new bits land in separate sets and are
// merged after a barrier), exactly the reference's update order.  A round
// that changes nothing leaves every later round unchanged, so the loop
// stops there.  The edge bits sit in shared memory when they fit
// (B = 1024: 128 KB) and are read from global memory (L2) otherwise.
//   Bound: bytes — reading the B x B bool conflict matrix once.
#include "common.cuh"
#include "hashing.cuh"

#include <cuda_bf16.h>

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

__global__ void pack_edges_kernel(const uint8_t* __restrict__ conflict,
                                  const int32_t* __restrict__ rank,
                                  const uint8_t* __restrict__ active, int B,
                                  int W, uint32_t* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= B) return;
  const bool ai = active[i] != 0;
  const int32_t ri = rank[i];
  for (int w = 0; w < W; ++w) {
    const int j = w * 32 + lane;
    bool e = false;
    if (ai && j < B && conflict[static_cast<size_t>(i) * B + j] &&
        active[j]) {
      const int32_t rj = rank[j];
      e = rj < ri || (rj == ri && j < i);
    }
    const unsigned word = __ballot_sync(0xffffffffu, e);
    if (lane == 0) bits[static_cast<size_t>(i) * W + w] = word;
  }
}

__device__ __forceinline__ bool bit(const uint32_t* s, int i) {
  return (s[i >> 5] >> (i & 31)) & 1u;
}

__global__ void __launch_bounds__(1024)
first_fit_kernel(const uint32_t* __restrict__ edges_g,
                 const uint8_t* __restrict__ active, int B, int W,
                 int rounds, int edges_in_smem, uint8_t* __restrict__ win_o,
                 uint8_t* __restrict__ lose_o, uint8_t* __restrict__ und_o) {
  extern __shared__ uint32_t sm[];
  uint32_t* win = sm;
  uint32_t* lose = sm + W;
  uint32_t* nwin = sm + 2 * W;
  uint32_t* nlose = sm + 3 * W;
  uint32_t* act = sm + 4 * W;
  const uint32_t* edges = edges_g;
  const int tid = threadIdx.x, lane = tid & 31, bd = blockDim.x;
  for (int w = tid; w < W; w += bd) win[w] = lose[w] = 0u;
  for (int i0 = 0; i0 < B; i0 += bd) {
    const int i = i0 + tid;
    const unsigned a = __ballot_sync(0xffffffffu, i < B && active[i]);
    if (lane == 0 && (i >> 5) < W) act[i >> 5] = a;
  }
  if (edges_in_smem) {
    uint32_t* se = sm + 5 * W;
    const size_t n = static_cast<size_t>(B) * W;
    for (size_t x = tid; x < n; x += bd) se[x] = edges_g[x];
    edges = se;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    int changed = 0;
    for (int i0 = 0; i0 < B; i0 += bd) {
      const int i = i0 + tid;
      bool nw = false, nl = false;
      if (i < B && bit(act, i) && !bit(win, i) && !bit(lose, i)) {
        bool blocked = false, hit = false;
        const uint32_t* row = edges + static_cast<size_t>(i) * W;
        for (int w = 0; w < W; ++w) {
          const uint32_t e = row[w];
          blocked |= (e & ~lose[w]) != 0u;
          hit |= (e & win[w]) != 0u;
        }
        nw = !blocked;
        nl = hit && !nw;
      }
      const unsigned bw = __ballot_sync(0xffffffffu, nw);
      const unsigned bl = __ballot_sync(0xffffffffu, nl);
      if (lane == 0 && (i >> 5) < W) {
        nwin[i >> 5] = bw;
        nlose[i >> 5] = bl;
      }
      changed |= (bw | bl) != 0u;
    }
    const int any = __syncthreads_or(changed);
    for (int w = tid; w < W; w += bd) {
      win[w] |= nwin[w];
      lose[w] |= nlose[w];
    }
    __syncthreads();
    if (!any) break;
  }
  for (int i = tid; i < B; i += bd) {
    const bool wi = bit(win, i), li = bit(lose, i);
    win_o[i] = wi;
    lose_o[i] = li;
    und_o[i] = bit(act, i) && !wi && !li;
  }
}

constexpr int kFirstFitThreads = 1024;
constexpr size_t kSmemMax = 200 * 1024;

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

DT_EXPORT int dt_first_fit(const uint8_t* conflict, const int32_t* rank,
                           const uint8_t* active, int B, int rounds,
                           uint32_t* edge_bits, uint8_t* win, uint8_t* lose,
                           uint8_t* und, void* stream) {
  const int W = (B + 31) / 32;
  const cudaStream_t s = dt_stream(stream);
  pack_edges_kernel<<<dt_blocks(B, 8), 256, 0, s>>>(conflict, rank, active, B,
                                                    W, edge_bits);
  const size_t sets = 5 * static_cast<size_t>(W) * sizeof(uint32_t);
  const size_t edges = static_cast<size_t>(B) * W * sizeof(uint32_t);
  const int in_smem = sets + edges <= kSmemMax;
  const size_t smem = sets + (in_smem ? edges : 0);
  cudaError_t err = cudaFuncSetAttribute(
      first_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  first_fit_kernel<<<1, kFirstFitThreads, smem, s>>>(
      edge_bits, active, B, W, rounds, in_smem, win, lose, und);
  return dt_status();
}
