// A stand-alone probe of where K9b's and K18a's time went before slice
// 18, built as its own shared library and driven by `chip_smoke.py
// --slice18` on real inputs (not part of the kernel library).
//
// K9b as it was: two stream operations a call — `pack_cols` (P's B x B
// bool bytes to bit rows of its columns, a grid of 32 x 256 tiles) and
// one block of 1,024 threads running the rounds over the shrinking
// frontier (bits.cuh `level_sweep`, the rows from shared memory where
// they fit, else from L2).  `k18p_levels` runs the pack alone, the sweep
// alone (on rows packed before) or both, and records |F_r| after every
// round it ran.
//
// P's strips: `k18p_strip` reads B^2 / k bytes of P from one CTA (a
// contiguous range with 16-byte loads, or by bulk copies into shared
// memory), or the column strip of B / k columns a cluster CTA would pack
// (B rows of B / k bytes), from one CTA alone or from k CTAs at once.
// Each folds what it read into one word, so the loads are kept.
//
// K18a as it was: six stream operations a call — a memset of the rank,
// the bD^2 rank compares, the order, the count rows, their row scans and
// the test.  `k18p_defer` runs any subset of the six, by a bit each.
// `k18p_barriers` is an empty cooperative launch of a given grid with n
// grid barriers: the floor of a one-launch design.
//
// K9b's pack (`k18p_pack`): C blocks, each packing its column strip of
// P as the cluster kernel's CTAs do, cut at one of four depths — the
// loads alone (folded into a word), the loads and their bits staged,
// the transpose and the rows stored, and the whole pack with the
// witnesses and F_1.
#include <cooperative_groups.h>

#include "bits.cuh"
#include "cluster.cuh"
#include "radix.cuh"

namespace {

constexpr int kThreads = 1024;

// -- K9b, the slice-4 sweep with its round counts ---------------------------

__global__ void __launch_bounds__(kThreads)
old_precedence_kernel(const uint32_t* __restrict__ bits_g,
                      const uint8_t* __restrict__ active, int B, int W,
                      int rounds, int rows_in_smem, int32_t* __restrict__ lv_o,
                      uint8_t* __restrict__ unstable_o,
                      int32_t* __restrict__ stats) {
  extern __shared__ uint32_t sm[];
  uint32_t* F = sm;
  uint32_t* Fn = sm + W;
  int* list = reinterpret_cast<int*>(sm + 2 * W);
  int* lv = list + B;
  const uint32_t* rows =
      stage_rows(bits_g, B, W, reinterpret_cast<uint32_t*>(lv + B),
                 rows_in_smem);
  for (int j = threadIdx.x; j < B; j += blockDim.x) lv[j] = 0;
  load_set(active, B, W, F);
  // level_sweep, with |F_r| recorded by round
  const int tid = threadIdx.x, bd = blockDim.x;
  const int team = tid / kTeam, tl = tid % kTeam, teams = bd / kTeam;
  int prev = -1, ran = 0;
  for (int r = 0; r < rounds; ++r) {
    const int n = compact(F, W, list);
    if (stats != nullptr && tid == 0) stats[1 + r] = n;
    if (n == 0) break;
    if (n == prev) {
      for (int j = tid; j < B; j += bd) lv[j] += (rounds - r) * bit(F, j);
      break;
    }
    prev = n;
    ++ran;
    for (int w = tid; w < W; w += bd) Fn[w] = 0u;
    __syncthreads();
    for (int x = team; x < n; x += teams) {
      const int j = list[x];
      const uint32_t* row = rows + static_cast<size_t>(j) * W;
      uint32_t hit = 0u;
      for (int c0 = 0; c0 < W && !hit; c0 += kTeam * kUnroll) {
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int c = c0 + q * kTeam + tl;
          if (c < W) hit |= row[c] & F[c];
        }
      }
      if (hit) atomicOr(&Fn[j >> 5], 1u << (j & 31));
    }
    __syncthreads();
    for (int w = tid; w < W; w += bd) F[w] = Fn[w];
    __syncthreads();
    for (int j = tid; j < B; j += bd) lv[j] += bit(F, j);
  }
  __syncthreads();
  if (stats != nullptr && tid == 0) stats[0] = ran;
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    lv_o[j] = lv[j];
    unstable_o[j] = bit(F, j);
  }
}

// -- P's strips -----------------------------------------------------------

__device__ __forceinline__ uint32_t fold(uint4 v) {
  return v.x ^ (v.y * 3u) ^ (v.z * 5u) ^ (v.w * 7u);
}

__device__ void fold_out(uint32_t acc, uint32_t* out) {
  acc = __reduce_xor_sync(0xffffffffu, acc);
  if ((threadIdx.x & 31) == 0) atomicXor(out, acc);
}

// One CTA: `bytes` contiguous bytes from p with 16-byte loads, 4 a
// thread in flight.
__global__ void __launch_bounds__(kThreads)
strip_flat_kernel(const uint4* __restrict__ p, size_t n16,
                  uint32_t* __restrict__ out) {
  uint32_t acc = 0u;
  size_t i = threadIdx.x;
  for (; i + 3 * kThreads < n16; i += 4 * kThreads) {
    const uint4 a = p[i], b = p[i + kThreads], c = p[i + 2 * kThreads],
                d = p[i + 3 * kThreads];
    acc ^= fold(a) ^ fold(b) ^ fold(c) ^ fold(d);
  }
  for (; i < n16; i += kThreads) acc ^= fold(p[i]);
  fold_out(acc, out);
}

// One CTA: the same bytes by bulk copies of 32 KB into a ring of four
// shared buffers, each folded when it lands.
constexpr uint32_t kRing = 4;

__global__ void __launch_bounds__(kThreads)
strip_bulk_kernel(const uint8_t* __restrict__ p, size_t bytes,
                  uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint4 buf[];
  __shared__ __align__(8) uint64_t bar[kRing];
  const size_t chunks = (bytes + kBulkChunk - 1) / kBulkChunk;
  if (threadIdx.x == 0)
    for (uint32_t q = 0; q < kRing; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(bar + q))
                   : "memory");
  __syncthreads();
  auto issue = [&](size_t c) {
    const uint32_t n = static_cast<uint32_t>(
        min(static_cast<size_t>(kBulkChunk), bytes - c * kBulkChunk));
    uint64_t* b = bar + c % kRing;
    mbar_expect(b, n);
    bulk_copy(reinterpret_cast<char*>(buf) + (c % kRing) * kBulkChunk,
              p + c * kBulkChunk, n, b);
  };
  if (threadIdx.x == 0)
    for (size_t c = 0; c < min(chunks, static_cast<size_t>(kRing)); ++c)
      issue(c);
  uint32_t acc = 0u;
  for (size_t c = 0; c < chunks; ++c) {
    mbar_wait(bar + c % kRing, static_cast<uint32_t>((c / kRing) & 1));
    const uint32_t n = static_cast<uint32_t>(
        min(static_cast<size_t>(kBulkChunk), bytes - c * kBulkChunk));
    const uint4* s = buf + (c % kRing) * (kBulkChunk / 16);
    for (uint32_t i = threadIdx.x; i < n / 16; i += kThreads)
      acc ^= fold(s[i]);
    __syncthreads();
    if (threadIdx.x == 0 && c + kRing < chunks) issue(c + kRing);
  }
  fold_out(acc, out);
}

// Block c: columns [c w, (c + 1) w) of every row (w a multiple of 16),
// 16-byte loads, 4 a thread in flight.
__global__ void __launch_bounds__(kThreads)
strip_cols_kernel(const uint8_t* __restrict__ p, int B, int w,
                  uint32_t* __restrict__ out) {
  const int per_row = w / 16;
  const size_t n = static_cast<size_t>(B) * per_row;
  const uint8_t* base = p + static_cast<size_t>(blockIdx.x) * w;
  auto at = [&](size_t e) {
    return reinterpret_cast<const uint4*>(
        base + (e / per_row) * static_cast<size_t>(B))[e % per_row];
  };
  uint32_t acc = 0u;
  size_t i = threadIdx.x;
  for (; i + 3 * kThreads < n; i += 4 * kThreads)
    acc ^= fold(at(i)) ^ fold(at(i + kThreads)) ^ fold(at(i + 2 * kThreads)) ^
           fold(at(i + 3 * kThreads));
  for (; i < n; i += kThreads) acc ^= fold(at(i));
  fold_out(acc, out);
}

// -- K9b's pack, cut at four depths -----------------------------------------

constexpr int kGroup = 4;
constexpr int kChunks = 2 * kGroup;

template <int kDepth>
__global__ void __launch_bounds__(kThreads, 1)
pack_depth_kernel(const uint8_t* __restrict__ prec,
                  const uint8_t* __restrict__ active, int B, int W, int own,
                  uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = min(static_cast<int>(blockIdx.x) * own, W);
  const int nown = min(own, W - w0);
  const int Wp = W | 1;
  uint32_t* rows_s = sm;
  uint32_t* A = rows_s + 32 * own * Wp;
  uint32_t* F1 = A + W;
  int* wit = reinterpret_cast<int*>(F1 + own);
  uint16_t* stage = reinterpret_cast<uint16_t*>(wit + 32 * own) +
                    warp * 32 * kChunks;
  for (int t = tid; t < 32 * own; t += kThreads) wit[t] = 0x7FFFFFFF;
  for (int t = tid; t < own; t += kThreads) F1[t] = 0u;
  load_set(active, B, W, A);
  uint32_t acc = 0u;
  const int groups = (nown + kGroup - 1) / kGroup;
  for (int k = warp; k < W * groups; k += kThreads / 32) {
    const int w = k % W, g = k / W;
    const int q0 = g * kGroup, nq = min(kGroup, nown - q0);
    const int j0 = 32 * (w0 + q0);
    uint4 v[kChunks];
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      const int e = lane + 32 * m, i = 32 * w + e / kChunks;
      const int c = e % kChunks, j = j0 + 16 * c;
      v[m] = make_uint4(0u, 0u, 0u, 0u);
      if (i < B && c < 2 * nq && j < B)
        v[m] = *reinterpret_cast<const uint4*>(prec +
                                               static_cast<size_t>(i) * B + j);
    }
    if (kDepth == 0) {
#pragma unroll
      for (int m = 0; m < kChunks; ++m) acc ^= fold(v[m]);
      continue;
    }
#pragma unroll
    for (int m = 0; m < kChunks; ++m)
      stage[lane + 32 * m] = static_cast<uint16_t>(chunk_bits(v[m]));
    __syncwarp();
    for (int qq = 0; qq < nq; ++qq) {
      const uint32_t x =
          reinterpret_cast<const uint32_t*>(stage)[lane * kGroup + qq];
      if (kDepth == 1) {
        acc ^= x;
        continue;
      }
      const int q = q0 + qq, jl = 32 * q + lane;
      const uint32_t y = transpose32(x) & A[w];
      rows_s[static_cast<size_t>(jl) * Wp + w] = y;
      if (kDepth == 2) continue;
      if (y) atomicMin(&wit[jl], 32 * w + __ffs(y) - 1);
      const unsigned has = __ballot_sync(0xffffffffu, y != 0u);
      if (lane == 0 && has) atomicOr(&F1[q], has & A[w0 + q]);
    }
    __syncwarp();
  }
  __syncthreads();
  if (kDepth >= 2 && tid < 32 * nown)
    acc ^= rows_s[static_cast<size_t>(tid) * Wp + (tid % W)] ^
           static_cast<uint32_t>(wit[tid]);
  fold_out(acc, out);
}

// -- K18a, the slice-9 kernels --------------------------------------------

constexpr int kMaxParts = 8;
constexpr int kMcThreads = 256;
constexpr int kRowScanThreads = 1024;
constexpr int kRankSpan = 1024;

__device__ __forceinline__ int owner_of(int32_t key, int d) {
  const int o = key % d;
  return o < 0 ? o + d : o;
}

__device__ __forceinline__ void owner_counts(const int32_t* __restrict__ keys,
                                             const uint8_t* __restrict__ valid,
                                             int t, int a, int d,
                                             int (&c)[kMaxParts]) {
#pragma unroll
  for (int o = 0; o < kMaxParts; ++o) c[o] = 0;
  const size_t at = static_cast<size_t>(t) * a;
  for (int j = 0; j < a; ++j) {
    if (!valid[at + j]) continue;
    const int o = owner_of(keys[at + j], d);
#pragma unroll
    for (int q = 0; q < kMaxParts; ++q)
      if (q == o) ++c[q];
  }
}

__global__ void rank_kernel(const int32_t* __restrict__ ts, int bd,
                            int32_t* __restrict__ rank) {
  __shared__ int32_t tile[kMcThreads];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t me = t < bd ? ts[t] : 0;
  const int end = min(bd, (blockIdx.y + 1) * kRankSpan);
  int cnt = 0;
  for (int t0 = blockIdx.y * kRankSpan; t0 < end; t0 += kMcThreads) {
    const int j = t0 + threadIdx.x;
    tile[threadIdx.x] = j < end ? ts[j] : 0;
    __syncthreads();
    const int lim = min(kMcThreads, end - t0);
    for (int jj = 0; jj < lim; ++jj) {
      const int32_t tj = tile[jj];
      cnt += (tj < me) || (tj == me && t0 + jj < t);
    }
    __syncthreads();
  }
  if (t < bd && cnt) atomicAdd(&rank[t], cnt);
}

__global__ void order_kernel(const int32_t* __restrict__ rank, int bd,
                             int32_t* __restrict__ order) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < bd) order[rank[t]] = t;
}

__global__ void count_kernel(const int32_t* __restrict__ order,
                             const int32_t* __restrict__ keys,
                             const uint8_t* __restrict__ valid, int bd, int a,
                             int d, uint32_t* __restrict__ cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bd) return;
  const int t = order[i];
  int c[kMaxParts];
  owner_counts(keys, valid, t, a, d, c);
#pragma unroll
  for (int o = 0; o < kMaxParts; ++o)
    if (o < d) cnt[static_cast<size_t>(o) * bd + i] = c[o];
}

__global__ void defer_kernel(const int32_t* __restrict__ order,
                             const int32_t* __restrict__ keys,
                             const uint8_t* __restrict__ valid,
                             const uint32_t* __restrict__ excl, int bd,
                             int a, int d, int cap,
                             uint8_t* __restrict__ dfr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bd) return;
  const int t = order[i];
  int c[kMaxParts];
  owner_counts(keys, valid, t, a, d, c);
  bool over = false;
#pragma unroll
  for (int o = 0; o < kMaxParts; ++o)
    if (o < d && c[o] > 0)
      over |= static_cast<long long>(excl[static_cast<size_t>(o) * bd + i])
              + c[o] > cap;
  dfr[t] = over;
}

// An empty cooperative launch with n grid barriers.
__global__ void barriers_kernel(int n, int32_t* __restrict__ sink) {
  auto grid = cooperative_groups::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0 && sink != nullptr) *sink = n;
}

}  // namespace

// K9b as it was.  piece 1: pack_cols alone; 2: the sweep alone on `bits`
// packed before; 3: both.  stats (or null) int32 [1 + rounds]: the
// rounds that ran a pass, then |F_r| at the top of each round r.
DT_EXPORT int k18p_levels(int piece, const uint8_t* prec,
                          const uint8_t* active, int B, int rounds,
                          uint32_t* bits, int32_t* lv, uint8_t* unstable,
                          int32_t* stats, void* stream) {
  const int W = (B + 31) / 32;
  const cudaStream_t s = dt_stream(stream);
  if (piece & 1) pack_cols(prec, B, W, bits, s);
  if (piece & 2) {
    size_t smem;
    int staged;
    const size_t sets =
        (2 * static_cast<size_t>(W) + 2 * static_cast<size_t>(B)) * 4;
    const cudaError_t err = plan_smem(old_precedence_kernel, sets,
                                      static_cast<size_t>(B) * W * 4, &smem,
                                      &staged);
    if (err != cudaSuccess) return static_cast<int>(err);
    old_precedence_kernel<<<1, kThreads, smem, s>>>(
        bits, active, B, W, rounds, staged, lv, unstable, stats);
  }
  return dt_status();
}

// mode 0: one CTA, B^2 / k contiguous bytes, 16-byte loads; 1: the same
// by bulk copies; 2: one CTA, the column strip of B / k columns; 3: k
// CTAs at once, strip c each.  out: one uint32, XORed into.
DT_EXPORT int k18p_strip(int mode, const uint8_t* p, int B, int k,
                         uint32_t* out, void* stream) {
  const cudaStream_t s = dt_stream(stream);
  const size_t bytes = static_cast<size_t>(B) * B / k;
  const int w = B / k;
  if (bytes % 16 != 0 || w % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    strip_flat_kernel<<<1, kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(p), bytes / 16, out);
  } else if (mode == 1) {
    const int smem = static_cast<int>(kRing * kBulkChunk);
    const cudaError_t e = cudaFuncSetAttribute(
        strip_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    strip_bulk_kernel<<<1, kThreads, smem, s>>>(p, bytes, out);
  } else if (mode == 2 || mode == 3) {
    strip_cols_kernel<<<mode == 2 ? 1 : k, kThreads, 0, s>>>(p, B, w, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dt_status();
}

// K18a as it was.  ops: bit 0 the rank's memset, 1 the rank compares, 2
// the order, 3 the count rows, 4 their row scans, 5 the test.  cnt: d *
// bd + d uint32 of scratch; rank: bd int32.
DT_EXPORT int k18p_defer(int ops, const int32_t* keys, const uint8_t* valid,
                         const int32_t* ts, int bd, int a, int d, int cap,
                         uint8_t* dfr, int32_t* order, uint32_t* cnt,
                         int32_t* rank, void* stream) {
  if (d < 2 || d > kMaxParts || bd < 1 || a < 1) return 1;
  cudaStream_t s = dt_stream(stream);
  const int nb = dt_blocks(bd, kMcThreads);
  if (ops & 1) cudaMemsetAsync(rank, 0, sizeof(int32_t) * bd, s);
  if (ops & 2)
    rank_kernel<<<dim3(nb, dt_blocks(bd, kRankSpan)), kMcThreads, 0, s>>>(
        ts, bd, rank);
  if (ops & 4) order_kernel<<<nb, kMcThreads, 0, s>>>(rank, bd, order);
  if (ops & 8)
    count_kernel<<<nb, kMcThreads, 0, s>>>(order, keys, valid, bd, a, d, cnt);
  if (ops & 16)
    dt_radix::radix_rowscan_kernel<<<d, kRowScanThreads, 0, s>>>(
        cnt, bd, cnt + static_cast<size_t>(d) * bd, nullptr);
  if (ops & 32)
    defer_kernel<<<nb, kMcThreads, 0, s>>>(order, keys, valid, cnt, bd, a, d,
                                           cap, dfr);
  return dt_status();
}

// K9b's pack at `depth` (0-3) over `ctas` blocks (B % 16 == 0, P
// 16-byte aligned, the strips' rows in shared memory); out: one uint32.
DT_EXPORT int k18p_pack(int depth, const uint8_t* prec, const uint8_t* active,
                        int B, int ctas, uint32_t* out, void* stream) {
  const int W = (B + 31) / 32, own = (W + ctas - 1) / ctas;
  if (B % 16 != 0 || depth < 0 || depth > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (32 * static_cast<size_t>(own) * (W | 1) + W + own +
                       32 * static_cast<size_t>(own)) * 4 +
                      (kThreads / 32) * 32 * kChunks * 2;
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<ctas, kThreads, smem, dt_stream(stream)>>>(prec, active, B, W,
                                                         own, out);
    return dt_status();
  };
  switch (depth) {
    case 0: return launch(pack_depth_kernel<0>);
    case 1: return launch(pack_depth_kernel<1>);
    case 2: return launch(pack_depth_kernel<2>);
    default: return launch(pack_depth_kernel<3>);
  }
}

// An empty cooperative launch of `grid` blocks of `threads` with n grid
// barriers.
DT_EXPORT int k18p_barriers(int grid, int threads, int n, int32_t* sink,
                            void* stream) {
  void* args[] = {&n, &sink};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barriers_kernel), dim3(grid),
      dim3(threads), args, 0, dt_stream(stream));
  return e != cudaSuccess ? static_cast<int>(e) : dt_status();
}
