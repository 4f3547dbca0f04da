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
// (A1 B1^T > 0) AND (A2 B2^T > 0) over bf16 count rows, f32 accumulation.
//   Bound: the dense product's operations at the tensor-core rate, against
//   reading four B x K bf16 inputs; the data needs far fewer operations
//   (rows hold <= 10 non-zeros of K), a sparse redesign left to a later
//   change.  mma.sync m16n8k16 bf16 tiles: a 64 x 64 output tile per block
//   of four warps (32 x 32 each), 32-deep K steps through padded shared
//   memory (row stride 40 bf16: the fragment loads hit 32 distinct
//   banks).  The second family reuses the accumulators; its compare is
//   ANDed into the first family's bits before the one bool store.  The
//   result is exact whatever the summation order.
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

constexpr int kBM = 64, kBN = 64, kBK = 32, kPad = 8;
constexpr int kRow = kBK + kPad;   // 40 bf16 = 80 bytes per smem row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(128)
overlap_kernel(const __nv_bfloat16* __restrict__ a1,
               const __nv_bfloat16* __restrict__ b1,
               const __nv_bfloat16* __restrict__ a2,
               const __nv_bfloat16* __restrict__ b2, int M, int N, int K,
               uint8_t* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 sa[kBM * kRow];
  __shared__ __align__(16) __nv_bfloat16 sb[kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  uint32_t hit = 0xFFFFFFFFu;   // bit (mi*4 + ni)*4 + e per accumulator
  const int fams = a2 != nullptr ? 2 : 1;
  for (int fam = 0; fam < fams; ++fam) {
    const __nv_bfloat16* A = fam ? a2 : a1;
    const __nv_bfloat16* Bm = fam ? b2 : b1;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      // 64 rows x 32 bf16 = 256 chunks of 16 bytes per operand
      for (int c = tid; c < 256; c += 128) {
        const int r = c >> 2, kc = (c & 3) * 8, gk = k0 + kc;
        uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
        if (row0 + r < M && gk < K)
          va = *reinterpret_cast<const uint4*>(
              A + static_cast<size_t>(row0 + r) * K + gk);
        if (col0 + r < N && gk < K)
          vb = *reinterpret_cast<const uint4*>(
              Bm + static_cast<size_t>(col0 + r) * K + gk);
        *reinterpret_cast<uint4*>(&sa[r * kRow + kc]) = va;
        *reinterpret_cast<uint4*>(&sb[r * kRow + kc]) = vb;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* p = &sa[(wm * 32 + mi * 16 + g) * kRow + kk + 2 * t];
          af[mi][0] = ld32(p);
          af[mi][1] = ld32(p + 8 * kRow);
          af[mi][2] = ld32(p + 8);
          af[mi][3] = ld32(p + 8 * kRow + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* p = &sb[(wn * 32 + ni * 8 + g) * kRow + kk + 2 * t];
          bf[ni][0] = ld32(p);
          bf[ni][1] = ld32(p + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
      }
      __syncthreads();
    }
    uint32_t h = 0u;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h |= static_cast<uint32_t>(acc[mi][ni][e] > 0.f) << ((mi * 4 + ni) * 4 + e);
    hit &= h;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm * 32 + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int c = col0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (r < M && c < N)
          out[static_cast<size_t>(r) * N + c] =
              static_cast<uint8_t>((hit >> ((mi * 4 + ni) * 4 + e)) & 1u);
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

DT_EXPORT int dt_overlap(const __nv_bfloat16* a1, const __nv_bfloat16* b1,
                         const __nv_bfloat16* a2, const __nv_bfloat16* b2,
                         int M, int N, int K, uint8_t* out, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  overlap_kernel<<<grid, 128, 0, dt_stream(stream)>>>(a1, b1, a2, b2, M, N, K,
                                                       out);
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
