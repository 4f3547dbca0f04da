// Bit-packed boolean matrices and the one-block level sweep shared by
// K9 (levels.cu) and K11 (maat.cu).
//
// A bool [B, B] matrix becomes B rows of W = ceil(B / 32) words, bit l of
// word w of row x standing for column 32 w + l: `pack_cols` transposes it
// through a 32 x 256 byte tile in shared memory (coalesced loads,
// conflict-free ballots on a padded stride).
//
// The level sweep.  Both reference sweeps (deneva_tpu/ops/conflict.py:123
// wavefront_levels, :141 precedence_levels) run Jacobi rounds
// lv <- max(lv, 1 + max over predecessors of lv) from lv = 0.  By
// induction, after r rounds lv = min(depth, r), depth being the longest
// path that ends at the node (infinite downstream of a cycle).  So the
// set F_r = {lv == r} = {depth >= r} follows F_{r+1} = {j in F_r : some
// predecessor of j is in F_r}, and lv is the number of rounds r >= 1 with
// j in F_r.  Each round reads only the previous round's F — the same
// Jacobi values, computed on the shrinking frontier instead of all B
// nodes: a node that left F never returns, and an F that a round leaves
// as it was (empty, or the nodes downstream of a cycle) is a fixpoint, so
// the rounds end early with the values the remaining rounds would leave.
#pragma once

#include "common.cuh"

// Everything has internal linkage (an unnamed namespace): each source
// that includes this file gets its own copy of the kernels.
namespace {

constexpr int kTeam = 8;          // threads that scan one row together
constexpr int kTileCols = 256;    // dt_pack_cols tile: 32 rows x 256 cols

struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};

__device__ __forceinline__ bool bit(const uint32_t* s, int i) {
  return (s[i >> 5] >> (i & 31)) & 1u;
}

// 32 x 32 bits across a warp: lane r holds word r in, lane c gets bit r
// of word r's bit c out.
__device__ __forceinline__ uint32_t transpose32(uint32_t x) {
  const int lane = threadIdx.x & 31;
  constexpr uint32_t kMask[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                                 0x33333333u, 0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const uint32_t m = kMask[s];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y & m) << j);
  }
  return x;
}

// Bit c of the result: byte c of the 32 at `p` (16-byte aligned) is set.
__device__ __forceinline__ uint32_t byte_bits32(const uint8_t* p) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t out = 0u;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t m = __vcmpne4(v[q], 0u);          // 0xFF a set byte
    out |= (((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
            ((m >> 28) & 8u)) << (4 * q);
  }
  return out;
}

// Bit c of the result: byte c of the 16 in v is set.  A word's four
// byte flags (0 or 1) times 0x01020408 land in bits 24-27 and nowhere
// that carries into them.
__device__ __forceinline__ uint32_t chunk_bits(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t out = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out |= (((__vcmpne4(w[q], 0u) & 0x01010101u) * 0x01020408u) >> 24)
           << (4 * q);
  return out;
}

// bits[j * W + w] bit l = m[32 w + l][j]; 256 threads per tile.
__global__ void pack_cols_kernel(const uint8_t* __restrict__ m, int B, int W,
                                 uint32_t* __restrict__ bits) {
  __shared__ uint8_t tile[32][kTileCols + 4];
  const int j0 = blockIdx.x * kTileCols, w = blockIdx.y, i0 = w * 32;
  const int t = threadIdx.x;
  for (int r = 0; r < 32; ++r) {
    const int i = i0 + r, j = j0 + t;
    tile[r][t] = (i < B && j < B) ? m[static_cast<size_t>(i) * B + j] : 0;
  }
  __syncthreads();
  const int lane = t & 31, warp = t >> 5;
  for (int c = warp; c < kTileCols; c += kTileCols / 32) {
    const unsigned word = __ballot_sync(0xffffffffu, tile[lane][c] != 0);
    if (lane == 0 && j0 + c < B)
      bits[static_cast<size_t>(j0 + c) * W + w] = word;
  }
}

inline void pack_cols(const uint8_t* m, int B, int W, uint32_t* bits,
                      cudaStream_t s) {
  const dim3 grid((B + kTileCols - 1) / kTileCols, W);
  pack_cols_kernel<<<grid, kTileCols, 0, s>>>(m, B, W, bits);
}

// The bit set of a bool [B] vector into shared words (blockDim a multiple
// of 32); block-wide, ends synchronised.
__device__ void load_set(const uint8_t* __restrict__ v, int B, int W,
                         uint32_t* s) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < W * 32; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const unsigned a = __ballot_sync(0xffffffffu, i < B && v[i]);
    if (lane == 0 && (i >> 5) < W) s[i >> 5] = a;
  }
  __syncthreads();
}

// Whether any of v[0, B) is set, in every thread of the block.
__device__ bool any_set(const uint8_t* __restrict__ v, int B) {
  int any = 0;
  for (int i = threadIdx.x; i < B; i += blockDim.x) any |= v[i];
  return __syncthreads_or(any) != 0;
}

// The indices of the set bits of F[0, W) into list, ascending; returns
// their count in every thread.  Block-wide, ends synchronised.
__device__ int compact(const uint32_t* F, int W, int* list) {
  int carry = 0;
  for (int base = 0; base < W; base += blockDim.x) {
    const int w = base + threadIdx.x;
    const uint32_t f = w < W ? F[w] : 0u;
    int total;
    const int incl = dt_block_incl_scan(__popc(f), AddI(), 0, total);
    int pos = carry + incl - __popc(f);
    for (uint32_t x = f; x; x &= x - 1) list[pos++] = w * 32 + __ffs(x) - 1;
    carry += total;
  }
  __syncthreads();
  return carry;
}

// Append the lanes' entries where `need` to list (warp-aggregated on the
// counter n).  Called by whole warps.
__device__ __forceinline__ void push(bool need, int entry, int* list,
                                     int* n) {
  const unsigned b = __ballot_sync(0xffffffffu, need);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && b) base = atomicAdd(n, __popc(b));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (need) list[base + __popc(b & ((1u << lane) - 1u))] = entry;
}

// One block runs `rounds` level rounds over the predecessor rows `rows`
// ([B, W] bits, global or shared): F (shared, W words) holds F_0 on entry
// and F_rounds on exit; lv (shared, B ints, or null) gains one for each
// round a node stays in F.  Fn (W words) and list (B ints) are scratch.
// F only shrinks, so a round that keeps its size is a fixpoint: every
// later round keeps F as it is, and the loop stops there and credits lv
// with those rounds.  A member's row is read by a team of kTeam threads,
// kUnroll independent words each per step, so a row costs one round trip.
constexpr int kUnroll = 8;

__device__ void level_sweep(const uint32_t* rows, int B, int W, int rounds,
                            uint32_t* F, uint32_t* Fn, int* list, int* lv) {
  const int tid = threadIdx.x, bd = blockDim.x;
  const int team = tid / kTeam, tl = tid % kTeam, teams = bd / kTeam;
  int prev = -1;
  for (int r = 0; r < rounds; ++r) {
    const int n = compact(F, W, list);          // |F_r|
    if (n == 0) break;
    if (n == prev) {                            // F_r == F_{r-1}
      if (lv)
        for (int j = tid; j < B; j += bd) lv[j] += (rounds - r) * bit(F, j);
      break;
    }
    prev = n;
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
    if (lv)
      for (int j = tid; j < B; j += bd) lv[j] += bit(F, j);
  }
  __syncthreads();
}

// Copies [B, W] bit rows into shared memory at `dst` when `use` is set;
// returns the rows to read.
__device__ const uint32_t* stage_rows(const uint32_t* src, int B, int W,
                                      uint32_t* dst, int use) {
  if (!use) return src;
  const size_t n = static_cast<size_t>(B) * W;
  for (size_t x = threadIdx.x; x < n; x += blockDim.x) dst[x] = src[x];
  __syncthreads();
  return dst;
}

constexpr size_t kSmemMax = 200 * 1024;

// The dynamic shared memory of a one-block kernel: its `sets`, and its
// `rows` too where both fit (*staged says which).  Raises the kernel's
// limit where the bytes need it; an error where the sets alone do not fit.
template <typename K>
inline cudaError_t plan_smem(K kernel, size_t sets, size_t rows,
                             size_t* smem, int* staged) {
  if (sets > kSmemMax) return cudaErrorInvalidValue;
  *staged = sets + rows <= kSmemMax;
  *smem = sets + (*staged ? rows : 0);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace
