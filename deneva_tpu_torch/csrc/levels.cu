// K9a + K9b: the level sweeps, one max-plus relaxation in two orientations.
//
// K9a replaces deneva_tpu/ops/conflict.py:123 wavefront_levels with :78
// earlier_edges fused in, as validate_calvin (cc/calvin.py:62-65) calls
// them: E[i, j] = active j precedes active i by (rank, lane) and
// c = uw | uw^T holds at (i, j); the longest chain depth along E's rows,
// max_level + 1 Jacobi rounds, clamped to max_level, overflow where the
// depth passed it.  Its levels under mode=SIMPLE / QRY_ONLY.
//
// K9b replaces :141 precedence_levels: the longest-path level along the
// columns of a possibly cyclic digraph P (P[i, j]: i before j) over the
// active txns, `rounds` Jacobi rounds and one probe round, unstable where
// the probe still moves a level or a level reached `rounds`.  MAAT's gate.
// After r rounds lv = min(depth, r) (bits.cuh), so the probe moves a
// level only at depth > rounds, and unstable is exactly F_rounds.
//
// Design: the matrix is packed to bit rows of the predecessor relation —
// for E, uw's columns by a tiled transpose, then its rows OR-ed in under
// the earlier and active tests (a warp per 8 words of a row), which also
// marks the rows with an edge; P's columns by the transpose — then one
// block of 1024 threads runs the rounds over the shrinking frontier
// (bits.cuh level_sweep): teams of 8 threads scan one member's row
// against the frontier and stop at the first hit.  K9a's first round,
// from every txn, is the set of marked rows, so its sweep starts there.
// The bits are read from L2 (512 KB at B = 2048), or from shared memory
// where they fit.
//   Bound: bytes — the B x B bool matrix is read once (4 MB at B = 2048;
//   K9a reads it twice, once per orientation); the rounds then touch only
//   bits that stay on chip.
#include "bits.cuh"

namespace {

constexpr int kThreads = 1024;

constexpr int kEdgeWords = 8;     // words of one row per warp

// E's bit rows: e[i * W + w] bit l = E[i][32 w + l], from uw's rows and
// the bits of its columns (ut, pack_cols), and nz, the set of rows with
// an edge (zeroed before).  One warp per row and kEdgeWords words: the
// loads of a row's words are in flight together.
__global__ void earlier_edges_kernel(const uint8_t* __restrict__ uw,
                                     const uint32_t* __restrict__ ut,
                                     const int32_t* __restrict__ rank,
                                     const uint8_t* __restrict__ active,
                                     int B, int W, uint32_t* __restrict__ e,
                                     uint32_t* __restrict__ nz) {
  const int lane = threadIdx.x & 31;
  const int groups = (W + kEdgeWords - 1) / kEdgeWords;
  const long long x =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (x >= static_cast<long long>(B) * groups) return;
  const int i = static_cast<int>(x / groups);
  const int w0 = static_cast<int>(x % groups) * kEdgeWords;
  const bool ai = active[i] != 0;
  const int32_t ri = rank[i];
  const uint8_t* row = uw + static_cast<size_t>(i) * B;
  const uint32_t* col = ut + static_cast<size_t>(i) * W;
  bool c[kEdgeWords];
#pragma unroll
  for (int q = 0; q < kEdgeWords; ++q) {
    const int w = w0 + q, j = w * 32 + lane;
    c[q] = false;
    if (ai && w < W && j < B && active[j]) {
      const int32_t rj = rank[j];
      c[q] = (rj < ri || (rj == ri && j < i)) &&
             (row[j] || ((col[w] >> lane) & 1u));
    }
  }
  unsigned any = 0u;
#pragma unroll
  for (int q = 0; q < kEdgeWords; ++q) {
    const unsigned word = __ballot_sync(0xffffffffu, c[q]);
    any |= word;
    if (lane == 0 && w0 + q < W) e[static_cast<size_t>(i) * W + w0 + q] = word;
  }
  if (lane == 0 && any) atomicOr(&nz[i >> 5], 1u << (i & 31));
}

// Shared layout: F, Fn (W words), list, lv (B ints), then the staged rows.
__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const uint32_t* __restrict__ bits_g,
                 const uint32_t* __restrict__ nz, int B, int W,
                 int max_level, int rows_in_smem, int32_t* __restrict__ lv_o,
                 uint8_t* __restrict__ over_o) {
  extern __shared__ uint32_t sm[];
  uint32_t* F = sm;
  uint32_t* Fn = sm + W;
  int* list = reinterpret_cast<int*>(sm + 2 * W);
  int* lv = list + B;
  const uint32_t* rows =
      stage_rows(bits_g, B, W, reinterpret_cast<uint32_t*>(lv + B),
                 rows_in_smem);
  // The first round from F_0 = every txn leaves F_1 = the txns with an
  // edge, nz: start there, and run the other max_level rounds.
  for (int w = threadIdx.x; w < W; w += blockDim.x) F[w] = nz[w];
  __syncthreads();
  for (int j = threadIdx.x; j < B; j += blockDim.x) lv[j] = bit(F, j);
  __syncthreads();
  level_sweep(rows, B, W, max_level, F, Fn, list, lv);
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    lv_o[j] = min(lv[j], max_level);
    over_o[j] = lv[j] > max_level;
  }
}

__global__ void __launch_bounds__(kThreads)
precedence_kernel(const uint32_t* __restrict__ bits_g,
                  const uint8_t* __restrict__ active, int B, int W,
                  int rounds, int rows_in_smem, int32_t* __restrict__ lv_o,
                  uint8_t* __restrict__ unstable_o) {
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
  level_sweep(rows, B, W, rounds, F, Fn, list, lv);
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    lv_o[j] = lv[j];
    unstable_o[j] = bit(F, j);
  }
}

// F, Fn, list and lv.
inline size_t sets_bytes(int B, int W) {
  return (2 * static_cast<size_t>(W) + 2 * static_cast<size_t>(B)) * 4;
}

}  // namespace

// K9a: uw bool [B, B], rank int32 [B], active bool [B] -> lv int32 [B]
// (clamped), overflow bool [B]; bits is [2 B + 1, W] scratch (uw's
// columns, E's rows, the rows with an edge).
DT_EXPORT int dt_wavefront_levels(const uint8_t* uw, const int32_t* rank,
                                  const uint8_t* active, int B, int max_level,
                                  uint32_t* bits, int32_t* lv,
                                  uint8_t* overflow, void* stream) {
  const int W = (B + 31) / 32;
  const size_t n = static_cast<size_t>(B) * W;
  uint32_t* e = bits + n;
  uint32_t* nz = bits + 2 * n;
  const cudaStream_t s = dt_stream(stream);
  cudaMemsetAsync(nz, 0, static_cast<size_t>(W) * sizeof(uint32_t), s);
  pack_cols(uw, B, W, bits, s);
  const long long warps =
      static_cast<long long>(B) * ((W + kEdgeWords - 1) / kEdgeWords);
  earlier_edges_kernel<<<dt_blocks(warps, 8), 256, 0, s>>>(
      uw, bits, rank, active, B, W, e, nz);
  size_t smem;
  int staged;
  const cudaError_t err = plan_smem(wavefront_kernel, sets_bytes(B, W),
                                    n * 4, &smem, &staged);
  if (err != cudaSuccess) return static_cast<int>(err);
  wavefront_kernel<<<1, kThreads, smem, s>>>(e, nz, B, W, max_level, staged,
                                             lv, overflow);
  return dt_status();
}

// K9b: prec bool [B, B], active bool [B] -> lv int32 [B], unstable
// bool [B]; bits is [B, W] scratch (P's columns).
DT_EXPORT int dt_precedence_levels(const uint8_t* prec, const uint8_t* active,
                                   int B, int rounds, uint32_t* bits,
                                   int32_t* lv, uint8_t* unstable,
                                   void* stream) {
  const int W = (B + 31) / 32;
  const cudaStream_t s = dt_stream(stream);
  pack_cols(prec, B, W, bits, s);
  size_t smem;
  int staged;
  const cudaError_t err = plan_smem(precedence_kernel, sets_bytes(B, W),
                                    static_cast<size_t>(B) * W * 4, &smem,
                                    &staged);
  if (err != cudaSuccess) return static_cast<int>(err);
  precedence_kernel<<<1, kThreads, smem, s>>>(bits, active, B, W, rounds,
                                              staged, lv, unstable);
  return dt_status();
}
