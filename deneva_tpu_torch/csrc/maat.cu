// K11a + K11b: MAAT's closure and peel (deneva_tpu/cc/maat.py:155-221).
//
// The reference takes this branch through lax.cond when the level gate
// (K9b) leaves any survivor unstable, and the fast branch otherwise.  The
// port launches both kernels every MAAT epoch; each reads the gate flags
// on the device and, when none is set, writes the fast branch's result
// (nothing self-reachable, no ancestor counts, nothing aborted) and stops.
// The epoch never waits on the host.
//
// K11a replaces reach_of (:178-187) with the diagonal (:196, :216) and the
// ancestor counts (:220): the transitive closure of P over the live txns.
// The reference squares a bf16 copy of the matrix max(1, (B-1).bit_length())
// times on the MXU, which reaches every path of up to 2^k >= B edges, so
// it is the full closure.  Here it is computed on bits, one breadth-first
// search per source: a warp holds the source's reach row in shared memory
// and ORs in the successor row of every newly reached txn, each row once,
// four rows per step so their loads overlap.  Then the diagonal bit, and
// the column counts through per-block shared counters and one global
// atomicAdd per counter.
//   Bound: bytes — P (4 MB at B = 2048) read once, 2 B + 4 B out; the
//   searches then OR sum(|reach(i)|) rows of B/8 bytes, served from L2.
//
// K11b replaces the peel loop (:201-209): maat_peel_rounds rounds, each
// two precedence sweeps of sweep_rounds + 1 rounds (over P and over P^T,
// both restricted to the live txns), the cycle candidates
// candr = un_f & un_r & on_cycle0, and the victims: the candidates with no
// younger candidate neighbour in P | P^T ("younger": the higher rank, on
// equal rank the higher lane, :140-142).  One block of 1024 threads runs
// every round; the sweeps are bits.cuh's frontier sweep (the same Jacobi
// values), P's rows serve the P^T sweep and P's columns the P sweep.  The
// victims come from one pass over the edges between candidates: each edge
// marks its older end.  A round without candidates changes nothing, so
// the rounds stop there (before the second sweep where the first leaves
// no cycle member unstable).
//   Bound: bytes — P read once (4 MB at B = 2048), 2 B + 4 B in, B out;
//   the up to maat_peel_rounds x 2 x (sweep_rounds + 1) rounds run over
//   1 MB of bits in L2 (or shared memory where they fit).
#include "bits.cuh"

namespace {

constexpr int kReachWarps = 8;
constexpr int kPeelThreads = 1024;

__global__ void __launch_bounds__(kReachWarps * 32)
reach_kernel(const uint32_t* __restrict__ bits, const uint8_t* __restrict__ live,
             const uint8_t* __restrict__ gate, int B, int W,
             uint8_t* __restrict__ self_o, int32_t* __restrict__ anc) {
  extern __shared__ uint32_t sm[];
  uint32_t* L = sm;                                  // live set, W words
  int* cnt = reinterpret_cast<int*>(sm + W);         // column counts, B
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* R = sm + W + B + warp * 3 * W;           // reach row
  uint32_t* D = R + W;                               // expanded
  uint32_t* FR = D + W;                              // frontier
  const int i = blockIdx.x * kReachWarps + warp;
  if (!any_set(gate, B)) {
    if (i < B && lane == 0) self_o[i] = 0;
    return;
  }
  load_set(live, B, W, L);
  for (int j = threadIdx.x; j < B; j += blockDim.x) cnt[j] = 0;
  __syncthreads();
  if (i < B && bit(L, i)) {
    const uint32_t* src = bits + static_cast<size_t>(i) * W;
    for (int c = lane; c < W; c += 32) {
      R[c] = src[c] & L[c];
      D[c] = 0u;
    }
    __syncwarp();
    for (;;) {
      bool more = false;
      for (int c = lane; c < W; c += 32) {
        const uint32_t f = R[c] & ~D[c];
        FR[c] = f;
        D[c] |= f;
        more |= f != 0u;
      }
      if (!__any_sync(0xffffffffu, more)) break;
      __syncwarp();
      for (int w = 0; w < W; ++w) {
        uint32_t f = FR[w];
        while (f) {
          int k[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            k[q] = f ? w * 32 + __ffs(f) - 1 : -1;
            f &= f - 1;
          }
          for (int c = lane; c < W; c += 32) {
            uint32_t acc = 0u;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (k[q] >= 0) acc |= bits[static_cast<size_t>(k[q]) * W + c];
            R[c] |= acc & L[c];
          }
        }
      }
      __syncwarp();
    }
    if (lane == 0) self_o[i] = bit(R, i);
    for (int c = lane; c < W; c += 32)
      for (uint32_t r = R[c]; r; r &= r - 1)
        atomicAdd(&cnt[c * 32 + __ffs(r) - 1], 1);
  } else if (i < B && lane == 0) {
    self_o[i] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < B; j += blockDim.x)
    if (cnt[j]) atomicAdd(&anc[j], cnt[j]);
}

// Shared layout: L0, OC, AB, UF, F, Fn (W words each), list (B ints),
// then the staged rows (P's rows, then its columns) where they fit.
__global__ void __launch_bounds__(kPeelThreads)
peel_kernel(const uint32_t* __restrict__ bits_g, const uint8_t* __restrict__ live0,
            const uint8_t* __restrict__ on_cycle0,
            const int32_t* __restrict__ rank, const uint8_t* __restrict__ gate,
            int B, int W, int rounds, int peel_rounds, int rows_in_smem,
            uint8_t* __restrict__ aborted) {
  extern __shared__ uint32_t sm[];
  uint32_t* L0 = sm;
  uint32_t* OC = sm + W;
  uint32_t* AB = sm + 2 * W;
  uint32_t* UF = sm + 3 * W;
  uint32_t* F = sm + 4 * W;
  uint32_t* Fn = sm + 5 * W;
  int* list = reinterpret_cast<int*>(sm + 6 * W);
  const int tid = threadIdx.x, bd = blockDim.x;
  if (!any_set(gate, B)) {
    for (int j = tid; j < B; j += bd) aborted[j] = 0;
    return;
  }
  const size_t n = static_cast<size_t>(B) * W;
  const uint32_t* rows = stage_rows(
      bits_g, 2 * B, W, reinterpret_cast<uint32_t*>(list + B), rows_in_smem);
  const uint32_t* prow = rows;        // P's rows: predecessors under P^T
  const uint32_t* pcol = rows + n;    // P's columns: predecessors under P
  load_set(live0, B, W, L0);
  load_set(on_cycle0, B, W, OC);
  for (int w = tid; w < W; w += bd) AB[w] = 0u;
  const int team = tid / kTeam, tl = tid % kTeam, teams = bd / kTeam;
  for (int pr = 0; pr < peel_rounds; ++pr) {
    for (int w = tid; w < W; w += bd) F[w] = L0[w] & ~AB[w];
    __syncthreads();
    level_sweep(pcol, B, W, rounds, F, Fn, list, nullptr);
    int any = 0;
    for (int w = tid; w < W; w += bd) {
      UF[w] = F[w] & OC[w];
      F[w] = L0[w] & ~AB[w];
      any |= UF[w] != 0u;
    }
    if (!__syncthreads_or(any)) break;  // no candidate: nothing changes
    level_sweep(prow, B, W, rounds, F, Fn, list, nullptr);
    any = 0;
    for (int w = tid; w < W; w += bd) {
      UF[w] &= F[w];                    // the candidates
      Fn[w] = 0u;                       // their older ends
      any |= UF[w] != 0u;
    }
    if (!__syncthreads_or(any)) break;
    const int m = compact(UF, W, list);
    for (int x = team; x < m; x += teams) {
      const int j = list[x];
      const int32_t rj = rank[j];
      const uint32_t* row = prow + static_cast<size_t>(j) * W;
      for (int c = tl; c < W; c += kTeam) {
        for (uint32_t e = row[c] & UF[c]; e; e &= e - 1) {
          const int i = c * 32 + __ffs(e) - 1;
          const int32_t ri = rank[i];
          const bool i_younger = ri > rj || (ri == rj && i > j);
          const int older = i_younger ? j : i;
          atomicOr(&Fn[older >> 5], 1u << (older & 31));
        }
      }
    }
    __syncthreads();
    for (int w = tid; w < W; w += bd) AB[w] |= UF[w] & ~Fn[w];
    __syncthreads();
  }
  for (int j = tid; j < B; j += bd) aborted[j] = bit(AB, j);
}

}  // namespace

// K11a: p bool [B, B], live, gate bool [B] -> self_reach bool [B] (the
// diagonal of the closure over live), anc int32 [B] (its column sums);
// bits is [B, W] scratch.
DT_EXPORT int dt_maat_reach(const uint8_t* p, const uint8_t* live,
                            const uint8_t* gate, int B, uint32_t* bits,
                            uint8_t* self_reach, int32_t* anc, void* stream) {
  const int W = (B + 31) / 32;
  const cudaStream_t s = dt_stream(stream);
  cudaMemsetAsync(anc, 0, static_cast<size_t>(B) * sizeof(int32_t), s);
  pack_rows(p, B, W, bits, s);
  size_t smem;
  int staged;
  const cudaError_t err = plan_smem(
      reach_kernel,
      (static_cast<size_t>(W) * (1 + 3 * kReachWarps) + B) * 4, 0, &smem,
      &staged);
  if (err != cudaSuccess) return static_cast<int>(err);
  reach_kernel<<<dt_blocks(B, kReachWarps), kReachWarps * 32, smem, s>>>(
      bits, live, gate, B, W, self_reach, anc);
  return dt_status();
}

// K11b: p bool [B, B], live0, on_cycle0, gate bool [B], rank int32 [B] ->
// aborted bool [B]; bits is [2, B, W] scratch (P's rows, P's columns).
DT_EXPORT int dt_maat_peel(const uint8_t* p, const uint8_t* live0,
                           const uint8_t* on_cycle0, const int32_t* rank,
                           const uint8_t* gate, int B, int rounds,
                           int peel_rounds, uint32_t* bits, uint8_t* aborted,
                           void* stream) {
  const int W = (B + 31) / 32;
  const size_t n = static_cast<size_t>(B) * W;
  const cudaStream_t s = dt_stream(stream);
  pack_rows(p, B, W, bits, s);
  pack_cols(p, B, W, bits + n, s);
  size_t smem;
  int staged;
  const cudaError_t err =
      plan_smem(peel_kernel, (6 * static_cast<size_t>(W) + B) * 4, 2 * n * 4,
                &smem, &staged);
  if (err != cudaSuccess) return static_cast<int>(err);
  peel_kernel<<<1, kPeelThreads, smem, s>>>(bits, live0, on_cycle0, rank, gate,
                                            B, W, rounds, peel_rounds, staged,
                                            aborted);
  return dt_status();
}
