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
// it is the full closure.  Here it is computed on bits in three launches:
//   pack   P's live rows and columns as bits (a warp a 32 x 32 block:
//          two 16-byte loads a lane, a shuffle transpose), anc zeroed;
//   pivot  kPivots candidates (the first live txn at or after c B /
//          kPivots), two blocks each: one search along P's rows from the
//          candidate (F, what it reaches) and one along its columns (Bk,
//          what reaches it), each a single-source breadth-first search
//          that reads a txn's row once;
//   reach  every block takes the candidate whose strongly connected set
//          C = F n Bk is largest.  Every txn of C reaches exactly F, and
//          is on a cycle (it lies in F).  The other live txns (the
//          residual) run a multi-source search, a block per group of S
//          of them (S = 32 where shared memory holds three words a txn,
//          else 16 with two txns a word): per
//          txn v, seen[v] (bit s: residual source s reaches v by one or
//          more edges), front[v] (the bits that reached v at the last
//          level), next[v]; each level every v with a front ORs it into
//          next[u] of its live successors u outside C (a shared atomicOr,
//          skipped where u has the bits), and a successor in C marks the
//          sources as reaching C, and so all of F.  Then the diagonal
//          (bit s of seen[s]; 1 on C) and, with `counts`, anc[v] +=
//          popc(seen[v] | (v in F ? the sources reaching C : 0)) a block,
//          + |C| on F from block 0, one global atomicAdd per reached v.
// On MAAT's contended epochs most cycle members form one strongly
// connected set (~1,400 of ~1,740 live txns on ycsb_skew's epoch 4), so
// the searches read each row about three times (F, Bk, and a residual
// group's levels) instead of once per source.  With the gate all false
// every launch writes the fast branch's zeros and stops.
//   Bound: bytes — P (4 MB at B = 2048) read once, the flags in, 1 B +
//   4 B a txn out.  What holds it: the levels of the pivot searches (a
//   barrier and one round of row loads from L2 each).
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

constexpr int kReachThreads = 1024;
constexpr int kPackThreads = 256;
constexpr int kPackTile = kPackThreads / 32;  // 32 x 32 blocks a tile side
constexpr int kPackBlocks = 1056;        // 8 a SM
constexpr int kPivots = 4;               // candidates for the large set
constexpr int kPivotRows = 4;            // rows a pivot team loads at once

struct MinI {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
constexpr int kPeelThreads = 1024;

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

// rows[v * W + w] bit l = P[v][32 w + l] over live v and 32 w + l, and
// cols[u * W + w] bit l = P[32 w + l][u] likewise; anc (or null) zeroed.
// A block a tile of 8 x 8 blocks of 32 x 32 (256 x 256 bytes of P): warp k
// packs row block w0 + k against the tile's 8 column blocks (two 16-byte
// loads a lane each, a shuffle transpose for the columns), the words are
// staged in shared memory, and each row's (column's) 8 words go out as
// one 32-byte store.
__global__ void __launch_bounds__(kPackThreads)
reach_pack_kernel(const uint8_t* __restrict__ p,
                  const uint8_t* __restrict__ live,
                  const uint8_t* __restrict__ gate, int B, int W,
                  uint32_t* __restrict__ rows, uint32_t* __restrict__ cols,
                  int32_t* __restrict__ anc) {
  __shared__ uint32_t srow[kPackTile * 32][kPackTile + 1];
  __shared__ uint32_t scol[kPackTile * 32][kPackTile + 1];
  const int t = threadIdx.x, lane = t & 31, k = t >> 5;
  if (anc != nullptr)
    for (int j = blockIdx.x * kPackThreads + t; j < B;
         j += gridDim.x * kPackThreads)
      anc[j] = 0;
  if (!any_set(gate, B)) return;
  const bool vec = B % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int side = (W + kPackTile - 1) / kPackTile;
  for (int tile = blockIdx.x; tile < side * side; tile += gridDim.x) {
    const int w0 = (tile / side) * kPackTile, jb0 = (tile % side) * kPackTile;
    const int w = w0 + k, i = w * 32 + lane;
    const bool row_live = w < W && i < B && live[i];
    const uint8_t* row = p + static_cast<size_t>(i) * B;
    uint32_t x[kPackTile];
#pragma unroll
    for (int q = 0; q < kPackTile; ++q) {
      const int j0 = (jb0 + q) * 32;
      x[q] = 0u;
      if (row_live && j0 < B) {
        if (vec && j0 + 32 <= B) {
          x[q] = byte_bits32(row + j0);
        } else {
          for (int c = 0; c < 32 && j0 + c < B; ++c)
            x[q] |= (row[j0 + c] != 0 ? 1u : 0u) << c;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPackTile; ++q) {
      const int j = (jb0 + q) * 32 + lane;
      x[q] &= __ballot_sync(0xffffffffu, j < B && live[j]);
      srow[k * 32 + lane][q] = x[q];
      scol[q * 32 + lane][k] = transpose32(x[q]);
    }
    __syncthreads();
    for (int e = t; e < kPackTile * 32 * kPackTile; e += kPackThreads) {
      const int r = e / kPackTile, q = e % kPackTile;
      const int ii = w0 * 32 + r, ww = jb0 + q;
      if (ii < B && ww < W) rows[static_cast<size_t>(ii) * W + ww] = srow[r][q];
      const int jj = jb0 * 32 + r, wc = w0 + q;
      if (jj < B && wc < W) cols[static_cast<size_t>(jj) * W + wc] = scol[r][q];
    }
    __syncthreads();
  }
}

// Block 2 c + dir: candidate c, the first live txn at or after c B /
// kPivots (cyclically); a breadth-first search from it along P's rows
// (dir 0: what it reaches by one or more edges) or columns (dir 1: what
// reaches it).  out[(2 c + dir) W, + W) gets the set, plev[2 c + dir] the
// candidate (or -1 with no live txn) and plev[2 kPivots + 2 c + dir] the
// levels.  Shared: L, R (reached), N (next), W words each, then the
// front as a list, B ints (appended in any order: the rows are ORed).
__global__ void __launch_bounds__(kReachThreads)
reach_pivot_kernel(const uint32_t* __restrict__ rows,
                   const uint32_t* __restrict__ cols,
                   const uint8_t* __restrict__ live,
                   const uint8_t* __restrict__ gate, int B, int W,
                   uint32_t* __restrict__ out, int32_t* __restrict__ plev) {
  extern __shared__ uint32_t sm[];
  uint32_t* L = sm;
  uint32_t* R = sm + W;
  uint32_t* N = sm + 2 * W;
  int* list = reinterpret_cast<int*>(sm + 3 * W);
  __shared__ int cand;
  __shared__ int cnt[2];              // the front's size, by level parity
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31;
  if (!any_set(gate, B)) return;
  load_set(live, B, W, L);
  const int dir = blockIdx.x & 1;
  const long long start = static_cast<long long>(blockIdx.x >> 1) * B / kPivots;
  int best = B;                       // distance past start, cyclically
  for (int v = tid; v < B; v += bd)
    if (bit(L, v)) best = min(best, static_cast<int>((v - start + B) % B));
  best = dt_block_reduce(best, MinI(), B);
  if (tid == 0) {
    cand = best < B ? static_cast<int>((start + best) % B) : -1;
    list[0] = cand;
    cnt[0] = cand >= 0;
    cnt[1] = 0;
  }
  for (int w = tid; w < W; w += bd) R[w] = N[w] = 0u;
  __syncthreads();
  const uint32_t* mat = dir ? cols : rows;
  const int tl = tid % kTeam, teams = bd / kTeam;
  int level = 0;
  for (;; ++level) {
    const int n = cnt[level & 1];
    if (n == 0) break;
    if (tid == 0) cnt[(level + 1) & 1] = 0;
    for (int c0 = 0; c0 < W; c0 += kTeam * kUnroll) {
      uint32_t acc[kUnroll] = {};
      // kPivotRows rows a step, so their loads overlap
      for (int x = tid / kTeam; x < n; x += kPivotRows * teams) {
        const uint32_t* r[kPivotRows];
#pragma unroll
        for (int h = 0; h < kPivotRows; ++h)
          r[h] = x + h * teams < n
              ? mat + static_cast<size_t>(list[x + h * teams]) * W : nullptr;
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int cc = c0 + q * kTeam + tl;
#pragma unroll
          for (int h = 0; h < kPivotRows; ++h)
            if (cc < W && r[h] != nullptr) acc[q] |= r[h][cc];
        }
      }
      // the warp's four teams, then one atomicOr a word
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        acc[q] |= __shfl_xor_sync(0xffffffffu, acc[q], 8);
        acc[q] |= __shfl_xor_sync(0xffffffffu, acc[q], 16);
        const int cc = c0 + q * kTeam + tl;
        if (lane < kTeam && cc < W && acc[q]) atomicOr(&N[cc], acc[q]);
      }
    }
    __syncthreads();
    // the new front: reached now and not before, appended to the list
    for (int w = tid; w < W; w += bd) {
      const uint32_t nw = N[w] & ~R[w];
      R[w] |= nw;
      N[w] = 0u;
      if (nw) {
        int at = atomicAdd(&cnt[(level + 1) & 1], __popc(nw));
        for (uint32_t x = nw; x; x &= x - 1) list[at++] = w * 32 + __ffs(x) - 1;
      }
    }
    __syncthreads();
  }
  for (int w = tid; w < W; w += bd)
    out[static_cast<size_t>(blockIdx.x) * W + w] = R[w];
  if (tid == 0) {
    plev[blockIdx.x] = cand;
    plev[2 * kPivots + blockIdx.x] = level;
  }
}

// A group of S sources (32 or 16): T holds R = 32 / S txns a word.
template <int S> struct Group {
  using T = uint32_t;
  static constexpr int R = 32 / S;
};

// Txn h of a word's R txns.
template <int S>
__device__ __forceinline__ typename Group<S>::T sub(typename Group<S>::T x,
                                                     int h) {
  if constexpr (Group<S>::R == 1) return x;
  else return (x >> (S * h)) & ((1u << S) - 1u);
}

template <int S>
__device__ __forceinline__ typename Group<S>::T get(
    const typename Group<S>::T* a, int v) {
  constexpr int R = Group<S>::R;
  return sub<S>(a[v / R], v % R);
}

template <int S>
__device__ __forceinline__ void or_at(typename Group<S>::T* a, int v,
                                      typename Group<S>::T x) {
  constexpr int R = Group<S>::R;
  atomicOr(&a[v / R], x << (S * (v % R)));
}

template <typename T>
__device__ __forceinline__ T block_or(T v, T* slot) {
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0 && v) atomicOr(slot, v);
  __syncthreads();
  return *slot;
}

// Block g: residual sources of rank [g S, g S + S) (the live txns outside
// C, in index order); block 0 also writes the diagonal of every txn
// outside the residual and adds |C| on F.  Shared: front, next, seen (NW
// words of T each), then L, C and FP (F of the chosen candidate), W words
// each.  stats (or null): candidate, |C|, residual sources, its F search's
// levels.
template <int S>
__global__ void __launch_bounds__(kReachThreads)
reach_kernel(const uint32_t* __restrict__ rows,
             const uint8_t* __restrict__ live, const uint8_t* __restrict__ gate,
             const uint32_t* __restrict__ piv, const int32_t* __restrict__ plev,
             int B, int W, uint8_t* __restrict__ self_o,
             int32_t* __restrict__ anc, int32_t* __restrict__ levels_o,
             int32_t* __restrict__ stats_o) {
  using T = typename Group<S>::T;
  constexpr int R = Group<S>::R;
  extern __shared__ uint32_t smw[];
  __shared__ int src[S];
  __shared__ int pc[kPivots];         // the candidates' set sizes
  __shared__ T flag_s;                // the sources reaching C
  const int NW = (B + R - 1) / R;
  T* front = smw;
  T* next = front + NW;
  T* seen = next + NW;
  uint32_t* L = reinterpret_cast<uint32_t*>(seen + NW);
  uint32_t* C = L + W;
  uint32_t* FP = C + W;
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31;
  const int g = blockIdx.x;
  if (!any_set(gate, B)) {
    for (int b = tid; b < S && g * S + b < B; b += bd) self_o[g * S + b] = 0;
    if (levels_o != nullptr && tid == 0) levels_o[g] = 0;
    if (stats_o != nullptr && g == 0 && tid < 4) stats_o[tid] = 0;
    return;
  }
  if (tid == 0) flag_s = 0;
  if (tid < kPivots) pc[tid] = 0;
  load_set(live, B, W, L);
  // the candidates' strongly connected sets, one pass over their words
  int cnt[kPivots] = {};
  for (int w = tid; w < W; w += bd)
#pragma unroll
    for (int c = 0; c < kPivots; ++c) {
      const uint32_t* f = piv + static_cast<size_t>(2 * c) * W;
      cnt[c] += __popc(f[w] & f[W + w]);
    }
#pragma unroll
  for (int c = 0; c < kPivots; ++c) {
    const int x = dt_warp_reduce(cnt[c], AddI());
    if (lane == 0 && x) atomicAdd(&pc[c], x);
  }
  __syncthreads();
  // the largest (the lowest candidate on a tie; one with no live txn
  // counts 0)
  int cbest = 0;
  for (int c = 1; c < kPivots; ++c)
    if (pc[c] > pc[cbest]) cbest = c;
  const int n_c = pc[cbest];
  const uint32_t* fb = piv + static_cast<size_t>(2 * cbest) * W;
  for (int w = tid; w < W; w += bd) {
    const uint32_t f = fb[w];
    C[w] = f & fb[W + w];
    FP[w] = f;
  }
  __syncthreads();
  // the residual's ranks: a scan of popc(L & ~C) over the words
  int n_res = 0;
  for (int base = 0; base < W; base += bd) {
    const int w = base + tid;
    const uint32_t rw = w < W ? L[w] & ~C[w] : 0u;
    int total;
    const int incl = dt_block_incl_scan(__popc(rw), AddI(), 0, total);
    int rank = n_res + incl - __popc(rw);
    for (uint32_t x = rw; x; x &= x - 1, ++rank)
      if (rank >= g * S && rank < g * S + S)
        src[rank - g * S] = w * 32 + __ffs(x) - 1;
    n_res += total;
  }
  __syncthreads();
  const int nsrc = max(0, min(S, n_res - g * S));
  if (g == 0) {
    for (int v = tid; v < B; v += bd)
      if (!bit(L, v) || bit(C, v)) self_o[v] = bit(C, v);
    if (anc != nullptr && n_c)
      for (int v = tid; v < B; v += bd)
        if (bit(FP, v)) atomicAdd(&anc[v], n_c);
    if (stats_o != nullptr && tid == 0) {
      stats_o[0] = plev[2 * cbest];
      stats_o[1] = n_c;
      stats_o[2] = n_res;
      stats_o[3] = plev[2 * kPivots + 2 * cbest];
    }
  }
  if (nsrc == 0) {
    if (levels_o != nullptr && tid == 0) levels_o[g] = 0;
    return;
  }
  for (int x = tid; x < NW; x += bd) {
    front[x] = 0;
    next[x] = 0;
    seen[x] = 0;
  }
  __syncthreads();
  for (int b = tid; b < nsrc; b += bd)
    or_at<S>(front, src[b], static_cast<T>(1) << b);
  __syncthreads();
  const int tl = tid % kTeam, teams = bd / kTeam;
  T flag = 0;                         // this thread's sources reaching C
  int level = 0;
  for (bool more = true; more;) {
    ++level;
    for (int v = tid / kTeam; v < B; v += teams) {
      const T f = get<S>(front, v);
      if (!f) continue;
      const uint32_t* row = rows + static_cast<size_t>(v) * W;
      for (int c0 = 0; c0 < W; c0 += kTeam * kUnroll) {
        uint32_t e[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int c = c0 + q * kTeam + tl;
          e[q] = c < W ? row[c] : 0u;
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int c = c0 + q * kTeam + tl;
          if (c >= W) continue;
          if (e[q] & C[c]) flag |= f;
          // bits u has, or another v gave it this level (a stale read
          // only costs an atomic)
          for (uint32_t x = e[q] & ~C[c]; x; x &= x - 1) {
            const int u = c * 32 + __ffs(x) - 1;
            const T add = f & ~get<S>(seen, u) & ~get<S>(next, u);
            if (add) or_at<S>(next, u, add);
          }
        }
      }
    }
    __syncthreads();
    int any = 0;
    for (int x = tid; x < NW; x += bd) {
      const T nx = next[x];
      const T nf = nx & ~seen[x];
      seen[x] |= nf;
      front[x] = nf;
      next[x] = 0;
      any |= nf != 0;
    }
    more = __syncthreads_or(any) != 0;
  }
  const T fl = block_or(flag, &flag_s);
  for (int b = tid; b < nsrc; b += bd)
    self_o[src[b]] = (get<S>(seen, src[b]) >> b) & 1;
  if (anc != nullptr)
    for (int v = tid; v < B; v += bd) {
      const int cnt = __popc(get<S>(seen, v) | (bit(FP, v) ? fl : 0u));
      if (cnt) atomicAdd(&anc[v], cnt);
    }
  if (levels_o != nullptr && tid == 0) levels_o[g] = level;
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

template <int S>
static int launch_reach(const uint32_t* rows, const uint8_t* live,
                        const uint8_t* gate, const uint32_t* piv,
                        const int32_t* plev, int B, int W,
                        uint8_t* self_reach, int32_t* anc, int32_t* levels,
                        int32_t* stats, cudaStream_t s) {
  using T = typename Group<S>::T;
  const size_t nw = (B + Group<S>::R - 1) / Group<S>::R;
  const size_t smem = 3 * nw * sizeof(T) + 3 * static_cast<size_t>(W) * 4;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaFuncSetAttribute(reach_kernel<S>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return dt_status();
  reach_kernel<S><<<(B + S - 1) / S, kReachThreads, smem, s>>>(
      rows, live, gate, piv, plev, B, W, self_reach, anc, levels, stats);
  return dt_status();
}

// K11a: p bool [B, B], live, gate bool [B] -> self_reach bool [B] (the
// diagonal of the closure over live) and, where `counts`, anc int32 [B]
// (its column sums; else anc is not written); residual groups of `group`
// (32 or 16) sources; levels (or null) int32 [ceil(B / group)] gets
// each group's level count, stats (or null) int32 [4] the chosen
// candidate, |C|, the residual's size and the candidate's F levels.
// scratch: int32 [2 B W + 2 kPivots W + 4 kPivots] (P's live rows and
// columns, the candidates' sets, their txns and levels); scratch_len is
// its length, and a shorter one is refused before any launch.
DT_EXPORT int dt_maat_reach(const uint8_t* p, const uint8_t* live,
                            const uint8_t* gate, int B, int group, int counts,
                            uint32_t* scratch, long long scratch_len,
                            uint8_t* self_reach, int32_t* anc,
                            int32_t* levels, int32_t* stats, void* stream) {
  if (B <= 0 || (group != 32 && group != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = (B + 31) / 32;
  const size_t n = static_cast<size_t>(B) * W;
  if (scratch_len < 0 ||
      static_cast<size_t>(scratch_len) <
          2 * n + 2 * kPivots * static_cast<size_t>(W) + 4 * kPivots)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = dt_stream(stream);
  uint32_t* rows = scratch;
  uint32_t* cols = scratch + n;
  uint32_t* piv = scratch + 2 * n;
  int32_t* plev = reinterpret_cast<int32_t*>(
      piv + 2 * kPivots * static_cast<size_t>(W));
  int32_t* out_anc = counts ? anc : nullptr;
  const long long warps = static_cast<long long>(W) * W;
  const long long blocks =
      (warps + kPackThreads / 32 - 1) / (kPackThreads / 32);
  reach_pack_kernel<<<static_cast<int>(blocks < kPackBlocks ? blocks
                                                            : kPackBlocks),
                      kPackThreads, 0, s>>>(p, live, gate, B, W, rows, cols,
                                            out_anc);
  const size_t psmem =
      3 * static_cast<size_t>(W) * 4 + static_cast<size_t>(B) * 4;
  if (psmem > kSmemMax ||
      cudaFuncSetAttribute(reach_pivot_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(psmem)) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  reach_pivot_kernel<<<2 * kPivots, kReachThreads, psmem, s>>>(
      rows, cols, live, gate, B, W, piv, plev);
  switch (group) {
    case 32:
      return launch_reach<32>(rows, live, gate, piv, plev, B, W, self_reach,
                              out_anc, levels, stats, s);
    case 16:
      return launch_reach<16>(rows, live, gate, piv, plev, B, W, self_reach,
                              out_anc, levels, stats, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
