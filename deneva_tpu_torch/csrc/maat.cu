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
// two precedence sweeps of sweep_rounds Jacobi rounds (over P and over
// P^T, both restricted to the live txns), the cycle candidates
// candr = un_f & un_r & on_cycle0, and the victims: the candidates with no
// younger candidate neighbour in P | P^T ("younger": the higher rank, on
// equal rank the higher lane, :140-142).  One launch of a thread-block
// cluster of C CTAs (peel_kernel): each owns an equal share of the txns
// and keeps their rows of P and P^T in shared memory (one bulk copy)
// where they fit, else reads them from L2; the sets are replicated in
// every CTA, and the two sweeps of a peel round advance in the same
// rounds, each CTA testing its own txns' rows and handing its words of
// both next frontiers to the others by st.async (cluster.cuh): no
// cluster barrier a round.  The rows are K11a's: its first call packs P
// over live0, and the peel reads only live0's rows against sets inside
// live0, so the live mask changes no answer.  A round without
// candidates changes nothing, so the rounds stop there.
//   Bound: bytes — K11a's bits of P's rows and columns read once (2 B W
// words, 1 MiB at B = 2048; K11a's own bound counts P), 3 B of flags and
// 4 B of ranks in, B out;
//   what holds it: the exchanges, one a sweep round and one a peel
//   round, each waiting for the CTA with the most members to scan.
#include "bits.cuh"
#include "cluster.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

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

// ---- K11b ----------------------------------------------------------------

constexpr int kPeelThreads = 1024;
constexpr int kPeelMaxCtas = 16;   // the non-portable cluster size
constexpr int kPeelOwnCap = 8;     // owned words a CTA, where rows fit
constexpr int kPeelWarps = kPeelThreads / 32;

// Shared words of a peel CTA: with the rows in shared memory, its owned
// txns' P rows and P columns (32 own rows of W words each); then the sets
// L0, OC, AB, UF, Fin[2] and X[2][2] (W4 = W rounded up to 4 words each,
// so every set starts 16-byte aligned), flags[2][kPeelMaxCtas], with
// `ranks` the ranks (B rounded up to 4; else they are read from global
// memory), the owned txns' witnesses (a predecessor each way, a younger
// neighbour), the list of members to scan and its count, and three
// 8-byte mbarriers.
__host__ __device__ __forceinline__ size_t peel_smem_words(int B, int W,
                                                           int own,
                                                           int in_smem,
                                                           int ranks) {
  const size_t w4 = (static_cast<size_t>(W) + 3) & ~static_cast<size_t>(3);
  const size_t rows =
      in_smem ? 2 * 32 * static_cast<size_t>(own) * W : 0;
  const size_t b4 =
      ranks ? (static_cast<size_t>(B) + 3) & ~static_cast<size_t>(3) : 0;
  return ((rows + 3) & ~static_cast<size_t>(3)) + 10 * w4 +
         2 * kPeelMaxCtas + b4 + 5 * 32 * static_cast<size_t>(own) + 4 + 8;
}

// The lowest of the warp's indices (-1: none in any lane), in every lane.
__device__ __forceinline__ int warp_min(int v) {
  return static_cast<int>(
      __reduce_min_sync(0xffffffffu, static_cast<unsigned>(v)));
}

// A witness for a listed member, a warp a row: the lowest txn of row &
// set & pref (W words), else of row & set; -1 where the row meets no txn
// of the set.  Lane l takes the 16-byte chunks (`vec`: W a multiple of
// 4) or words l, l + 32, ...  A witness on a cycle stays in the frontier
// through the rounds, so `pref` (on_cycle0) is tried first.
__device__ __forceinline__ int warp_first(const uint32_t* row,
                                          const uint32_t* set,
                                          const uint32_t* pref, int W,
                                          bool vec) {
  const int lane = threadIdx.x & 31;
  int f = -1, g = -1;
  if (vec) {
    const uint4* r = reinterpret_cast<const uint4*>(row);
    const uint4* s = reinterpret_cast<const uint4*>(set);
    const uint4* o = reinterpret_cast<const uint4*>(pref);
    for (int c = lane; c < (W >> 2) && f < 0; c += 32) {
      const uint4 a = r[c], b = s[c], p = o[c];
      const uint32_t m[4] = {a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w};
      const uint32_t q[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        if (m[k] & q[k]) f = 32 * (4 * c + k) + __ffs(m[k] & q[k]) - 1;
        if (m[k] && g < 0) g = 32 * (4 * c + k) + __ffs(m[k]) - 1;
      }
    }
  } else {
    for (int c = lane; c < W && f < 0; c += 32)
      if (const uint32_t m = row[c] & set[c]) {
        if (m & pref[c]) f = 32 * c + __ffs(m & pref[c]) - 1;
        if (g < 0) g = 32 * c + __ffs(m) - 1;
      }
  }
  f = warp_min(f);
  return f >= 0 ? f : warp_min(g);
}

// A younger candidate neighbour of candidate j in P | P^T, a warp a
// candidate (row and col its row and column of P): the lowest txn i of
// (row | col) & uf with the higher rank, on equal rank the higher lane
// (deneva_tpu/cc/maat.py:140-142); -1 where none.
__device__ __forceinline__ int warp_younger(const uint32_t* row,
                                            const uint32_t* col,
                                            const uint32_t* uf,
                                            const int32_t* rk, int j, int W) {
  const int lane = threadIdx.x & 31;
  const int32_t rj = rk[j];
  int f = -1;
  for (int c = lane; c < W && f < 0; c += 32)
    for (uint32_t e = (row[c] | col[c]) & uf[c]; e; e &= e - 1) {
      const int i = c * 32 + __ffs(e) - 1;
      const int32_t ri = rk[i];
      if (ri > rj || (ri == rj && i > j)) {
        f = i;
        break;
      }
    }
  return warp_min(f);
}

// Send this CTA's owned words [w0, w0 + nown) of the ns sets a, b (ns 1
// or 2) to every other CTA, and with `flag` its flag fl[cr] (warp 0 wrote
// it, thread 0 before this arrival), counted on their mbarrier bar; wait
// for the others'.  Every thread returns the OR of all CTAs' flags; every
// CTA then holds the whole sets.
__device__ __forceinline__ uint32_t exchange(uint32_t* a, uint32_t* b, int ns,
                                             bool flag, uint32_t* fl,
                                             uint64_t* bar, uint32_t phase,
                                             int C, int cr, int own, int W) {
  const int w0 = min(cr * own, W), nown = min(own, W - w0);
  uint32_t rx = 0u;
  for (int q = 0; q < C; ++q)
    if (q != cr) rx += 4u * (ns * min(own, W - min(q * own, W)) + flag);
  if (threadIdx.x == 0) mbar_expect(bar, rx);
  const int per = ns * nown;
  for (int e = threadIdx.x; e < per * C; e += blockDim.x) {
    const int q = e / per, k = e % per;
    if (q == cr) continue;
    uint32_t* at = k < nown ? a + w0 + k : b + w0 + k - nown;
    st_remote(remote(at, q), *at, remote(bar, q));
  }
  const int q = threadIdx.x;
  if (flag && q < C && q != cr)
    st_remote(remote(fl + cr, q), fl[cr], remote(bar, q));
  mbar_wait(bar, phase);
  uint32_t all = 0u;
  if (flag)
    for (int k = 0; k < C; ++k) all |= fl[k];
  return all;
}

// K11b: one thread-block cluster of C CTAs (C = 1 included).  CTA r owns
// the words [r own, (r + 1) own) of the B-bit sets, i.e. txns [32 r own,
// 32 (r + 1) own), and keeps their rows of P (successors: predecessors
// under P^T) and of P^T (P's columns: predecessors under P) in shared
// memory (kSmem, staged by one bulk copy behind an mbarrier) or reads them
// from L2; every CTA keeps a replica of L0 = live0, OC = on_cycle0, AB =
// aborted, the candidates UF, each direction's frontier and, where they
// fit (rk_smem), the ranks.
// A peel round sets both frontiers to L0 & ~AB and advances them in the
// same exchanges (F_{r+1} = the members of F_r with a predecessor in F_r,
// bits.cuh's Jacobi rounds on the frontier).  Each owned member keeps a
// witness, a predecessor found in F earlier: where it is still in F the
// member stays without a look at its row, else the member is listed and a
// warp scans its row for a new one (one on a cycle first, as those stay).
// A CTA then writes its owned words of the next frontiers and a flag
// (which direction changed, which is non-empty, whether an owned txn is
// still a candidate of both and on a cycle) and sends them to every
// other CTA by st.async onto the receiver's mbarrier.  So every CTA holds
// the same sets after each exchange and takes the same exits: a
// direction stops at its fixpoint (no change, or empty) or after
// `rounds`; the peel round's sweeps stop when no candidate is left (the
// candidates only shrink) and the peel when a round has none.  The victim
// pass is local and works the same way: a candidate whose younger witness
// is still a candidate stays, a warp scans each other's row and column
// for a younger candidate neighbour, and one without is a victim; one
// exchange of the owned victim words updates AB everywhere.  Exchange x
// writes the buffer pair X[(x + 1) & 1] and reads X[x & 1]; a CTA sends
// exchange x + 1 only after every CTA's exchange x arrived, so no store
// meets a read (cluster.cuh).  stats (or null): the peel rounds with
// candidates, the sweep exchanges, the victims, C.
template <bool kSmem>
__global__ void __launch_bounds__(kPeelThreads, 1)
peel_kernel(const uint32_t* __restrict__ rows_g,
            const uint32_t* __restrict__ cols_g,
            const uint8_t* __restrict__ live0,
            const uint8_t* __restrict__ on_cycle0,
            const int32_t* __restrict__ rank, const uint8_t* __restrict__ gate,
            int B, int W, int own, int rk_smem, int rounds,
            int peel_rounds, uint8_t* __restrict__ aborted,
            int32_t* __restrict__ stats) {
  extern __shared__ __align__(128) uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int cr = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = min(cr * own, W), nown = min(own, W - w0);
  const int row0 = 32 * w0, nt = 32 * nown;
  const int nrows = max(0, min(B, row0 + nt) - row0);
  const int w4 = (W + 3) & ~3;
  const bool vec = (W & 3) == 0;
  const size_t tile = kSmem ? 32 * static_cast<size_t>(own) * W : 0;
  uint32_t* prow_s = sm;
  uint32_t* pcol_s = sm + tile;
  uint32_t* L0 = sm + ((2 * tile + 3) & ~static_cast<size_t>(3));
  uint32_t* OC = L0 + w4;
  uint32_t* AB = OC + w4;
  uint32_t* UF = AB + w4;
  uint32_t* X0 = UF + 3 * w4;             // X[par][d] = X0 + (2 par + d) w4
  uint32_t* flags = X0 + 4 * w4;          // [2][kPeelMaxCtas]
  int32_t* rk_s = reinterpret_cast<int32_t*>(flags + 2 * kPeelMaxCtas);
  const int32_t* rk = rk_smem ? rk_s : rank;
  int* wit = rk_s + (rk_smem ? (B + 3) & ~3 : 0);  // [2][nt]: a predecessor
  int* ywit = wit + 64 * own;             // [nt]: a younger neighbour
  int* list = ywit + 32 * own;            // [2 nt]: members to scan
  int* nlist = list + 64 * own;
  uint64_t* bar = reinterpret_cast<uint64_t*>(nlist + 4);  // x[2], copy
  const int end = min(B, row0 + nt);
  // X[par][d] and direction d's frontier once its sweep ended
  auto xset = [&](int par, int d) { return X0 + (2 * par + d) * w4; };
  auto fin = [&](int d) { return UF + (1 + d) * w4; };
  if (!any_set(gate, B)) {
    for (int j = row0 + tid; j < end; j += blockDim.x) aborted[j] = 0;
    return;
  }
  mbar_init(bar, 3);
  for (int w = tid; w < 10 * w4; w += blockDim.x) L0[w] = 0u;
  if (rk_smem)
    for (int i = tid; i < B; i += blockDim.x) rk_s[i] = rank[i];
  for (int t = tid; t < 96 * own; t += blockDim.x) wit[t] = -1;
  if (tid == 0) *nlist = 0;
  __syncthreads();
  if (kSmem && nrows > 0) {
    const size_t off = static_cast<size_t>(row0) * W;
    const uint32_t bytes = static_cast<uint32_t>(nrows) * W * 4u;
    if (vec && reinterpret_cast<uintptr_t>(rows_g) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(cols_g) % 16 == 0) {
      if (tid == 0) {
        mbar_expect(bar + 2, 2 * bytes);
        bulk_copy(prow_s, rows_g + off, bytes, bar + 2);
        bulk_copy(pcol_s, cols_g + off, bytes, bar + 2);
      }
    } else {
      for (size_t e = tid; e < bytes / 4; e += blockDim.x) {
        prow_s[e] = rows_g[off + e];
        pcol_s[e] = cols_g[off + e];
      }
      if (tid == 0) mbar_expect(bar + 2, 0u);
    }
  }
  load_set(live0, B, W, L0);
  load_set(on_cycle0, B, W, OC);
  if (kSmem && nrows > 0) mbar_wait(bar + 2, 0);
  __syncthreads();
  if (C > 1) cluster_start();
  // the predecessor rows of an owned txn (local index jl), by direction:
  // d = 0 sweeps P (P's columns), d = 1 sweeps P^T (P's rows)
  auto row_of = [&](int d, int jl) -> const uint32_t* {
    if (kSmem) return (d ? prow_s : pcol_s) + static_cast<size_t>(jl) * W;
    return (d ? rows_g : cols_g) + static_cast<size_t>(row0 + jl) * W;
  };
  uint32_t x = 0;                 // exchanges so far
  int n_peel = 0, n_sweep = 0;
  for (int pr = 0; pr < peel_rounds; ++pr) {
    // both frontiers start at L0 & ~AB; no candidate there, none later
    int any = 0;
    for (int w = tid; w < W; w += blockDim.x) {
      const uint32_t f = L0[w] & ~AB[w];
      xset(x & 1, 0)[w] = xset(x & 1, 1)[w] = f;
      if (rounds == 0) fin(0)[w] = fin(1)[w] = f;
      any |= (f & OC[w]) != 0u;
    }
    if (!__syncthreads_or(any)) break;
    int am = rounds > 0 ? 3 : 0;        // bit d: direction d still runs
    bool cand = true;
    for (int r = 0; r < rounds && am; ++r) {
      const int par = x & 1;
      // direction d's frontier this round and next (fin(d) once it ran)
      auto cur = [&](int d) {
        return (am >> d) & 1 ? xset(par, d) : fin(d);
      };
      auto nxt = [&](int d) {
        return (am >> d) & 1 ? xset(par ^ 1, d) : fin(d);
      };
      // an owned member stays where its witness is still in F (its owned
      // words by ballot), else it is listed; a warp scans a listed row
      for (int e = tid; e < 2 * nt; e += blockDim.x) {
        const int d = e >= nt, t = e - d * nt, j = row0 + t;
        if (!((am >> d) & 1)) continue;
        const bool in = j < B && bit(cur(d), j);
        const int wv = wit[e];
        const bool keep = in && wv >= 0 && bit(cur(d), wv);
        const unsigned kb = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) nxt(d)[w0 + (t >> 5)] = kb;
        push(in && !keep, e, list, nlist);
      }
      __syncthreads();
      const int nl = *nlist;
      for (int at = warp; at < nl; at += kPeelWarps) {
        const int e = list[at];
        const int d = e >= nt, t = e - d * nt;
        const int f = warp_first(row_of(d, t), cur(d), OC, W, vec);
        if (lane == 0 && f >= 0) {
          wit[e] = f;
          atomicOr(&nxt(d)[w0 + (t >> 5)], 1u << (t & 31));
        }
      }
      __syncthreads();
      // this CTA's flag: bit 2d changed, bit 2d + 1 non-empty, bit 4 a
      // candidate left
      uint32_t* fl = flags + par * kPeelMaxCtas;
      if (warp == 0) {
        uint32_t f = 0u;
        for (int t = lane; t < nown; t += 32) {
          const int w = w0 + t;
#pragma unroll
          for (int d = 0; d < 2; ++d)
            if ((am >> d) & 1) {
              f |= (nxt(d)[w] != cur(d)[w] ? 1u : 0u) << (2 * d);
              f |= (nxt(d)[w] != 0u ? 1u : 0u) << (2 * d + 1);
            }
          f |= ((nxt(0)[w] & nxt(1)[w] & OC[w]) != 0u ? 1u : 0u) << 4;
        }
        f = __reduce_or_sync(0xffffffffu, f);
        if (lane == 0) {
          fl[cr] = f;
          *nlist = 0;
        }
        __syncwarp();
      }
      uint32_t all;
      if (C > 1) {
        all = exchange(am & 1 ? nxt(0) : nxt(1), nxt(1), __popc(am), true,
                       fl, bar + par, (x >> 1) & 1, C, cr, own, W);
      } else {
        __syncthreads();
        all = fl[0];
      }
      ++x;
      ++n_sweep;
      cand = (all >> 4) & 1u;
      int done = 0;                     // directions at their end
#pragma unroll
      for (int d = 0; d < 2; ++d)
        if (((am >> d) & 1) && (!((all >> (2 * d)) & 1u) ||
                                !((all >> (2 * d + 1)) & 1u) ||
                                r == rounds - 1)) {
          done |= 1 << d;
          for (int w = tid; w < W; w += blockDim.x) fin(d)[w] = nxt(d)[w];
        }
      if (done) __syncthreads();
      am &= ~done;
      if (!cand) break;
    }
    if (!cand) break;
    // the candidates, then the victims: a candidate whose younger
    // witness is still a candidate stays, the others are listed and a
    // warp scans a listed row and column for a younger candidate
    // neighbour; one without is a victim
    for (int w = tid; w < W; w += blockDim.x)
      UF[w] = fin(0)[w] & fin(1)[w] & OC[w];
    uint32_t* V = xset((x & 1) ^ 1, 0);
    __syncthreads();
    for (int t = tid; t < nt; t += blockDim.x) {
      const int j = row0 + t;
      const bool c = j < B && bit(UF, j);
      const int yv = ywit[t];
      const bool keep = c && yv >= 0 && bit(UF, yv);
      if (lane == 0) V[w0 + (t >> 5)] = 0u;
      push(c && !keep, t, list, nlist);
    }
    __syncthreads();
    const int nl = *nlist;
    for (int at = warp; at < nl; at += kPeelWarps) {
      const int t = list[at];
      const int y = warp_younger(row_of(1, t), row_of(0, t), UF, rk,
                                 row0 + t, W);
      if (lane == 0) {
        if (y >= 0) ywit[t] = y;
        else atomicOr(&V[w0 + (t >> 5)], 1u << (t & 31));
      }
    }
    __syncthreads();
    if (tid == 0) *nlist = 0;
    if (C > 1)
      exchange(V, V, 1, false, flags, bar + (x & 1), (x >> 1) & 1, C, cr,
               own, W);
    ++x;
    ++n_peel;
    for (int w = tid; w < W; w += blockDim.x) AB[w] |= V[w];
    __syncthreads();
  }
  for (int j = row0 + tid; j < end; j += blockDim.x) aborted[j] = bit(AB, j);
  if (stats != nullptr && cr == 0 && tid == 0) {
    int v = 0;
    for (int w = 0; w < W; ++w) v += __popc(AB[w]);
    stats[0] = n_peel;
    stats[1] = n_sweep;
    stats[2] = v;
    stats[3] = C;
  }
}

// K11b's layout at B txns (W = ceil(B / 32) words a row): the fewest
// CTAs, at most `top`, whose shares of P's rows and columns fit shared
// memory beside the sets and the ranks and own at most kPeelOwnCap
// words (or the top where none owns fewer), else `top` CTAs reading the
// rows from L2, with the ranks in shared memory where they fit.
struct PeelLayout {
  int W, ctas, own, in_smem, ranks;
  size_t smem;
};

bool peel_layout(int B, int max_ctas, PeelLayout& l) {
  if (B < 1 || (max_ctas != 0 && max_ctas != 1 && max_ctas != 2 &&
                max_ctas != 4 && max_ctas != 8 && max_ctas != 16))
    return false;
  const int W = (B + 31) / 32;
  const int top = max_ctas == 0 ? kPeelMaxCtas : max_ctas;
  const size_t room = dt_smem_room(peel_kernel<true>);
  for (int c = 1; c <= top; c *= 2) {
    const int own = (W + c - 1) / c;
    if (own > kPeelOwnCap && c < top) continue;
    const size_t smem = peel_smem_words(B, W, own, 1, 1) * 4;
    if (smem <= room) {
      l = {W, c, own, 1, 1, smem};
      return true;
    }
  }
  const int own = (W + top - 1) / top;
  const size_t l2_room = dt_smem_room(peel_kernel<false>);
  const int ranks = peel_smem_words(B, W, own, 0, 1) * 4 <= l2_room;
  l = {W, top, own, 0, ranks, peel_smem_words(B, W, own, 0, ranks) * 4};
  return l.smem <= l2_room;
}

template <bool kSmem>
int launch_peel(const uint32_t* bits, const uint8_t* live0,
                const uint8_t* on_cycle0, const int32_t* rank,
                const uint8_t* gate, int B, int rounds, int peel_rounds,
                const PeelLayout& l, uint8_t* aborted, int32_t* stats,
                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      peel_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err == cudaSuccess && l.ctas > 8)
    err = cudaFuncSetAttribute(peel_kernel<kSmem>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.ctas);
  cfg.blockDim = dim3(kPeelThreads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const size_t n = static_cast<size_t>(B) * l.W;
  err = cudaLaunchKernelEx(&cfg, peel_kernel<kSmem>, bits, bits + n, live0,
                           on_cycle0, rank, gate, B, l.W, l.own, l.ranks,
                           rounds, peel_rounds, aborted, stats);
  return static_cast<int>(err);
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

// K11b's layout at B txns in a cluster of at most `max_ctas` (0: the
// library's choice; 1, 2, 4, 8 or 16) CTAs: out[0] the cluster's CTAs,
// out[1] 1 where the rows sit in shared memory, out[2] the int32 words
// of `bits` dt_maat_peel reads (P's rows, then its columns).  Launches
// nothing.
DT_EXPORT int dt_maat_peel_layout(int B, int max_ctas, long long* out) {
  PeelLayout l;
  if (!peel_layout(B, max_ctas, l)) return 1;
  out[0] = l.ctas;
  out[1] = l.in_smem;
  out[2] = 2LL * B * l.W;
  return 0;
}

// K11b: live0, on_cycle0, gate bool [B], rank int32 [B] -> aborted bool
// [B] (and stats int32 [4], or null), in one launch of the cluster
// dt_maat_peel_layout chooses.  bits ([2, B, W], bits_len int32 words, a
// shorter one refused before any launch) holds P's rows and columns as
// K11a packs them over live0: its first call's scratch.  The rows of
// txns outside live0 and their bits in other rows are zero there, which
// changes nothing: the peel reads only the rows of live0's txns and ANDs
// them with sets inside live0 (the frontiers start at live0 & ~aborted,
// the candidates lie in on_cycle0, itself inside live0).  A cluster
// launch the card refuses returns its error.
DT_EXPORT int dt_maat_peel(const uint8_t* live0, const uint8_t* on_cycle0,
                           const int32_t* rank, const uint8_t* gate, int B,
                           int rounds, int peel_rounds, int max_ctas,
                           const uint32_t* bits, long long bits_len,
                           uint8_t* aborted, int32_t* stats, void* stream) {
  PeelLayout l;
  if (rounds < 0 || peel_rounds < 0 || !peel_layout(B, max_ctas, l) ||
      bits_len < 2LL * B * l.W)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = dt_stream(stream);
  return l.in_smem ? launch_peel<true>(bits, live0, on_cycle0, rank, gate, B,
                                       rounds, peel_rounds, l, aborted, stats,
                                       s)
                   : launch_peel<false>(bits, live0, on_cycle0, rank, gate, B,
                                        rounds, peel_rounds, l, aborted,
                                        stats, s);
}
