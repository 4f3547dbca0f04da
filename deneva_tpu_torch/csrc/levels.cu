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
// K9a's design: the matrix is packed to bit rows of the predecessor
// relation — uw's columns by a tiled transpose, then its rows OR-ed in
// under the earlier and active tests (a warp per 8 words of a row),
// which also marks the rows with an edge — then one block of 1024
// threads runs the rounds over the shrinking frontier (bits.cuh
// level_sweep): teams of 8 threads scan one member's row against the
// frontier and stop at the first hit.  Its first round, from every txn,
// is the set of marked rows, so its sweep starts there.  The bits are
// read from L2, or from shared memory where they fit.
//   Bound: bytes — the B x B bool matrix is read once (4 MB at B = 2048;
//   K9a reads it twice, once per orientation); the rounds then touch only
//   bits that stay on chip.
//
// K9b's design: one launch of a thread-block cluster of C CTAs
// (cluster.cuh).  CTA c owns the txns of its words [c own, (c + 1) own)
// of the B-bit sets and packs their predecessor rows itself from P's
// column strip: row j's bit i = P[i, j] & active[i].  A warp reads four
// rows' 128-byte segments an instruction, stages their bits, and a
// shuffle transpose turns each 32 x 32 block into 32 column words.  The
// split (PERF.md [K9b-split]) timed 16 CTAs reading their strips below
// pack_cols at B = 2048 (0.0064 ms against 0.0091) and at 8192 (0.0764
// against 0.0959), so the pack stays inside the launch at every B (at
// 8192 its instructions leave it 7% behind pack_cols and the cluster,
// two stream operations; PERF.md).  The
// rows go to shared memory where they fit (staged: B = 2048 at 16 CTAs,
// 128 rows of 65 words a CTA), else to a [W, B] scratch in L2, each
// CTA's own columns (L2: B = 8192).  While packing a CTA marks F_1
// (active j with an active predecessor) and a witness a txn (its lowest
// such predecessor), so the rounds start at F_1, as K9a's do.
// Rounds: every CTA holds F_r replicated; it tests only its own members
// — one whose witness is still in F_r stays without a look at its row,
// the others are listed and a team of 8 threads scans each row for a
// member of F_r (a new witness) — writes its words of F_{r+1} and their
// count, and sends both to every other CTA by st.async onto the
// receiver's mbarrier, the buffers paired by round parity (cluster.cuh).
// Every CTA sums the same counts, so all take the same exits: |F| = 0,
// |F| unchanged (F only shrinks, so that is a fixpoint, and the rounds
// left are credited at once), or `rounds` reached.  Each CTA writes lv
// and unstable for its own txns.
//   Bound: bytes — the B x B bool matrix read once (4 MB at B = 2048),
//   the flags in, the levels and flags out.  What holds it: the pack's
//   instructions (bits, transposes: 10 of 20 µs, PERF.md [K9b-phases])
//   and one exchange a round.
#include "bits.cuh"
#include "cluster.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

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

// F, Fn, list and lv.
inline size_t sets_bytes(int B, int W) {
  return (2 * static_cast<size_t>(W) + 2 * static_cast<size_t>(B)) * 4;
}

// ---- K9b ------------------------------------------------------------------

constexpr int kLvWarps = kThreads / 32;
constexpr int kLvMaxCtas = 16;     // the non-portable cluster size
constexpr int kLvOwnCap = 4;       // owned words a CTA, staged regime
constexpr int kLvGroup = 4;        // column words a pack task (128 bytes)
constexpr int kLvChunks = 2 * kLvGroup;   // 16-byte loads a lane a task
constexpr int kNoWit = 0x7FFFFFFF;

// The staged rows' stride: W words, one more where W is even, so that a
// warp's 32 column words of one row block fall in 32 banks.
__host__ __device__ __forceinline__ int lv_stride(int W) { return W | 1; }

// Shared words of a K9b CTA: in the staged regime its owned txns' rows
// (32 own rows of lv_stride(W) words); then the active set A and the two
// frontier buffers X[2] (W rounded up to 4 words each), the exchanged
// counts [2][kLvMaxCtas], the owned txns' levels, witnesses and the list
// of members to scan (32 own ints each), the list's length and a sum,
// two 8-byte mbarriers, and each warp's pack stage (32 rows of kLvChunks
// half-words).
__host__ __device__ __forceinline__ size_t lv_smem_words(int W, int own,
                                                         int staged) {
  const size_t w4 = (static_cast<size_t>(W) + 3) & ~static_cast<size_t>(3);
  const size_t rows =
      staged ? 32 * static_cast<size_t>(own) * lv_stride(W) : 0;
  return ((rows + 3) & ~static_cast<size_t>(3)) + 3 * w4 + 2 * kLvMaxCtas +
         3 * 32 * static_cast<size_t>(own) + 4 + 4 +
         kLvWarps * 32 * kLvChunks / 2;
}

// Count this CTA's words [w0, w0 + nown) of X into cnt[cr], send them
// and the count to every other CTA (st.async, counted on their mbarrier
// bar), wait for theirs; returns |X| in every thread.  The own words are
// complete on entry (a block barrier).
__device__ int exchange_count(uint32_t* X, uint32_t* cnt, uint64_t* bar,
                              uint32_t phase, int C, int cr, int own,
                              int W) {
  const int w0 = min(cr * own, W), nown = min(own, W - w0);
  if (threadIdx.x < 32) {
    int c = 0;
    for (int k = threadIdx.x; k < nown; k += 32) c += __popc(X[w0 + k]);
    c = __reduce_add_sync(0xffffffffu, c);
    if (threadIdx.x == 0) cnt[cr] = c;
    if (C > 1 && threadIdx.x < C && threadIdx.x != cr)
      st_remote(remote(cnt + cr, threadIdx.x), static_cast<uint32_t>(c),
                remote(bar, threadIdx.x));
  }
  if (C > 1) {
    uint32_t rx = 0u;
    for (int q = 0; q < C; ++q)
      if (q != cr) rx += 4u * (min(own, W - min(q * own, W)) + 1);
    if (threadIdx.x == 0) mbar_expect(bar, rx);
    for (int e = threadIdx.x; e < nown * C; e += blockDim.x) {
      const int q = e / nown, k = e % nown;
      if (q != cr) st_remote(remote(X + w0 + k, q), X[w0 + k], remote(bar, q));
    }
    mbar_wait(bar, phase);
  } else {
    __syncthreads();
  }
  int total = 0;
  for (int q = 0; q < C; ++q) total += static_cast<int>(cnt[q]);
  return total;
}

// K9b: one thread-block cluster of C CTAs (C = 1 included); CTA cr owns
// the words [cr own, (cr + 1) own) of the B-bit sets.  It packs its
// txns' rows from P's column strip, into shared memory (kStaged) or into
// rows_g ([W][B], its own columns), marks F_1 and a witness a txn, and
// runs the rounds from F_1.  Exchange r writes X[r & 1] (F_{r + 1}), on
// mbarrier r & 1 in phase (r >> 1) & 1; F_r is read from X[(r + 1) & 1]
// in round r, and every CTA sends exchange r + 1 only after all of
// exchange r arrived, so no store meets a read (cluster.cuh).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
precedence_kernel(const uint8_t* __restrict__ prec,
                  uint32_t* __restrict__ rows_g,
                  const uint8_t* __restrict__ active, int B, int W, int own,
                  int rounds, int32_t* __restrict__ lv_o,
                  uint8_t* __restrict__ unstable_o,
                  long long* __restrict__ stamps) {
  extern __shared__ __align__(128) uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int cr = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stamping = stamps != nullptr && cr == 0 && tid == 0;
  if (stamping) {
    stamps[0] = dt_globaltimer();
    stamps[2] = clock64();
  }
  const int w0 = min(cr * own, W), nown = min(own, W - w0);
  const int row0 = 32 * w0, nt = 32 * nown;
  const int end = min(B, row0 + nt);
  if (rounds == 0) {                      // no round: unstable = active
    for (int j = row0 + tid; j < end; j += blockDim.x) {
      lv_o[j] = 0;
      unstable_o[j] = active[j];
    }
    return;
  }
  const int Wp = lv_stride(W);
  const int w4 = (W + 3) & ~3;
  const size_t rows_n = kStaged ? 32 * static_cast<size_t>(own) * Wp : 0;
  uint32_t* rows_s = sm;
  uint32_t* A = sm + ((rows_n + 3) & ~static_cast<size_t>(3));
  uint32_t* X0 = A + w4;                  // X[par] = X0 + par w4
  uint32_t* cnt = X0 + 2 * w4;            // [2][kLvMaxCtas]
  int* lv = reinterpret_cast<int*>(cnt + 2 * kLvMaxCtas);
  int* wit = lv + 32 * own;
  int* list = wit + 32 * own;
  int* nlist = list + 32 * own;           // [0] the list's length, [1] a sum
  uint64_t* bar = reinterpret_cast<uint64_t*>(nlist + 4);
  mbar_init(bar, 2);
  for (int w = tid; w < 3 * w4; w += blockDim.x) A[w] = 0u;
  for (int t = tid; t < 32 * own; t += blockDim.x) {
    lv[t] = 0;
    wit[t] = kNoWit;
  }
  if (tid < 2) nlist[tid] = 0;
  __syncthreads();
  load_set(active, B, W, A);
  {
    int c = 0;
    for (int w = tid; w < W; w += blockDim.x) c += __popc(A[w]);
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0 && c) atomicAdd(&nlist[1], c);
  }
  __syncthreads();
  const int n0 = nlist[1];                // |F_0|
  if (stamping) stamps[3] = clock64();
  // the pack: warp tasks (w, g), row block w (32 rows) against a group g
  // of up to kLvGroup owned column words.  Lane l loads 16-byte chunks
  // l + 32 m (row 32 w + (l + 32 m) / 8, columns 16 ((l + 32 m) % 8) on
  // from the group's first): four rows of 128 bytes an instruction.
  // Their bits go to the warp's stage as one half-word a chunk; then
  // lane i takes row 32 w + i's word of each column word and the
  // transpose gives lane c column c's bits over the 32 rows, inactive
  // rows off.  Staged rows go to shared memory; L2 rows to rows_g
  // transposed ([W][B]: the lanes' 32 columns are one store).
  {
    const bool vec =
        B % 16 == 0 && reinterpret_cast<uintptr_t>(prec) % 16 == 0;
    uint16_t* stage = reinterpret_cast<uint16_t*>(bar + 2) +
                      warp * 32 * 2 * kLvGroup;
    const int groups = (nown + kLvGroup - 1) / kLvGroup;
    for (int k = warp; k < W * groups; k += kLvWarps) {
      const int w = k % W, g = k / W;
      const int q0 = g * kLvGroup, nq = min(kLvGroup, nown - q0);
      const int j0 = 32 * (w0 + q0);
      uint4 v[kLvChunks];
#pragma unroll
      for (int m = 0; m < kLvChunks; ++m) {
        const int e = lane + 32 * m, i = 32 * w + e / (2 * kLvGroup);
        const int c = e % (2 * kLvGroup), j = j0 + 16 * c;
        v[m] = make_uint4(0u, 0u, 0u, 0u);
        if (i < B && c < 2 * nq && j < B) {
          const uint8_t* at = prec + static_cast<size_t>(i) * B + j;
          if (vec) {
            v[m] = *reinterpret_cast<const uint4*>(at);
          } else {
            uint32_t b[4] = {0u, 0u, 0u, 0u};
            for (int x = 0; x < 16 && j + x < B; ++x)
              b[x >> 2] |= (at[x] != 0 ? 1u : 0u) << (8 * (x & 3));
            v[m] = make_uint4(b[0], b[1], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kLvChunks; ++m)
        stage[lane + 32 * m] = static_cast<uint16_t>(chunk_bits(v[m]));
      __syncwarp();
      for (int qq = 0; qq < nq; ++qq) {
        const int q = q0 + qq, jl = 32 * q + lane, j = row0 + jl;
        const uint32_t x =
            reinterpret_cast<const uint32_t*>(stage)[lane * kLvGroup + qq];
        const uint32_t y = transpose32(x) & A[w];
        if (kStaged)
          rows_s[static_cast<size_t>(jl) * Wp + w] = y;
        else if (j < B)
          rows_g[static_cast<size_t>(w) * B + j] = y;
        if (y) atomicMin(&wit[jl], 32 * w + __ffs(y) - 1);
        const unsigned has = __ballot_sync(0xffffffffu, y != 0u);
        if (lane == 0 && has) atomicOr(&X0[w0 + q], has & A[w0 + q]);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (stamping) stamps[4] = clock64();
  if (C > 1) cluster_start();
  // F_1: the active txns with an active predecessor, and their witnesses
  int n_prev = n0, r = 1;                 // |F_{r-1}|
  int n = exchange_count(X0, cnt, bar, 0, C, cr, own, W);
  if (stamping) stamps[5] = clock64();
  const uint32_t* cur = X0;               // F_r
  for (int t = tid; t < nt; t += blockDim.x) lv[t] = bit(cur, row0 + t);
  // the row of owned txn t: word c at row[c * step]
  const size_t step = kStaged ? 1 : static_cast<size_t>(B);
  auto row_of = [&](int t) -> const uint32_t* {
    return kStaged ? rows_s + static_cast<size_t>(t) * Wp
                   : rows_g + row0 + t;
  };
  const int team = tid / kTeam, tl = tid % kTeam, teams = blockDim.x / kTeam;
  const unsigned tmask = 0xFFu << (lane & ~(kTeam - 1));
  while (r < rounds && n > 0) {
    if (n == n_prev) {                    // a fixpoint: F stays F_r
      for (int t = tid; t < nt; t += blockDim.x)
        lv[t] += (rounds - r) * bit(cur, row0 + t);
      break;
    }
    uint32_t* nxt = X0 + (r & 1) * w4;
    // an owned member stays where its witness is still in F_r (its words
    // by ballot), else it is listed
    for (int t = tid; t < nt; t += blockDim.x) {
      const int j = row0 + t;
      const bool in = j < B && bit(cur, j);
      const int wv = wit[t];
      const bool keep = in && wv != kNoWit && bit(cur, wv);
      const unsigned kb = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) nxt[w0 + (t >> 5)] = kb;
      push(in && !keep, t, list, nlist);
    }
    __syncthreads();
    // a team scans a listed row for a member of F_r, its new witness
    const int nl = *nlist;
    for (int e = team; e < nl; e += teams) {
      const int t = list[e];
      const uint32_t* row = row_of(t);
      int f = -1;
      for (int c0 = 0; c0 < W && f < 0; c0 += kTeam * kUnroll) {
        int g = -1;
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int c = c0 + q * kTeam + tl;
          if (c < W) {
            const uint32_t m = row[c * step] & cur[c];
            if (m && g < 0) g = 32 * c + __ffs(m) - 1;
          }
        }
        f = __reduce_max_sync(tmask, g);
      }
      if (tl == 0 && f >= 0) {
        wit[t] = f;
        atomicOr(&nxt[w0 + (t >> 5)], 1u << (t & 31));
      }
    }
    __syncthreads();
    if (tid == 0) *nlist = 0;
    n_prev = n;
    n = exchange_count(nxt, cnt + (r & 1) * kLvMaxCtas, bar + (r & 1),
                       (r >> 1) & 1, C, cr, own, W);
    ++r;
    cur = nxt;
    for (int t = tid; t < nt; t += blockDim.x) lv[t] += bit(cur, row0 + t);
  }
  for (int j = row0 + tid; j < end; j += blockDim.x) {
    lv_o[j] = lv[j - row0];
    unstable_o[j] = bit(cur, j);
  }
  if (stamping) {
    stamps[6] = clock64();
    stamps[7] = r;
    stamps[1] = dt_globaltimer();
  }
}

// K9b's layout at B txns (W = ceil(B / 32) words a row) in `regime`
// (-1: the library's choice, 0: staged, 1: L2).  With `ctas` (1, 2, 4, 8
// or 16) exactly that many CTAs, staged where the rows fit (and regime
// allows); with ctas = 0 the library's choice: staged in the fewest CTAs
// that own at most kLvOwnCap words each (or kLvMaxCtas) and fit, else
// kLvMaxCtas CTAs in the L2 regime.
struct LvLayout {
  int W, ctas, own, staged;
  size_t smem;
};

bool lv_layout(int B, int ctas, int regime, LvLayout& l) {
  if (B < 1 || regime < -1 || regime > 1 ||
      (ctas != 0 && ctas != 1 && ctas != 2 && ctas != 4 && ctas != 8 &&
       ctas != 16))
    return false;
  const int W = (B + 31) / 32;
  auto fits = [&](int c, int staged) {
    const int own = (W + c - 1) / c;
    const size_t smem = lv_smem_words(W, own, staged) * 4;
    if (smem > dt_smem_room(staged ? precedence_kernel<true>
                                   : precedence_kernel<false>))
      return false;
    l = {W, c, own, staged, smem};
    return true;
  };
  if (ctas != 0)
    return (regime != 1 && fits(ctas, 1)) || (regime != 0 && fits(ctas, 0));
  if (regime != 1)
    for (int c = 1; c <= kLvMaxCtas; c *= 2)
      if (((W + c - 1) / c <= kLvOwnCap || c == kLvMaxCtas) && fits(c, 1))
        return true;
  return regime != 0 && fits(kLvMaxCtas, 0);
}

template <bool kStaged>
int launch_levels(const uint8_t* prec, uint32_t* rows,
                  const uint8_t* active, int B, int rounds,
                  const LvLayout& l, int32_t* lv, uint8_t* unstable,
                  long long* stamps, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      precedence_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err == cudaSuccess && l.ctas > 8)
    err = cudaFuncSetAttribute(precedence_kernel<kStaged>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, precedence_kernel<kStaged>, prec, rows,
                           active, B, l.W, l.own, rounds, lv, unstable,
                           stamps);
  return err != cudaSuccess ? static_cast<int>(err) : dt_status();
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


// K9b's layout at B txns in a cluster of `ctas` (0: the library's
// choice; 1, 2, 4, 8 or 16) CTAs, in `regime` (-1: the library's
// choice, 0: staged, 1: L2): out[0] the cluster's CTAs,
// out[1] 1 where the cluster packs P itself into shared memory, out[2]
// the int32 words of scratch dt_precedence_levels needs (the L2
// regime's [W, B] rows).  Launches nothing; 1 where no layout fits.
DT_EXPORT int dt_precedence_levels_layout(int B, int ctas, int regime,
                                          long long* out) {
  LvLayout l;
  if (!lv_layout(B, ctas, regime, l)) return 1;
  out[0] = l.ctas;
  out[1] = l.staged;
  out[2] = l.staged ? 0 : static_cast<long long>(B) * l.W;
  return 0;
}

// K9b: prec bool [B, B], active bool [B] -> lv int32 [B], unstable bool
// [B], in one cluster launch in the layout dt_precedence_levels_layout
// gives for (B, ctas, regime).  bits_len: the scratch's int32 words (the
// L2 regime's [W, B] rows); a shorter scratch than the layout's is
// refused before any launch, and so is a cluster launch the card
// refuses (its error).  stamps (or null) int64 [8]: CTA 0's phase stamps
// (common.cuh): clocks at entry, after the setup, the pack and the F_1
// exchange, and at exit, then the rounds exchanged.
DT_EXPORT int dt_precedence_levels(const uint8_t* prec, const uint8_t* active,
                                   int B, int rounds, int ctas,
                                   int regime, uint32_t* bits,
                                   long long bits_len, int32_t* lv,
                                   uint8_t* unstable, long long* stamps,
                                   void* stream) {
  LvLayout l;
  if (rounds < 0 || !lv_layout(B, ctas, regime, l) ||
      bits_len < (l.staged ? 0LL : static_cast<long long>(B) * l.W))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = dt_stream(stream);
  return l.staged ? launch_levels<true>(prec, nullptr, active, B, rounds, l,
                                        lv, unstable, stamps, s)
                  : launch_levels<false>(prec, bits, active, B, rounds, l,
                                         lv, unstable, stamps, s);
}
