// K10 dt_last_writer: per target slot, the masked lane with the highest
// (order, lane) wins.
//
// Replaces deneva_tpu/ops/scatter.py:33 last_writer.  The reference takes a
// three-key sort tournament plus an unsort below capacity and a
// scatter-max arena over capacity + 1 slots at or above it; both compute
// win[i] = mask[i] && (order[i], i) == max{(order[j], j) : mask[j],
// slot[j] == slot[i]}.  This kernel computes that function in O(N) with
// no arena and no sort: per slot, the 64-bit max of the word
// ((order - INT32_MIN) << 32 | lane) over the slot's masked lanes, whose
// low half names the winner.  Unmasked lanes never insert, so they never
// win; orders span the whole int32 range.
//   Two size regimes, chosen by N in last_writer_layout (neither is a
// fallback of the other):
//  * Shared tables (N <= kSmemMaxLanes, which every path's N is): one
//    launch of C independent CTAs x 1024 threads.  The top log2 C bits
//    of a slot's hash h (s x 2654435761, a bijection of the 32 bits) name
//    its owner CTA.  Each CTA clears an open-addressing table of T
//    entries in its own shared memory (a slot key and a 64-bit word
//    each, linear probing) and passes once over every lane (an L2 read
//    after the first CTA; 20 lanes a thread a step, as int4s of slots and
//    32-bit words of mask flags, each CTA starting at its own place): it
//    clears the flags of the unmasked lanes of its class
//    (lane / 4 mod C; four at a store where a group is all unmasked),
//    finds the masked lanes it owns without branching (a warp would
//    otherwise take each lane's branch in turn), and for those alone,
//    one at a time, clears the flag and inserts (the order read from L1;
//    a shared atomicCAS claims the key, a read and a 64-bit shared
//    atomicCAS raise the word, as shared memory has no native 64-bit
//    max).  After one block barrier it walks its table: each claimed
//    entry's word names a winner, whose flag it sets.  A flag's clear
//    and set come from one CTA, ordered by that barrier.  No global
//    scratch, no memset, nothing shared between CTAs.  C and T come from
//    N: C >= 2N / 1024 (up to 128), so a CTA's share of the lanes fills
//    at most half of its T entries (12 KB at T = 1024): more CTAs share
//    the inserts and clear smaller tables, while each reads every lane
//    either way (the card's times by C are in PERF.md).  Claims are
//    counted a warp at a time (one shared add a warp a step).  A CTA
//    whose slots pass T / 2 — only an input built against the hash —
//    sets its round aside and splits its slots into Q = 2, 4, ...
//    sub-rounds by the next bits of h, each a table of its own; h being
//    a bijection, a sub-round ends up with at most one slot, so every
//    input stays exact.  Misaligned inputs take the same walk a lane at
//    a time.
//  * Global table (larger N): the table of T >= 2N entries in global
//    memory (the caller's scratch), cleared by one memset (keys stored as
//    slot + 1, so zero is empty), an insert launch (global atomicCAS,
//    64-bit atomicMax) and a mark launch.  Every CTA of the shared
//    regime reads all N lanes, so its time grows with N faster than the
//    global table's; on the card the two cross near 44,000 lanes (30,720:
//    0.0078 against 0.0089 ms; 65,536: 0.0131 against 0.0114), so the
//    shared regime stops at 32,768, past every path's N.
//   Bound: bytes — the lanes' slot, order and mask read once and the win
//   flags written once.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int32_t kEmpty = -1;    // slots are >= 0
constexpr int kLwThreads = 1024;
constexpr int kLwMaxCtas = 128;
constexpr int kLwMinLogT = 7;
constexpr int kLwMaxLogT = 13;    // 8192 entries, 96 KB a CTA
constexpr int kLwAimLogT = 10;    // the library's CTAs: 1024 entries each
constexpr int kSmemMaxLanes = 32768;
constexpr unsigned kWarpAll = 0xffffffffu;

// A slot's hash, a bijection of its 32 bits (Fibonacci hashing): the
// top bits name its owner CTA, the next ones its sub-round.
__device__ __forceinline__ uint32_t slot_hash(int32_t s) {
  return static_cast<uint32_t>(s) * 2654435761u;
}

// The table entry a probe for hash h starts at: the top logt bits of a
// second multiply (h's own top bits are the same for a table's slots).
__device__ __forceinline__ uint32_t probe_start(uint32_t h, int logt) {
  return (h * 0x85EBCA77u) >> (32 - logt);
}

__device__ __forceinline__ unsigned long long lane_word(int32_t order,
                                                        int lane) {
  const uint32_t o = static_cast<uint32_t>(order) ^ 0x80000000u;
  return (static_cast<unsigned long long>(o) << 32) |
         static_cast<uint32_t>(lane);
}

// Raise *p to at least w: a read, then a 64-bit CAS only while it is
// lower (shared memory has no native 64-bit max).
__device__ __forceinline__ void smem_max64(unsigned long long* p,
                                           unsigned long long w) {
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(p);
  while (old < w) {
    const unsigned long long prev = atomicCAS(p, old, w);
    if (prev == old) break;
    old = prev;
  }
}

// Claim or find slot s's entry and raise its word: 2 where it claimed a
// new entry, 1 where it found the slot's, 0 where the table was full.
__device__ __forceinline__ int smem_insert(int32_t* tkey,
                                           unsigned long long* tval,
                                           int logt, uint32_t h, int32_t s,
                                           unsigned long long w) {
  const uint32_t tm = (1u << logt) - 1u;
  uint32_t j = probe_start(h, logt);
  for (uint32_t p = 0; p <= tm; ++p) {
    const int32_t prev = atomicCAS(&tkey[j], kEmpty, s);
    if (prev == kEmpty || prev == s) {
      smem_max64(&tval[j], w);
      return prev == kEmpty ? 2 : 1;
    }
    j = (j + 1) & tm;
  }
  return 0;
}

// kVec: slots 16-byte, mask and win 4-byte aligned, so a thread reads 4
// adjacent lanes at a time (an int4 of slots, a 32-bit word of flags) and
// clears a group of 4 unmasked flags with one store.  A lane's class,
// whose CTA clears it when unmasked, is its group's index (lane / 4) mod
// C in both forms.
template <bool kVec>
__global__ void __launch_bounds__(kLwThreads)
    last_writer_kernel(const int32_t* __restrict__ slots,
                       const int32_t* __restrict__ order,
                       const uint8_t* __restrict__ mask, int n, int logc,
                       int logt, uint8_t* __restrict__ win) {
  extern __shared__ unsigned long long lw_smem[];
  __shared__ int fill, over;
  const int t_entries = 1 << logt;
  unsigned long long* tval = lw_smem;
  int32_t* tkey = reinterpret_cast<int32_t*>(lw_smem + t_entries);
  const uint32_t me = blockIdx.x, cm = (1u << logc) - 1u;
  const int limit = t_entries / 2;
  // the units a step walks (4-lane groups, or lanes; kStep a thread),
  // from a place of this CTA's own, so the CTAs do not read the same
  // lines at once
  constexpr int kWidth = kVec ? 4 : 1;
  constexpr int kStep = kVec ? 5 : 8;
  const int units = n / kWidth;
  const int shift =
      static_cast<int>((static_cast<long long>(units) * me) >> logc);
  for (int logq = 0; logq <= 32 - logc; ++logq) {
    const uint32_t qm = static_cast<uint32_t>((1ull << logq) - 1ull);
    // a slot is this CTA's in sub-round q iff the top logc + logq bits of
    // its hash are (me, q): (h & top) == want
    const int bits = logc + logq;
    const uint32_t top = static_cast<uint32_t>(~0ull << (32 - bits));
    bool again = false;
    for (unsigned long long q64 = 0; q64 <= qm; ++q64) {
      const uint32_t q = static_cast<uint32_t>(q64);
      const uint32_t want = static_cast<uint32_t>(
          (static_cast<unsigned long long>(me) << logq | q) << (32 - bits));
      for (int j = threadIdx.x; j < t_entries; j += kLwThreads) {
        tkey[j] = kEmpty;
        tval[j] = 0ull;
      }
      if (threadIdx.x == 0) {
        fill = 0;
        over = 0;
      }
      __syncthreads();
      // one pass over the lanes: clear the flags of this sub-round's
      // owned masked lanes (and, in the first sub-round, of the unmasked
      // lanes of this CTA's class), then insert the owned lanes
      bool spill = false;
      // slot s: this CTA's in this sub-round
      auto owned = [&](int32_t s) { return (slot_hash(s) & top) == want; };
      // the unit of step `base`'s k-th load of this thread
      auto unit = [&](int base, int k) {
        const int raw = base + k * kLwThreads + threadIdx.x;
        return raw >= units ? -1
               : raw + shift < units ? raw + shift
                                     : raw + shift - units;
      };
      for (int base = 0; base == 0 || base < units;
           base += kStep * kLwThreads) {
        int u[kStep];
        int32_t sv[kStep][kWidth];
        uint32_t mv[kStep];
#pragma unroll
        for (int k = 0; k < kStep; ++k) {
          u[k] = unit(base, k);
          if (u[k] < 0) continue;
          // an owned lane's order is read in the insert loop below: have
          // its line in L1 by then
          asm volatile("prefetch.global.L1 [%0];" ::"l"(order + kWidth * u[k]));
          if constexpr (kVec) {
            const int4 v = reinterpret_cast<const int4*>(slots)[u[k]];
            sv[k][0] = v.x;
            sv[k][1] = v.y;
            sv[k][2] = v.z;
            sv[k][3] = v.w;
            mv[k] = reinterpret_cast<const uint32_t*>(mask)[u[k]];
          } else {
            sv[k][0] = slots[u[k]];
            mv[k] = mask[u[k]];
          }
        }
        // the unmasked flags of this CTA's class, then which lanes it
        // owns: a bit kWidth * k + e each, found without branching (a
        // warp's lanes would otherwise take every branch in turn), the
        // group's flags as 4 bits by one multiply
        unsigned own = 0u;
#pragma unroll
        for (int k = 0; k < kStep; ++k) {
          if (u[k] < 0) continue;
          const int lane0 = kWidth * u[k];
          if (q == 0 && (static_cast<uint32_t>(lane0 >> 2) & cm) == me) {
            if (kVec && mv[k] == 0u) {
              reinterpret_cast<uint32_t*>(win)[u[k]] = 0u;
            } else {
#pragma unroll
              for (int e = 0; e < kWidth; ++e)
                if ((mv[k] >> (8 * e) & 0xFFu) == 0u) win[lane0 + e] = 0;
            }
          }
          unsigned hit = 0u;
#pragma unroll
          for (int e = 0; e < kWidth; ++e)
            hit |= static_cast<unsigned>(owned(sv[k][e])) << e;
          const unsigned flags =
              kVec ? ((mv[k] & 0x01010101u) * 0x01020408u) >> 24 : mv[k];
          own |= (hit & flags) << (kWidth * k);
        }
        // the lanes past the last whole group (bit 31), in the first step
        const int tail = kWidth * units + threadIdx.x;
        if (kVec && base == 0 && tail < n) {
          if (!mask[tail]) {
            if (q == 0 && (static_cast<uint32_t>(tail >> 2) & cm) == me)
              win[tail] = 0;
          } else if (owned(slots[tail])) {
            own |= 1u << 31;
          }
        }
        // the owned lanes, one at a time (a lane's slot and order read
        // again, from L1): few a thread, so the insert is not unrolled
        int claims = 0;
        while (own != 0u && !*reinterpret_cast<volatile int*>(&over)) {
          const int b = __ffs(own) - 1;
          own &= own - 1u;
          const int i = b == 31 ? tail
                                : kWidth * unit(base, b / kWidth) + b % kWidth;
          const int32_t s = slots[i];
          win[i] = 0;
          const int got = smem_insert(tkey, tval, logt, slot_hash(s), s,
                                      lane_word(order[i], i));
          spill |= got == 0;
          claims += got == 2;
        }
        // the step's claims, a shared add a warp: past half the table the
        // sub-round spills
        claims = __reduce_add_sync(kWarpAll, claims);
        if ((threadIdx.x & 31) == 0 && claims > 0 &&
            atomicAdd(&fill, claims) + claims > limit) {
          spill = true;
          over = 1;
        }
      }
      if (__syncthreads_or(spill)) {
        again = true;
        break;
      }
      // each claimed entry's word names its winner
      for (int j = threadIdx.x; j < t_entries; j += kLwThreads)
        if (tkey[j] != kEmpty) win[static_cast<uint32_t>(tval[j])] = 1;
      __syncthreads();
    }
    if (!again) break;
  }
}

__device__ __forceinline__ uint32_t global_hash(int32_t s, uint32_t mask) {
  uint32_t h = static_cast<uint32_t>(s) * 2654435761u;
  return (h ^ (h >> 16)) & mask;
}

// The global table's keys are slot + 1 (never 0, as slots are >= 0), so
// one zero memset clears keys and words alike.
__global__ void last_writer_insert_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ order,
    const uint8_t* __restrict__ mask, int n, int32_t* __restrict__ tkeys,
    unsigned long long* __restrict__ tvals, uint32_t tmask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  const int32_t key = slots[i] + 1;
  uint32_t h = global_hash(key, tmask);
  while (true) {
    const int32_t prev = atomicCAS(&tkeys[h], 0, key);
    if (prev == 0 || prev == key) {
      atomicMax(&tvals[h], lane_word(order[i], i));
      return;
    }
    h = (h + 1) & tmask;
  }
}

__global__ void last_writer_mark_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ order,
    const uint8_t* __restrict__ mask, int n,
    const int32_t* __restrict__ tkeys,
    const unsigned long long* __restrict__ tvals, uint32_t tmask,
    uint8_t* __restrict__ win) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool w = false;
  if (mask[i]) {
    const int32_t key = slots[i] + 1;
    uint32_t h = global_hash(key, tmask);
    while (tkeys[h] != key) h = (h + 1) & tmask;
    w = tvals[h] == lane_word(order[i], i);
  }
  win[i] = w;
}

// The dynamic shared memory a last_writer_kernel block may take on the
// current device, asked once per device (and the launch limit raised to
// it); 0 where a query fails.
size_t smem_room() {
  static size_t cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  const size_t room = std::min(dt_smem_room(last_writer_kernel<true>),
                               dt_smem_room(last_writer_kernel<false>));
  if (room == 0 ||
      cudaFuncSetAttribute(last_writer_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(room)) != cudaSuccess ||
      cudaFuncSetAttribute(last_writer_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(room)) != cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = room;
  return room;
}

// K10's launch for n lanes: the shared regime's CTAs (log2) and table
// entries a CTA (log2), or the global table's entries (> 0).  ctas > 0
// asks for that many CTAs (a power of two up to kLwMaxCtas), -1 for the
// global table, 0 for the library's choice by n.
bool layout(int n, int ctas, int* logc, int* logt, long long* global) {
  *logc = *logt = 0;
  *global = 0;
  if (n < 0 || ctas < -1 || ctas > kLwMaxCtas ||
      (ctas > 0 && (ctas & (ctas - 1)) != 0))
    return false;
  if (ctas == -1 || (ctas == 0 && n > kSmemMaxLanes)) {
    long long size = 32;
    while (size < 2LL * n) size *= 2;
    *global = size;
    return true;
  }
  const size_t room = smem_room();
  int top = kLwMinLogT;
  while (top < kLwMaxLogT && (12ull << (top + 1)) <= room) ++top;
  if ((12ull << top) > room) return false;
  // the library's C: tables of 2^kLwAimLogT entries at half load, as
  // more CTAs share the inserts and the tables clear faster while each
  // reads every lane either way (measured on the card, PERF.md)
  int c = 1;
  if (ctas > 0) {
    c = ctas;
  } else {
    const int aim = top < kLwAimLogT ? top : kLwAimLogT;
    while (c < kLwMaxCtas && static_cast<long long>(c) << aim < 2LL * n)
      c *= 2;
  }
  while ((1 << *logc) < c) ++*logc;
  // at most half of T for the CTA's expected share of distinct slots
  const long long share = 2LL * ((n + c - 1) / c);
  int t = kLwMinLogT;
  while (t < top && (1LL << t) < share) ++t;
  *logt = t;
  return true;
}

}  // namespace

// K10's layout for n lanes (see layout): out = (CTAs, table entries a
// CTA, 0) in the shared regime, (0, 0, global table entries) in the
// global one.  Launches nothing.
DT_EXPORT int dt_last_writer_layout(int n, int ctas, long long* out) {
  int logc, logt;
  long long global;
  if (!layout(n, ctas, &logc, &logt, &global))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = global ? 0 : 1LL << logc;
  out[1] = global ? 0 : 1LL << logt;
  out[2] = global;
  return 0;
}

// win[n] (bool) from slots / order / mask.  scratch (t_len int64 words)
// is read only in the global regime, which needs t_len >= 1.5 x the
// layout's entries: the words, then the keys.
DT_EXPORT int dt_last_writer(const int32_t* slots, const int32_t* order,
                             const uint8_t* mask, int n, int ctas,
                             unsigned long long* scratch, long long t_len,
                             uint8_t* win, void* stream) {
  const cudaStream_t s = dt_stream(stream);
  int logc, logt;
  long long global;
  if (!layout(n, ctas, &logc, &logt, &global))
    return static_cast<int>(cudaErrorInvalidValue);
  if (global == 0) {
    const bool vec = reinterpret_cast<uintptr_t>(slots) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(win) % 4 == 0;
    if (vec)
      last_writer_kernel<true><<<1 << logc, kLwThreads, 12ull << logt, s>>>(
          slots, order, mask, n, logc, logt, win);
    else
      last_writer_kernel<false><<<1 << logc, kLwThreads, 12ull << logt, s>>>(
          slots, order, mask, n, logc, logt, win);
    return dt_status();
  }
  if (t_len < global + global / 2 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaMemsetAsync(scratch, 0, static_cast<size_t>(global) * 12, s);
  auto* tkeys = reinterpret_cast<int32_t*>(scratch + global);
  const uint32_t tmask = static_cast<uint32_t>(global - 1);
  last_writer_insert_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(
      slots, order, mask, n, tkeys, scratch, tmask);
  last_writer_mark_kernel<<<dt_blocks(n, 256), 256, 0, s>>>(
      slots, order, mask, n, tkeys, scratch, tmask, win);
  return dt_status();
}
