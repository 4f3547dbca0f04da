"""Sort-based in-batch read forwarding (port of ``deneva_tpu/ops/forward.py``).

For blind-write workloads (YCSB) one sort of the epoch's accesses by
(key, rank) plus segmented scans give every read the rank of the latest
strictly-earlier in-batch writer of its key (``fwd``) and every key its
final writer (``win``).  Execution in those sorted coordinates equals
serial execution in rank order, so the whole batch commits in one pass.

Two kernels carry it on the card:

* **K1** `sort_lanes` (``csrc/forward.cu``) — replaces the ``lax.sort`` of
  ``forward_plan_flat`` (``deneva_tpu/ops/forward.py:258-264``).  Each
  lane packs into one non-negative 63-bit word
  ``key << 32 | rank << 1 | is_write`` (keys and ranks are in [0, 2^31)),
  whose ascending order refines (key, rank); a one-sweep LSD radix sort
  (``csrc/radix.cuh``) orders the words.  Lanes with equal (key, rank)
  are one txn's accesses to one key, whose order the reference leaves
  open (``is_stable=False``); the word orders them reads first.
* **K2** `plan_scans` (``csrc/forward.cu``) — replaces the Kogge-Stone
  segmented scans of ``forward_plan_flat`` (``:191`` ``_seg_scan``,
  ``:220`` ``seg_first``, ``:266-288``).  Inside a key segment ranks
  ascend, so ``fwd`` is the rank of the last write lane before the lane's
  (key, rank) group and ``win`` the last write lane of each key: one
  cooperative launch, each block scanning its run of lanes and composing
  the earlier blocks' summaries across one grid barrier.

The sharded plan of a mesh (``device_parts > 1``, `workloads.ycsb.
YCSBWorkload.execute_mc`) adds two kernels (``csrc/mc.cu``), run once
per shard on its slice of ``bD = B / D`` whole txns:

* **K18a** `mc_slice_defer` — replaces ``deneva_tpu/ops/forward.py:109``
  `mc_plan_defer` as the shard-local pass of ``deneva_tpu/workloads/
  ycsb.py:400-412``: the txns whose lanes overflow their (slice, owner =
  key % D) block of ``pair_cap`` lanes, in (ts, txn) priority.  A txn's
  lanes are contiguous and share its ts, so the reference's stable
  (owner, ts) lane sort orders lanes by (owner, ts, txn, lane), and a
  lane's position is ``prefix_o(t)`` (owner-o lanes of the txns before
  t in (ts, txn) order) plus its rank among t's own owner-o lanes.  One
  cooperative launch (`mc_defer_layout`): each txn's D owner counts from
  its lanes, read once; a stable radix sort of (ts, txn) over the bytes
  of ts that vary, tiles ranked per warp and placed by a decoupled
  look-back, grid barriers between passes; then block scans of the D
  owner-count rows in that order: t defers iff ``prefix_o(t) + c[t][o] >
  pair_cap`` for some owner.  It also returns that order.
* **K18b** `mc_pack_blocks` — replaces ``deneva_tpu/workloads/ycsb.py:
  413-441``: count rows in K18a's order and their scans, with deferred
  txns' counts zeroed, give each
  surviving lane its slot in its owner's block, where it lands as (key,
  rank, write), every block in (ts, lane) order; the slots past an
  owner's lanes hold ``(INT32_MAX, 0, False)``.  (The reference's
  clamped ``dynamic_slice`` leaves other owners' lanes there, which the
  receiver masks to the sentinel key; only received lanes whose key the
  receiver owns are defined.)

The plain versions beside them follow the reference op for op (the
Kogge-Stone scans and the stable sorts included); the CPU tests hold
them against ``deneva_tpu``, and ``chip_smoke.py`` holds the kernels
against them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deneva_tpu_torch import kernels

INT32_MAX = 2**31 - 1
_RANK_MASK = 0x7FFFFFFF

K1_SORT = kernels.Kernel("dt_sort_lanes", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.P, kernels.P,
    kernels.P, kernels.P])
K2_SCAN = kernels.Kernel("dt_plan_scans", [
    kernels.P, kernels.I32, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P, kernels.I64, kernels.P])

K18A_DEFER = kernels.Kernel("dt_mc_defer", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.I32,
    kernels.I32, kernels.P, kernels.P, kernels.P, kernels.I64, kernels.P,
    kernels.P])
K18B_PACK = kernels.Kernel("dt_mc_pack", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.I32, kernels.I32, kernels.I32, kernels.I32, kernels.P,
    kernels.P, kernels.P, kernels.P, kernels.P])

SORT_PASSES = 8         # the most 8-bit passes a sort runs (csrc/radix.cuh)
SCAN_RUNS = 8 * 1024    # K2's run summaries: 8 words, 1,024 blocks at most
MC_MAX_PARTS = 8        # the most shards K18a / K18b take (csrc/mc.cu)


def forwarding_applies(backend, workload) -> bool:
    """Eligibility: backend opts in AND every write in the workload is
    blind (value independent of the txn's reads)."""
    return bool(getattr(backend, "forward", False)
                and getattr(workload, "blind_writes", False))


@dataclass
class ForwardPlan:
    """Flat [B*A] epoch access plan in (key, rank)-sorted order.

    keys     — int32 access keys; invalid lanes hold INT32_MAX, sort last.
    rank     — int32 owning txn's serialization rank.
    is_read / is_write — bool valid read/write lanes.
    fwd      — int32 rank of the latest strictly-earlier in-batch writer
               of this key, or -1 (read the epoch-start snapshot).
    win      — bool: the final (max-rank) writer of its key.
    perm     — int64 flat index into the [B, A] layout, or None.
    """

    keys: torch.Tensor
    rank: torch.Tensor
    is_read: torch.Tensor
    is_write: torch.Tensor
    fwd: torch.Tensor
    win: torch.Tensor
    perm: torch.Tensor | None


def mc_pair_cap(b: int, a: int, d_parts: int, factor: float) -> int:
    """The sharded plan's lanes per (source slice, owner) block
    (``deneva_tpu/ops/forward.py:88``): ``factor`` times the even share
    N / D^2, rounded up to the 128-lane tile and at least one tile.  0
    (every shard plans the whole batch) when the factor is 0, at one
    shard, when slices would split txns, or when a block would hold the
    whole slice."""
    if factor <= 0 or d_parts <= 1 or b % d_parts:
        return 0
    import math
    sl = (b // d_parts) * a
    cap = (math.ceil(factor * sl / d_parts) + 127) // 128 * 128
    cap = max(cap, 128)
    return 0 if cap >= sl else cap


def _lexsort2(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """The permutation of a stable sort by (major, minor): ties keep
    index order, as ``lax.sort(..., num_keys=2, is_stable=True)``."""
    p = torch.sort(minor, stable=True).indices
    return p[torch.sort(major[p], stable=True).indices]


def mc_plan_defer_plain(keys: torch.Tensor, ts: torch.Tensor,
                        valid: torch.Tensor, d_parts: int, pair_cap: int
                        ) -> torch.Tensor:
    """The capacity rule over the whole batch, op for op from
    ``deneva_tpu/ops/forward.py:109``: bool[B], the txns with a lane past
    ``pair_cap`` in its (N/D-lane source slice, owner) block under the
    stable (slice, owner, ts) order."""
    b, a = keys.shape
    n = b * a
    sl = n // d_parts
    dev = keys.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    vf = valid.reshape(-1)
    owner = torch.where(vf, keys.reshape(-1).to(torch.int64) % d_parts,
                        d_parts)
    seg = (lane // sl) * (d_parts + 1) + owner
    tsl = ts[:, None].expand(b, a).reshape(-1)
    perm = _lexsort2(seg, tsl)
    sseg, stxn = seg[perm], (lane // a)[perm]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = sseg[1:] != sseg[:-1]
    start = torch.cummax(torch.where(head, lane, 0), 0).values
    over = (lane - start >= pair_cap) & (sseg % (d_parts + 1) != d_parts)
    sov = over[torch.sort(stxn, stable=True).indices]
    return sov.reshape(b, a).any(dim=1)


def mc_plan_defer(keys: torch.Tensor, ts: torch.Tensor, valid: torch.Tensor,
                  d_parts: int, pair_cap: int) -> torch.Tensor:
    """bool[B]: the spec of the capacity rule over the replicated batch.
    On CUDA it is K18a over each of the D slices, which must hold whole
    txns (``B % D == 0``)."""
    if kernels.on_cpu(keys, ts, valid):
        return mc_plan_defer_plain(keys, ts, valid, d_parts, pair_cap)
    b = keys.shape[0]
    if b % d_parts:
        raise ValueError("K18a takes slices of whole txns: B % D != 0")
    bd = b // d_parts
    return torch.cat([mc_slice_defer(keys[s * bd:(s + 1) * bd],
                                     valid[s * bd:(s + 1) * bd],
                                     ts[s * bd:(s + 1) * bd], d_parts,
                                     pair_cap)[0]
                      for s in range(d_parts)])


def mc_slice_defer_plain(keys: torch.Tensor, valid: torch.Tensor,
                         ts: torch.Tensor, d_parts: int, pair_cap: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K18a, op for op from ``deneva_tpu/workloads/ycsb.py:
    400-412``: (bool[bD] defers, int32[bD] the txns in (ts, txn)
    order)."""
    bd, a = keys.shape
    sl = bd * a
    dev = keys.device
    vs = valid.reshape(-1)
    ks = torch.where(valid, keys, INT32_MAX).reshape(-1)
    tss = ts[:, None].expand(bd, a).reshape(-1)
    lane = torch.arange(sl, dtype=torch.int64, device=dev)
    owner = torch.where(vs, ks.to(torch.int64) % d_parts, d_parts)
    perm = _lexsort2(owner, tss)
    so, stx = owner[perm], (lane // a)[perm]
    head = torch.ones(sl, dtype=torch.bool, device=dev)
    head[1:] = so[1:] != so[:-1]
    start = torch.cummax(torch.where(head, lane, 0), 0).values
    over = (lane - start >= pair_cap) & (so != d_parts)
    sov = over[torch.sort(stx, stable=True).indices]
    order = torch.sort(ts, stable=True).indices.to(torch.int32)
    return sov.reshape(bd, a).any(dim=1), order


def _mc_check(d_parts: int, pair_cap: int, a: int) -> None:
    if not 1 < d_parts <= MC_MAX_PARTS:
        raise ValueError(f"K18 takes 2 to {MC_MAX_PARTS} shards, got "
                         f"{d_parts}")
    if pair_cap < a:
        raise ValueError(f"pair_cap {pair_cap} below one txn's {a} lanes")


def mc_slice_defer(keys: torch.Tensor, valid: torch.Tensor,
                   ts: torch.Tensor, d_parts: int, pair_cap: int,
                   stamps: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K18a: keys int32[bD, A], valid bool[bD, A], ts int32[bD] ->
    (bool[bD] the txns that defer, int32[bD] the txns in (ts, txn)
    order, which K18b takes), in one cooperative launch.  ``stamps``
    (CUDA, int64[13], or None) receives block 0's phase clocks
    (``csrc/mc.cu``)."""
    if kernels.on_cpu(keys, valid, ts):
        return mc_slice_defer_plain(keys, valid, ts, d_parts, pair_cap)
    bd, a = keys.shape
    dev = keys.device
    _mc_check(d_parts, pair_cap, a)
    kernels.check("keys", keys, torch.int32, (bd, a), dev)
    kernels.check("valid", valid, torch.bool, (bd, a), dev)
    kernels.check("ts", ts, torch.int32, (bd,), dev)
    dfr = torch.empty(bd, dtype=torch.bool, device=dev)
    order = torch.empty(bd, dtype=torch.int32, device=dev)
    if bd == 0:
        return dfr, order
    words = mc_defer_layout(bd, a, d_parts)[2]
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    K18A_DEFER.launch(kernels.ptr(keys), kernels.ptr(valid), kernels.ptr(ts),
                      bd, a, d_parts, pair_cap, kernels.ptr(dfr),
                      kernels.ptr(order), kernels.ptr(scratch), words,
                      None if stamps is None else kernels.ptr(stamps),
                      kernels.stream(keys))
    return dfr, order


def mc_defer_layout(bd: int, a: int, d_parts: int) -> tuple[int, int, int]:
    """K18a's launch at ``bd`` txns of ``a`` lanes over ``d_parts``
    shards as the kernel library lays it out (CUDA only): (blocks of its
    cooperative grid, tiles of 1,024 txns, int32 words of scratch).
    Raises for a size it does not take (``a`` above 255, ``bd * a`` at or
    above 2^30)."""
    return kernels.layout("dt_mc_defer_layout", bd, a, d_parts)


def mc_pack_blocks_plain(keys, valid, ts, rank, w, dfr, d_parts: int,
                         pair_cap: int):
    """Plain K18b, op for op from ``deneva_tpu/workloads/ycsb.py:413-441``
    (the blocks cut at each owner's own lanes, the rest filled with
    ``(INT32_MAX, 0, False)``): int32[D, cap] keys, int32[D, cap] ranks,
    bool[D, cap] write flags."""
    bd, a = keys.shape
    sl = bd * a
    dev = keys.device
    dl = dfr[:, None].expand(bd, a).reshape(-1)
    vs2 = valid.reshape(-1) & ~dl
    ks2 = torch.where(vs2, keys.reshape(-1), INT32_MAX)
    ws2 = w.reshape(-1) & ~dl
    rs = rank[:, None].expand(bd, a).reshape(-1)
    tss = ts[:, None].expand(bd, a).reshape(-1)
    owner2 = torch.where(vs2, ks2.to(torch.int64) % d_parts, d_parts)
    perm = _lexsort2(owner2, tss)
    so, ck, cr, cw = owner2[perm], ks2[perm], rs[perm], ws2[perm]
    cnt = torch.bincount(owner2, minlength=d_parts + 1)
    starts = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(sl, dtype=torch.int64, device=dev) - starts[so]
    keep = (so < d_parts) & (pos < pair_cap)
    at = so[keep] * pair_cap + pos[keep]
    bk = torch.full((d_parts * pair_cap,), INT32_MAX, dtype=torch.int32,
                    device=dev)
    br = torch.zeros_like(bk)
    bw = torch.zeros(d_parts * pair_cap, dtype=torch.bool, device=dev)
    bk[at], br[at], bw[at] = ck[keep], cr[keep], cw[keep]
    return (bk.reshape(d_parts, pair_cap), br.reshape(d_parts, pair_cap),
            bw.reshape(d_parts, pair_cap))


def mc_pack_blocks(keys: torch.Tensor, valid: torch.Tensor,
                   ts: torch.Tensor, rank: torch.Tensor, w: torch.Tensor,
                   dfr: torch.Tensor, order: torch.Tensor, d_parts: int,
                   pair_cap: int):
    """K18b: the slice's surviving lanes packed into one ``[pair_cap]``
    block per owner.  ``w`` is the valid write lanes, ``dfr`` and
    ``order`` K18a's outputs for the same slice (the kernel reads
    ``order`` in place of ``ts``)."""
    if kernels.on_cpu(keys, valid, ts, rank, w, dfr):
        return mc_pack_blocks_plain(keys, valid, ts, rank, w, dfr, d_parts,
                                    pair_cap)
    bd, a = keys.shape
    dev = keys.device
    _mc_check(d_parts, pair_cap, a)
    for name, t, dt, shape in (("keys", keys, torch.int32, (bd, a)),
                               ("valid", valid, torch.bool, (bd, a)),
                               ("rank", rank, torch.int32, (bd,)),
                               ("w", w, torch.bool, (bd, a)),
                               ("dfr", dfr, torch.bool, (bd,)),
                               ("order", order, torch.int32, (bd,))):
        kernels.check(name, t, dt, shape, dev)
    bk = torch.empty((d_parts, pair_cap), dtype=torch.int32, device=dev)
    br = torch.empty_like(bk)
    bw = torch.empty((d_parts, pair_cap), dtype=torch.bool, device=dev)
    cnt = torch.empty(d_parts * (bd + 1), dtype=torch.int32, device=dev)
    K18B_PACK.launch(kernels.ptr(keys), kernels.ptr(valid),
                     kernels.ptr(rank), kernels.ptr(w), kernels.ptr(dfr),
                     kernels.ptr(order), bd, a, d_parts, pair_cap,
                     kernels.ptr(bk), kernels.ptr(br), kernels.ptr(bw),
                     kernels.ptr(cnt), kernels.stream(keys))
    return bk, br, bw


def mc_defer_verdict(batch, dfr: torch.Tensor):
    """The forwarding verdict under a mesh (``deneva_tpu/ops/forward.py:
    159``): everything active commits in rank order but the txns the
    capacity rule deferred."""
    from deneva_tpu_torch.cc.base import Verdict

    z = torch.zeros_like(batch.active)
    dfr = dfr & batch.active
    return Verdict(commit=batch.active & ~dfr, abort=z, defer=dfr,
                   order=batch.rank, level=torch.zeros_like(batch.rank))


def commit_all_verdict(batch):
    """Commit-everything Verdict in rank order."""
    from deneva_tpu_torch.cc.base import Verdict

    z = torch.zeros_like(batch.active)
    return Verdict(commit=batch.active, abort=z, defer=z,
                   order=batch.rank, level=torch.zeros_like(batch.rank))


def forward_verdict(batch):
    """Commit-everything Verdict + sorted ForwardPlan for the single-pass
    executor."""
    plan = forward_plan(batch.keys, batch.rank, batch.is_write,
                        batch.valid & batch.active[:, None])
    return commit_all_verdict(batch), plan


# -- plain scans (op for op from the reference) -------------------------

def _seg_scan(flags: torch.Tensor, vals: torch.Tensor, combine
              ) -> torch.Tensor:
    """Inclusive segmented scan; ``flags`` marks segment heads
    (Kogge-Stone, as ``deneva_tpu/ops/forward.py:191``)."""
    n = flags.shape[0]
    f, v = flags, vals
    d = 1
    while d < n:
        fa = torch.cat([torch.ones(d, dtype=torch.bool, device=f.device),
                        f[:-d]])
        va = torch.cat([torch.zeros(d, dtype=v.dtype, device=v.device),
                        v[:-d]])
        in_range = torch.arange(n, device=f.device) >= d
        v = torch.where(f | ~in_range, v, combine(va, v))
        f = f | fa
        d *= 2
    return v


def _shift1(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def seg_first(flags: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Head-value propagation: every lane takes the value at the nearest
    preceding flagged lane (its own if flagged)."""
    return _seg_scan(flags, vals, lambda v1, v2: v1)


# -- K1: the lane sort ----------------------------------------------------

def pack_lanes(k: torch.Tensor, r: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
    """int64 words ``k << 32 | r << 1 | w`` (plain version of K1's pack)."""
    return (k.to(torch.int64) << 32) | (r.to(torch.int64) << 1) \
        | w.to(torch.int64)


def sort_lanes_plain(k, r, w):
    """Plain K1: the ascending words and the permutation that sorts them."""
    return torch.sort(pack_lanes(k, r, w))


def sort_scratch(n: int, dev) -> torch.Tensor:
    """The radix sort's scratch (``csrc/radix.cuh``): the passes' digit
    histograms, their tile counters and each tile's look-back status
    words, sized for the smallest tile the sort picks (256 words)."""
    words = SORT_PASSES * 256 + 32 + SORT_PASSES * 256 * -(-n // 256)
    return torch.empty(words, dtype=torch.int32, device=dev)


def sort_lanes(k: torch.Tensor, r: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
    """K1: lanes (k int32[N], r int32[N], w bool[N]) -> sorted int64[N]
    words.  Keys and ranks must lie in [0, 2^31)."""
    if kernels.on_cpu(k, r, w):
        return sort_lanes_plain(k, r, w).values
    n = k.shape[0]
    for name, t, dt in (("k", k, torch.int32), ("r", r, torch.int32),
                        ("w", w, torch.bool)):
        kernels.check(name, t, dt, (n,), k.device)
    out = torch.empty(n, dtype=torch.int64, device=k.device)
    tmp = torch.empty_like(out)
    counts = sort_scratch(n, k.device)
    K1_SORT.launch(kernels.ptr(k), kernels.ptr(r), kernels.ptr(w), n,
                   kernels.ptr(out), kernels.ptr(tmp), kernels.ptr(counts),
                   kernels.stream(k))
    return out


# -- K2: the plan scans ---------------------------------------------------

def unpack_lanes(words: torch.Tensor):
    """(keys int32, rank int32, is_write bool) of sorted words."""
    return ((words >> 32).to(torch.int32),
            ((words >> 1) & _RANK_MASK).to(torch.int32),
            (words & 1).to(torch.bool))


def plan_scans_plain(words: torch.Tensor, perm=None) -> ForwardPlan:
    """Plain K2: ``forward_plan_flat``'s scans over sorted lanes, op for
    op (``deneva_tpu/ops/forward.py:265-291``)."""
    sk, sr, sw = unpack_lanes(words)
    n = sk.shape[0]
    dev = sk.device
    srd = (sk != INT32_MAX) & ~sw
    cand = torch.where(sw, sr, torch.full_like(sr, -1))
    key_head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sk[1:] != sk[:-1]])
    excl = _shift1(_seg_scan(key_head, cand, torch.maximum), -1)
    excl = torch.where(key_head, torch.full_like(excl, -1), excl)
    grp_head = key_head | (sr != _shift1(sr, -1))
    head_val = torch.where(grp_head, excl, torch.full_like(excl, -1))
    fwd = seg_first(grp_head, head_val)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    key_tail = torch.cat([sk[1:] != sk[:-1],
                          torch.ones(1, dtype=torch.bool, device=dev)])
    widx = torch.where(sw, idx, torch.full_like(idx, -1))
    suffmax = _seg_scan(key_tail.flip(0), widx.flip(0),
                        torch.maximum).flip(0)
    win = sw & (suffmax == idx)
    return ForwardPlan(keys=sk, rank=sr, is_read=srd, is_write=sw, fwd=fwd,
                       win=win, perm=perm)


def plan_scans_layout(n: int) -> tuple[int, int, int]:
    """K2's launch over ``n`` lanes as the kernel library lays it out
    (CUDA only): (blocks, lanes a block owns, int32 words of scratch)."""
    return kernels.layout("dt_plan_scans_layout", n)


def plan_scans(words: torch.Tensor) -> ForwardPlan:
    """K2: sorted int64[N] words -> ForwardPlan (perm None), one
    cooperative launch; its scratch holds a summary a block."""
    if kernels.on_cpu(words):
        return plan_scans_plain(words)
    n = words.shape[0]
    kernels.check("words", words, torch.int64, (n,))
    dev = words.device
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty_like(keys)
    fwd = torch.empty_like(keys)
    is_read = torch.empty(n, dtype=torch.bool, device=dev)
    is_write = torch.empty_like(is_read)
    win = torch.empty_like(is_read)
    plan = ForwardPlan(keys=keys, rank=rank, is_read=is_read,
                       is_write=is_write, fwd=fwd, win=win, perm=None)
    if n == 0:
        return plan
    scratch = torch.empty(SCAN_RUNS, dtype=torch.int32, device=dev)
    K2_SCAN.launch(kernels.ptr(words), n, kernels.ptr(keys),
                   kernels.ptr(rank), kernels.ptr(is_read),
                   kernels.ptr(is_write), kernels.ptr(fwd), kernels.ptr(win),
                   kernels.ptr(scratch), scratch.numel(),
                   kernels.stream(words))
    return plan


# -- the plan -------------------------------------------------------------

def forward_plan(keys: torch.Tensor, rank: torch.Tensor,
                 is_write: torch.Tensor, valid: torch.Tensor,
                 with_perm: bool = False) -> ForwardPlan:
    """Build the sorted forwarding plan for one epoch.

    keys: int32[B, A]; rank: int32[B] unique, >= 0; is_write/valid: bool[B, A].
    """
    b, a = keys.shape
    k = torch.where(valid, keys, torch.full_like(keys, INT32_MAX)).reshape(-1)
    r = rank[:, None].expand(b, a).reshape(-1)
    w = (is_write & valid).reshape(-1)
    return forward_plan_flat(k, r, w, with_perm=with_perm)


def forward_plan_flat(k: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                      with_perm: bool = False) -> ForwardPlan:
    """Flat-lane core of `forward_plan`: k int32[N] with invalid lanes at
    INT32_MAX, r int32[N] ranks, w bool[N] valid write lanes.

    ``with_perm`` (the unsorted test entry `last_earlier_writer`) runs the
    plain versions only."""
    if with_perm:
        if not kernels.on_cpu(k, r, w):
            raise NotImplementedError(
                "with_perm is a CPU test entry; the kernels never unsort")
        words, perm = sort_lanes_plain(k, r, w)
        return plan_scans_plain(words, perm=perm)
    return plan_scans(sort_lanes(k, r, w))


def last_earlier_writer(keys: torch.Tensor, rank: torch.Tensor,
                        is_write: torch.Tensor, valid: torch.Tensor
                        ) -> torch.Tensor:
    """int32[B, A]: ``ForwardPlan.fwd`` unsorted back to the [B, A]
    layout (testing entry; the hot path stays sorted)."""
    p = forward_plan(keys, rank, is_write, valid, with_perm=True)
    out = torch.zeros_like(p.fwd)
    out[p.perm] = p.fwd
    return out.reshape(keys.shape)
