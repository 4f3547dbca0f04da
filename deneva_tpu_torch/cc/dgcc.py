"""DGCC: dependency-graph wavefront execution (port of ``deneva_tpu/cc/dgcc.py``).

The epoch's dependency graph is built BEFORE commit, over the planned
access sets of all active txns, and every txn gets an execution wave:
wave k re-reads only rows written by waves < k, so conflicting txns
serialize instead of aborting.  The only non-commit outcome is a DEFER
of dependency closures deeper than ``dgcc_levels``; ``abort`` is zero.

Wave assignment relaxes levels over the lanes of `cc.depgraph`: a READ
lane lands strictly after every earlier writer of its key (``lv >=
max(earlier writer) + 1``); a WRITE lane lands no earlier than every
earlier reader or writer (``lv >= max(...)``, same wave: the executor
gathers a wave's reads before it scatters, and same-wave writers resolve
by the ``last_writer`` tournament, K10).  Candidates clamp at the budget,
so saturation propagates segment-wide and the fixpoint takes at most
``2 * dgcc_levels + 4`` rounds; levels below the clamp are exact
longest-path waves and commit, saturated txns (and everything downstream
of one) defer, and a fixpoint miss inside the budget defers the epoch.
Escrow (``order_free``) lanes contribute no lanes and commit in wave 0.

The kernels: K15a sorts the doubled lanes, K15b finds the segments and
counts the edges (`cc.depgraph`), and **K16** `relax` (``csrc/
depgraph.cu``, beside its plain version) runs the whole relaxation in one
launch of a thread-block cluster — replacing ``dgcc.py:127-154`` — so the
round count and the changed flag stay on the device and the epoch never
syncs the host.  It
is Jacobi, as the reference: each round reads the previous round's
levels, so a run cut by the budget ends where the reference's does.
The arrival order ``dpos`` (``:94-97``) is torch glue (one stable argsort
of B ranks).

The chained executor runs the waves with ``level_exec=False`` and runs
all ``dgcc_levels`` passes (`engine.step._run_levels`).
"""

from __future__ import annotations

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.cc import depgraph
from deneva_tpu_torch.cc.base import AccessBatch, Verdict
from deneva_tpu_torch.ops.hashing import combine_key

INT32_MAX = 2**31 - 1
MASK32 = 0xFFFFFFFF

K16_RELAX = kernels.Kernel("dt_dgcc_relax", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32,
    kernels.I32, kernels.I32, kernels.I32, kernels.P, kernels.I64, kernels.P,
    kernels.P, kernels.P, kernels.P])


def relax_layout(n: int, b: int, max_ctas: int = 0) -> tuple[int, bool, int]:
    """K16's launch over ``n`` lanes and ``b`` txns as the kernel library
    chooses it (CUDA only): (CTAs of its cluster, lane words in shared
    memory rather than scratch, int32 words of scratch).  ``max_ctas``
    (1, 2, 4 or 8) caps the cluster; 0 takes the library's choice."""
    ctas, shared, words = kernels.layout("dt_dgcc_relax_layout", n, b,
                                         max_ctas)
    return ctas, bool(shared), words


def relax_plain(head: torch.Tensor, sid: torch.Tensor, sw: torch.Tensor,
                live: torch.Tensor, b: int, rounds: int):
    """Plain K16, op for op from ``deneva_tpu/cc/dgcc.py:127-154``:
    (lv int32[b], changed bool scalar, rounds run int32 scalar) after the
    Jacobi relaxation."""
    idx = sid.long()

    def relax(lv):
        g = lv[idx]
        exw = depgraph.seg_excl_max(head, torch.where(sw & live, g, -1))
        exr = depgraph.seg_excl_max(head, torch.where(~sw & live, g, -1))
        cand = torch.clamp(torch.where(
            sw, torch.clamp(torch.maximum(exw, exr), min=0),
            torch.where(exw >= 0, exw + 1, 0)), max=rounds)
        return lv.scatter_reduce(0, idx, torch.where(live, cand, 0), "amax")

    lv = torch.zeros(b, dtype=torch.int32, device=sid.device)
    changed, i = True, 0
    while changed and i < 2 * rounds + 4:
        lv2 = relax(lv)
        changed = bool((lv2 != lv).any())
        lv, i = lv2, i + 1
    return (lv, torch.tensor(changed, device=sid.device),
            torch.tensor(i, dtype=torch.int32, device=sid.device))


def relax(head: torch.Tensor, sid: torch.Tensor, sw: torch.Tensor,
          live: torch.Tensor, b: int, rounds: int):
    """K16: the relaxation to its fixpoint or ``2 * rounds + 4`` rounds in
    one launch of a thread-block cluster (`relax_layout`); returns (lv,
    changed, rounds run) on the device.  The lanes are those of
    `depgraph.census`: the live ones a prefix (dead lanes sort last), lane
    0 a segment head."""
    return _relax(head, sid, sw, live, b, rounds, 0)


def _relax(head, sid, sw, live, b: int, rounds: int, max_ctas: int):
    """`relax` in a cluster of at most ``max_ctas`` CTAs (0: the library's
    choice); other sizes are for measuring them against each other."""
    if kernels.on_cpu(head, sid, sw, live):
        return relax_plain(head, sid, sw, live, b, rounds)
    n = sid.shape[0]
    dev = sid.device
    kernels.check("head", head, torch.bool, (n,), dev)
    kernels.check("sid", sid, torch.int32, (n,), dev)
    kernels.check("sw", sw, torch.bool, (n,), dev)
    kernels.check("live", live, torch.bool, (n,), dev)
    if not 1 <= rounds <= 256 or n >= 1 << 21 or b > 25600:
        raise ValueError("K16 takes 1 <= rounds <= 256, under 2^21 lanes "
                         "and the levels of at most 25,600 txns in shared "
                         "memory")
    words = relax_layout(n, b, max_ctas)[2]
    meta = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
    lv = torch.empty(b, dtype=torch.int32, device=dev)
    changed = torch.empty((), dtype=torch.bool, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    K16_RELAX.launch(kernels.ptr(head), kernels.ptr(sid), kernels.ptr(sw),
                     kernels.ptr(live), n, b, rounds, 2 * rounds + 4,
                     max_ctas, kernels.ptr(meta), meta.numel(),
                     kernels.ptr(lv), kernels.ptr(changed),
                     kernels.ptr(iters), kernels.stream(sid))
    return lv, changed, iters


def lanes(batch: AccessBatch):
    """The doubled lanes of ``dgcc.py:86-108``: (keys int64, pos int32,
    tid int32), reads first, each [2 * B * A]."""
    b, a = batch.shape
    dev = batch.keys.device
    act = batch.valid & batch.active[:, None]
    if batch.order_free is not None:
        act = act & ~batch.order_free
    rm = act & batch.is_read
    wm = act & batch.is_write
    ident = combine_key(batch.table_ids, batch.keys)
    # dense arrival positions over active txns (stable lane tiebreak),
    # doubled so a txn's read lanes precede its own write lanes
    okey = torch.where(batch.active, batch.rank, INT32_MAX)
    perm = torch.argsort(okey, stable=True)
    dpos = torch.empty(b, dtype=torch.int32, device=dev)
    dpos[perm] = torch.arange(b, dtype=torch.int32, device=dev)
    rpos = (dpos * 2)[:, None].expand(b, a)
    wpos = (dpos * 2 + 1)[:, None].expand(b, a)
    tid = torch.arange(b, dtype=torch.int32, device=dev)[:, None].expand(b, a)
    keys2 = torch.cat([torch.where(rm, ident, depgraph.LANE_PAD).reshape(-1),
                       torch.where(wm, ident, depgraph.LANE_PAD).reshape(-1)])
    pos2 = torch.cat([rpos.reshape(-1), wpos.reshape(-1)])
    tid2 = torch.cat([tid.reshape(-1), tid.reshape(-1)])
    return keys2, pos2, tid2


def dgcc_levels(cfg, batch: AccessBatch):
    """Wave assignment (``dgcc.py:77``): (lv int32[B], overflow bool[B],
    edge_cnt int32), through K15a, K15b and K16."""
    b, _a = batch.shape
    sk, sp, sid = depgraph.lane_sort(*lanes(batch), b)
    # keys are unsigned, so the one real key per table that combines to
    # LANE_PAD sorts with the dead lanes and is dead, as the reference's
    # `live = sk != big` (ROADMAP.md watch item 23)
    sw = (sp & 1) == 1
    live = sk != depgraph.LANE_PAD
    head, _pw, _pr, edge_cnt = depgraph.census(sk, sp, sid)
    rounds = max(1, cfg.dgcc_levels)
    lv, changed, _iters = relax(head, sid, sw, live, b, rounds)
    deep = lv >= rounds
    overflow = batch.active & (deep | changed)
    return lv, overflow, edge_cnt


def validate_dgcc(cfg, state, batch: AccessBatch, inc=None, stats=None):
    """DGCC verdict (``dgcc.py:167``): commit every txn whose closure fits
    the wave budget, defer the rest; ``stats`` (the engine's device
    counters) takes the [dgcc] counters in place."""
    lv, overflow, edge_cnt = dgcc_levels(cfg, batch)
    commit = batch.active & ~overflow
    level = torch.where(commit, lv, 0)
    if stats is not None:
        waves = (torch.where(commit, level, -1).max() + 1).to(torch.int64)
        stats["dgcc_wave_cnt"] = (stats["dgcc_wave_cnt"] + waves) & MASK32
        stats["dgcc_wave_max"] = torch.maximum(stats["dgcc_wave_max"], waves)
        stats["dgcc_fallback_cnt"] = (stats["dgcc_fallback_cnt"]
                                      + overflow.sum()) & MASK32
        stats["dgcc_edge_cnt"] = (stats["dgcc_edge_cnt"]
                                  + edge_cnt.to(torch.int64)) & MASK32
    return Verdict(commit=commit, abort=torch.zeros_like(commit),
                   defer=batch.active & overflow, order=batch.rank,
                   level=level), state
