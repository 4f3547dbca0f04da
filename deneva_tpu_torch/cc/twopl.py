"""2PL variants: NO_WAIT and WAIT_DIE (port of ``deneva_tpu/cc/twopl.py``).

Lock acquisition order is ``rank`` (pool arrival order): a txn acquires
all its locks iff it wins the lex-first maximal-independent-set sweep
over the epoch's lock conflicts in rank order.  NO_WAIT aborts the
losers; WAIT_DIE lets a loser older than every winner that blocked it
wait (defer), and keeps its birth ts across restarts.  Sweep-round-cap
leftovers defer.

Isolation levels relax which requests conflict (reference
`config.h:102,337-340`):

* SERIALIZABLE — long read and write locks: the symmetrized overlap of
  the (ordered) union with the writes;
* READ_COMMITTED — read locks released after the read: write-write
  pairs, plus an ordered pure read behind an earlier writer;
* READ_UNCOMMITTED — reads bypass the lock table: write-write pairs;
* NOLOCK — no locking at all: `validate_nocc`.

The conflicts come from K7 (`ops.conflict.overlap`) and the sweep is K8
(`ops.conflict.first_fit`), which applies ``earlier_edges`` itself.
Where a level ORs two conflict matrices before the one K8 launch, that
is exact: ``earlier_edges(a) | earlier_edges(b) == earlier_edges(a | b)``.
The repair frontier is the generic one (K13a, ``cc/base.py``).
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.cc import base
from deneva_tpu_torch.cc.base import (AccessBatch, Incidence, Verdict,
                                      get_overlap)
from deneva_tpu_torch.cc.nocc import validate_nocc
from deneva_tpu_torch.ops import conflict

INT32_MAX = 2**31 - 1


def views(cfg) -> tuple[str, ...]:
    """The incidence views `_lock_conflicts` reads at the config's
    isolation level (none under NOLOCK)."""
    return {"SERIALIZABLE": ("uo", "w"),
            "READ_COMMITTED": ("wo", "w", "pro"),
            "READ_UNCOMMITTED": ("wo", "w")}.get(cfg.isolation_level, ())


def repair_frontier(cfg, state, batch, inc, committed, losers):
    """2PL's transaction-repair rule (``deneva_tpu/cc/twopl.py:68``): the
    generic frontier (K13a) at every isolation level — the level changes
    which requests conflict, not which read values went stale."""
    return base.committed_write_frontier(cfg, batch, inc, committed,
                                         losers)


def _lock_conflicts(cfg, batch: AccessBatch, inc: Incidence):
    """bool[B, B] C with ``earlier_edges(C, rank, active)`` the reference's
    ``_lock_edges`` (``deneva_tpu/cc/twopl.py:87``); None under NOLOCK.
    The ordered views (uo / wo / pro) alias u / w / pr when no escrow
    exemption applies."""
    iso = cfg.isolation_level
    if iso == "NOLOCK":
        return None
    ov = get_overlap(cfg)
    if iso == "SERIALIZABLE":
        uo1 = inc.u1 if inc.uo1 is None else inc.uo1
        uo2 = inc.u2 if inc.uo1 is None else inc.uo2
        uw = ov(uo1, inc.w1, uo2, inc.w2)
        return uw | uw.T
    wo1 = inc.w1 if inc.wo1 is None else inc.wo1
    wo2 = inc.w2 if inc.wo1 is None else inc.wo2
    ww = ov(wo1, inc.w1, wo2, inc.w2)
    c = ww | ww.T
    if iso == "READ_COMMITTED":
        # i's ordered pure read contends with an earlier writer j
        pro1 = inc.pr1 if inc.pro1 is None else inc.pro1
        pro2 = inc.pr2 if inc.pro1 is None else inc.pro2
        c = c | ov(pro1, inc.w1, pro2, inc.w2)
    return c


def _lock_edges(cfg, batch: AccessBatch, inc: Incidence):
    """Directed blocked-by edges E[i, j] ("earlier j blocks i"); None
    under NOLOCK."""
    c = _lock_conflicts(cfg, batch, inc)
    if c is None:
        return None
    return conflict.earlier_edges(c, batch.rank, batch.active)


def validate_no_wait(cfg, state, batch: AccessBatch, inc: Incidence):
    c = _lock_conflicts(cfg, batch, inc)
    if c is None:
        return validate_nocc(cfg, state, batch, inc)
    win, lose, und = conflict.first_fit(c, batch.rank, batch.active,
                                        cfg.sweep_rounds)
    v = Verdict(commit=win, abort=lose, defer=und, order=batch.rank,
                level=torch.zeros_like(batch.rank))
    return v, state


def validate_wait_die(cfg, state, batch: AccessBatch, inc: Incidence):
    c = _lock_conflicts(cfg, batch, inc)
    if c is None:
        return validate_nocc(cfg, state, batch, inc)
    win, lose, und = conflict.first_fit(c, batch.rank, batch.active,
                                        cfg.sweep_rounds)
    # min ts over the winning earlier neighbours that blocked me: plain
    # [B, B] glue on the edges
    blockers = conflict.earlier_edges(c, batch.rank, batch.active) \
        & win[None, :]
    min_owner_ts = torch.where(blockers, batch.ts[None, :],
                               INT32_MAX).amin(dim=1)
    waits = lose & (batch.ts < min_owner_ts)   # older than every owner
    v = Verdict(commit=win, abort=lose & ~waits, defer=und | waits,
                order=batch.rank, level=torch.zeros_like(batch.rank))
    return v, state
