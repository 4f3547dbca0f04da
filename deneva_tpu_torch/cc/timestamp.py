"""TIMESTAMP (basic T/O) and MVCC (port of ``deneva_tpu/cc/timestamp.py``).

Cross-epoch watermarks live in per-bucket tables ``rts[K]`` / ``wts[K]``
(K = ``watermark_buckets``, family-0 hash), max-aggregated over the keys
hashing there: an over-approximation that can only add aborts.  Within
an epoch every read sees the epoch-start snapshot, so the one in-epoch
violation is a reader ordered after a committing writer of the same
bucket: those pairs are swept in timestamp order and the later reader
waits (defers with its ts).  Blind write-write pairs both commit, last
writer wins (Thomas' rule), since ``Verdict.order = ts``.

Abort rules, per lane at the txn's ts (reference `row_ts.cpp`):

* read:  ``wts > ts``; under MVCC a pure read aborts only when the
  version it needs is older than the bucket's retained boundaries
  (``ts < min(his)``), and an RMW read still must read latest;
* write: ``rts > ts`` or ``wts > ts``;
* MVCC read-only txns always commit, serialized at the snapshot
  (``order = 0``).

Escrow (``order_free``) lanes follow the reference's relaxed rules; YCSB
declares none, but every function here takes them.

Two kernels carry it on the card (``csrc/timestamp.cu``), each beside
its plain version written op for op from the reference:

* **K12a** `_watermark_check` — replaces ``cc/timestamp.py:112``
  `_wm_bucket`, ``:164`` `_readonly`, ``:174`` `_stale_read_lanes` and
  ``:202`` `_watermark_aborts`: per txn, the watermark abort and the
  read-only flag;
* **K12b** `_commit_watermarks` — replaces ``:271``: the committed
  lanes' scatter-max into ``rts`` / ``wts`` and, under MVCC, one
  epoch boundary per written bucket pushed onto its ring.  On the card
  it updates the state in place, as the port writes its tables.

The later-reader sweep reuses K7 (overlap) and K8 (first fit).  The
repair frontiers add the stale-read lanes to the generic one (K13a).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.cc import base
from deneva_tpu_torch.cc.base import (AccessBatch, Incidence, Verdict,
                                      get_overlap)
from deneva_tpu_torch.ops import conflict
from deneva_tpu_torch.ops.hashing import bucket_hash, combine_key

K12A_CHECK = kernels.Kernel("dt_watermark_check", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.P,
    kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.P, kernels.P,
    kernels.P])
K12B_COMMIT = kernels.Kernel("dt_commit_watermarks", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.P, kernels.P,
    kernels.I32, kernels.P, kernels.P, kernels.P, kernels.I32, kernels.P])


def views(cfg) -> tuple[str, ...]:
    """The incidence views `validate_timestamp` / `validate_mvcc` read."""
    return ("ro", "w")


def _wm_bucket(cfg, batch: AccessBatch) -> torch.Tensor:
    """Per-access bucket ids in the watermark hash space (family 0)."""
    ident = combine_key(batch.table_ids, batch.keys)
    return bucket_hash(ident, cfg.watermark_buckets, family=0)


@dataclass
class TOState:
    """Per-bucket committed watermarks."""

    rts: torch.Tensor   # int32[K] max committed read ts
    wts: torch.Tensor   # int32[K] max committed write ts


@dataclass
class MVCCState:
    """TOState plus the bounded version-boundary ring."""

    rts: torch.Tensor   # int32[K]
    wts: torch.Tensor   # int32[K]
    his: torch.Tensor   # int32[K, H] recent version-boundary ts (0 = base)
    pos: torch.Tensor   # int32[K] next ring slot per bucket
    # K12b's per-bucket scratch, all zeros between epochs; not a state
    # leaf of the reference
    scratch: torch.Tensor


def init_to_state(cfg, device) -> TOState:
    k = cfg.watermark_buckets
    return TOState(rts=torch.zeros(k, dtype=torch.int32, device=device),
                   wts=torch.zeros(k, dtype=torch.int32, device=device))


def init_mvcc_state(cfg, device) -> MVCCState:
    k, h = cfg.watermark_buckets, cfg.mvcc_his_len

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return MVCCState(rts=z(k), wts=z(k), his=z(k, h), pos=z(k),
                     scratch=z(k))


def _readonly(batch: AccessBatch) -> torch.Tensor:
    """bool[B]: read-only txns (the global ``ro_hint`` when given)."""
    if batch.ro_hint is not None:
        return batch.ro_hint
    v = batch.valid & batch.active[:, None]
    return ~(v & batch.is_write).any(dim=1)


def _stale_read_lanes(cfg, state, batch: AccessBatch,
                      mvcc: bool) -> torch.Tensor:
    """bool[B, A]: read lanes violating the cross-epoch ``wts``
    watermark at the txn's ts; escrow reads are exempt."""
    wm = _wm_bucket(cfg, batch).long()
    v = batch.valid & batch.active[:, None]
    wts_at = state.wts[wm]
    ts = batch.ts[:, None]
    if mvcc:
        his_min = state.his.amin(dim=1)[wm]
        pure = batch.is_read & ~batch.is_write
        rmw = batch.is_read & batch.is_write
        read_bad = v & ((pure & (wts_at > ts) & (ts < his_min))
                        | (rmw & (wts_at > ts)))
    else:
        read_bad = v & batch.is_read & (wts_at > ts)
    if batch.order_free is not None:
        read_bad = read_bad & ~batch.order_free
    return read_bad


def _watermark_aborts(cfg, state, batch: AccessBatch,
                      mvcc: bool) -> torch.Tensor:
    """bool[B]: the txn violates a cross-epoch watermark."""
    wm = _wm_bucket(cfg, batch).long()
    v = batch.valid & batch.active[:, None]
    wts_at = state.wts[wm]
    rts_at = state.rts[wm]
    ts = batch.ts[:, None]
    read_bad = _stale_read_lanes(cfg, state, batch, mvcc)
    if batch.order_free is None:
        write_bad = v & batch.is_write & ((rts_at > ts) | (wts_at > ts))
    else:
        write_bad = v & batch.is_write & torch.where(
            batch.order_free, rts_at > ts, (rts_at > ts) | (wts_at > ts))
    bad = (read_bad | write_bad).any(dim=1)
    if mvcc:
        bad = bad & ~_readonly(batch)
    return bad


def _watermark_check_plain(cfg, state, batch: AccessBatch, mvcc: bool):
    """Plain K12a: (wm_abort, ro), ro all False unless ``mvcc``."""
    ro = _readonly(batch) if mvcc else torch.zeros_like(batch.active)
    return _watermark_aborts(cfg, state, batch, mvcc), ro


def _opt(t: torch.Tensor | None):
    return None if t is None else kernels.ptr(t)


def _check_lanes(batch: AccessBatch, flag: torch.Tensor, dev) -> None:
    b, a = batch.keys.shape
    for name, t, dt in (("table_ids", batch.table_ids, torch.int32),
                        ("keys", batch.keys, torch.int32),
                        ("is_read", batch.is_read, torch.bool),
                        ("is_write", batch.is_write, torch.bool),
                        ("valid", batch.valid, torch.bool)):
        kernels.check(name, t, dt, (b, a), dev)
    kernels.check("txn flags", flag, torch.bool, (b,), dev)
    kernels.check("ts", batch.ts, torch.int32, (b,), dev)
    if batch.order_free is not None:
        kernels.check("order_free", batch.order_free, torch.bool, (b, a), dev)


def _check_state(cfg, state, dev) -> int:
    k = cfg.watermark_buckets
    if k & (k - 1):
        raise ValueError("n_buckets must be a power of two")
    kernels.check("rts", state.rts, torch.int32, (k,), dev)
    kernels.check("wts", state.wts, torch.int32, (k,), dev)
    if isinstance(state, MVCCState):
        h = state.his.shape[1]
        kernels.check("his", state.his, torch.int32, (k, h), dev)
        kernels.check("pos", state.pos, torch.int32, (k,), dev)
        return h
    return 0


def _watermark_check(cfg, state, batch: AccessBatch, mvcc: bool):
    """K12a: one warp per txn hashes its lanes, gathers the watermarks
    (and under MVCC the row min of its buckets' rings), applies the
    read and write rules and any-reduces.  Returns (wm_abort, ro)."""
    if kernels.on_cpu(batch.keys, batch.active, state.rts):
        return _watermark_check_plain(cfg, state, batch, mvcc)
    b, a = batch.keys.shape
    dev = batch.keys.device
    _check_lanes(batch, batch.active, dev)
    h = _check_state(cfg, state, dev)
    if mvcc != (h > 0):
        raise ValueError("K12a: MVCC needs an MVCCState, TIMESTAMP a TOState")
    if batch.ro_hint is not None:
        kernels.check("ro_hint", batch.ro_hint, torch.bool, (b,), dev)
    wm_abort = torch.empty(b, dtype=torch.bool, device=dev)
    ro = torch.empty(b, dtype=torch.bool, device=dev)
    K12A_CHECK.launch(
        kernels.ptr(batch.table_ids), kernels.ptr(batch.keys),
        kernels.ptr(batch.is_read), kernels.ptr(batch.is_write),
        kernels.ptr(batch.valid), kernels.ptr(batch.active),
        _opt(batch.order_free), kernels.ptr(batch.ts), _opt(batch.ro_hint),
        b, a, kernels.ptr(state.rts), kernels.ptr(state.wts),
        _opt(state.his if mvcc else None), cfg.watermark_buckets, h,
        kernels.ptr(wm_abort), kernels.ptr(ro), kernels.stream(batch.keys))
    return wm_abort, ro


def _repair_frontier(cfg, state, batch: AccessBatch, inc: Incidence,
                     committed: torch.Tensor, losers: torch.Tensor,
                     mvcc: bool) -> torch.Tensor:
    """T/O's transaction-repair rule (``deneva_tpu/cc/timestamp.py:226``):
    this epoch's committed overwrites of the loser's ordered reads (K13a)
    and the cross-epoch stale-read lanes that made it abort, read from
    the watermarks as the previous round left them."""
    front = base.committed_write_frontier(cfg, batch, inc, committed,
                                          losers)
    stale = _stale_read_lanes(cfg, state, batch, mvcc) & losers[:, None]
    return front | stale


def repair_frontier_timestamp(cfg, state, batch, inc, committed, losers):
    return _repair_frontier(cfg, state, batch, inc, committed, losers,
                            mvcc=False)


def repair_frontier_mvcc(cfg, state, batch, inc, committed, losers):
    return _repair_frontier(cfg, state, batch, inc, committed, losers,
                            mvcc=True)


def _rw_later_reader_conflicts(cfg, batch: AccessBatch, inc: Incidence):
    """bool[B, B]: ordered reads of i meet writes of j (``ro`` aliases
    ``r`` when no escrow exemption applies)."""
    ro1 = inc.r1 if inc.ro1 is None else inc.ro1
    ro2 = inc.r2 if inc.ro1 is None else inc.ro2
    return get_overlap(cfg)(ro1, inc.w1, ro2, inc.w2)


def _commit_watermarks_plain(cfg, state, batch: AccessBatch,
                             commit: torch.Tensor):
    """Plain K12b, op for op from ``deneva_tpu/cc/timestamp.py:271``;
    returns a new state."""
    v = batch.valid & commit[:, None]
    ts = batch.ts[:, None].expand(batch.keys.shape)
    r_rec = v & batch.is_read if batch.order_free is None \
        else v & batch.is_read & ~batch.order_free
    r_ts = torch.where(r_rec, ts, 0).reshape(-1)
    w_ts = torch.where(v & batch.is_write, ts, 0).reshape(-1)
    flat = _wm_bucket(cfg, batch).reshape(-1).long()
    rts = state.rts.scatter_reduce(0, flat, r_ts, "amax")
    wts = state.wts.scatter_reduce(0, flat, w_ts, "amax")
    if not isinstance(state, MVCCState):
        return TOState(rts=rts, wts=wts)
    epoch_w = torch.zeros_like(state.wts).scatter_reduce(0, flat, w_ts,
                                                         "amax")
    wrote = epoch_w > 0
    h = state.his.shape[1]
    slot = torch.arange(h, dtype=torch.int32,
                        device=wrote.device)[None, :] == state.pos[:, None]
    his = torch.where(wrote[:, None] & slot, epoch_w[:, None], state.his)
    pos = torch.where(wrote, (state.pos + 1) % h, state.pos)
    return MVCCState(rts=rts, wts=wts, his=his, pos=pos,
                     scratch=state.scratch)


def _commit_watermarks(cfg, state, batch: AccessBatch,
                       commit: torch.Tensor):
    """K12b: the committed lanes' watermarks, in place on the card.
    Under MVCC a first pass takes each written bucket's max ts into the
    all-zero scratch; a second pass lets the one lane that swaps a
    bucket's scratch back to zero push that boundary onto its ring."""
    if kernels.on_cpu(batch.keys, commit, state.rts):
        return _commit_watermarks_plain(cfg, state, batch, commit)
    b, a = batch.keys.shape
    dev = batch.keys.device
    _check_lanes(batch, commit, dev)
    h = _check_state(cfg, state, dev)
    his = pos = scratch = None
    if h:
        kernels.check("scratch", state.scratch, torch.int32,
                      state.wts.shape, dev)
        his, pos, scratch = state.his, state.pos, state.scratch
    K12B_COMMIT.launch(
        kernels.ptr(batch.table_ids), kernels.ptr(batch.keys),
        kernels.ptr(batch.is_read), kernels.ptr(batch.is_write),
        kernels.ptr(batch.valid), kernels.ptr(commit),
        _opt(batch.order_free), kernels.ptr(batch.ts), b, a,
        kernels.ptr(state.rts), kernels.ptr(state.wts),
        cfg.watermark_buckets, _opt(his), _opt(pos), _opt(scratch), h,
        kernels.stream(batch.keys))
    return state


def _validate_to(cfg, state, batch: AccessBatch, inc: Incidence,
                 mvcc: bool):
    wm_abort, ro = _watermark_check(cfg, state, batch, mvcc)
    live = batch.active & ~wm_abort
    # read-only MVCC txns leave the conflict graph entirely
    swept = live & ~ro
    rw = _rw_later_reader_conflicts(cfg, batch, inc)
    # K8 on the swept set: first_fit(rw, ts, swept) sweeps
    # earlier_edges(rw, ts, swept), which equals the reference's
    # earlier_edges(rw, ts, active) & swept[:, None] & swept[None, :]
    # because swept is a subset of active
    win, lose, und = conflict.first_fit(rw, batch.ts, swept,
                                        cfg.sweep_rounds)
    commit = win | (live & ro)
    # read-only MVCC txns serialize at the snapshot, before every writer
    order = torch.where(ro, 0, batch.ts)
    # a swept-out later reader waits; only watermark violations abort
    v = Verdict(commit=commit, abort=batch.active & wm_abort,
                defer=und | lose, order=order,
                level=torch.zeros_like(batch.rank))
    return v, _commit_watermarks(cfg, state, batch, commit)


def commit_to_state(cfg, state, batch: AccessBatch, inc, commit):
    """Watermarks for a globally decided commit set (the reference's
    VOTE hook; ``inc`` is unused)."""
    return _commit_watermarks(cfg, state, batch, commit)


def validate_timestamp(cfg, state, batch: AccessBatch, inc: Incidence):
    return _validate_to(cfg, state, batch, inc, mvcc=False)


def validate_mvcc(cfg, state, batch: AccessBatch, inc: Incidence):
    return _validate_to(cfg, state, batch, inc, mvcc=True)
