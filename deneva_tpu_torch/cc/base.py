"""CC backend interface: batched epoch validation (port of ``deneva_tpu/cc/base.py``).

An algorithm is a pure function over one epoch's planned accesses,
``validate(cfg, state, batch, incidence) -> (Verdict, state)``.  The
port carries the records, the incidence construction of the sweep
backends, the ``get_overlap`` seam and transaction repair's frontier;
the audit and density planes come with ROADMAP.md queue 1, item 16c.

One kernel lives here (``csrc/frontier.cu``), beside its plain version:

* **K13a** `committed_write_frontier` — replaces ``cc/base.py:193``: the
  bf16 matvec ``committed[1, B] x w[B, K] > 0`` of each hash family,
  gathered at every lane's bucket and masked to the losers' ordered
  reads.  The kernel ORs each column of ``w`` down the committed rows
  instead of multiplying: the views hold access counts (>= 0), so a
  column's f32 sum is positive exactly when one committed row holds a
  non-zero count, and the result is the matvec's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.ops import conflict
from deneva_tpu_torch.ops.hashing import bucket_hash, combine_key

K13A_FRONTIER = kernels.Kernel("dt_repair_frontier", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32,
    kernels.I32, kernels.P, kernels.P, kernels.P])


def get_overlap(cfg):
    """Per-config overlap op: the one seam every sweep backend calls
    (``deneva_tpu/cc/base.py:54``).  K7 behind it."""
    return conflict.overlap


@dataclass
class AccessBatch:
    """One epoch's planned accesses, [B, A] / [B] tensors."""

    table_ids: torch.Tensor   # int32[B, A]
    keys: torch.Tensor        # int32[B, A]
    is_read: torch.Tensor     # bool[B, A]
    is_write: torch.Tensor    # bool[B, A]
    valid: torch.Tensor       # bool[B, A]
    ts: torch.Tensor          # int32[B]
    rank: torch.Tensor        # int32[B]
    active: torch.Tensor      # bool[B]
    ro_hint: torch.Tensor | None = None
    order_free: torch.Tensor | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.keys.shape)


@dataclass
class Verdict:
    commit: torch.Tensor      # bool[B]
    abort: torch.Tensor       # bool[B]
    defer: torch.Tensor       # bool[B]
    order: torch.Tensor       # int32[B] serialization order
    level: torch.Tensor       # int32[B] execution sub-round


@dataclass
class Incidence:
    """Bucket-space incidence of one epoch, both hash families: bf16[B, K]
    reads / writes / union / pure reads, and the ordered copies (accesses
    not marked order_free), which alias the plain views when no exemption
    applies.  A view no backend reads is None; family-2 views are None
    unless ``conflict_exact``."""

    r1: torch.Tensor | None
    w1: torch.Tensor | None
    u1: torch.Tensor | None
    pr1: torch.Tensor | None
    r2: torch.Tensor | None
    w2: torch.Tensor | None
    u2: torch.Tensor | None
    pr2: torch.Tensor | None
    bucket1: torch.Tensor     # int32[B, A] family-0 bucket per lane
    uo1: torch.Tensor | None = None
    uo2: torch.Tensor | None = None
    ro1: torch.Tensor | None = None
    ro2: torch.Tensor | None = None
    wo1: torch.Tensor | None = None
    wo2: torch.Tensor | None = None
    pro1: torch.Tensor | None = None
    pro2: torch.Tensor | None = None


def gate_order_free(cfg, be, order_free: torch.Tensor | None
                    ) -> torch.Tensor | None:
    """The one escrow gate: the workload's ``order_free`` mask iff this
    backend may consume it, else None (``deneva_tpu/cc/base.py:163``)."""
    if order_free is None or not be.exempt_order_free \
            or not cfg.escrow_order_free:
        return None
    if not be.chained and not cfg.escrow_sweep:
        return None
    return order_free


def build_conflict_incidence(cfg, be, batch: AccessBatch,
                             order_free: torch.Tensor | None):
    """`build_incidence` honoring the backend's order_free exemption,
    building only the views the backend reads (``be.views(cfg)``); None
    when it reads none."""
    views = be.views(cfg)
    if cfg.repair and "w" not in views:
        # the repair frontier reads the plain write view of both families;
        # 2PL under NOLOCK validates without any view, and an incidence of
        # None would leave the frontier nothing to read (ROADMAP.md watch
        # item 25)
        views = views + ("w",)
    if not views:
        return None
    order_free = gate_order_free(cfg, be, order_free)
    return build_incidence(batch, cfg.conflict_buckets, cfg.conflict_exact,
                           order_free=order_free, views=views)


def build_incidence(batch: AccessBatch, n_buckets: int, exact: bool,
                    order_free: torch.Tensor | None = None,
                    views: tuple[str, ...] = conflict.VIEWS) -> Incidence:
    """The requested views of both families, through K5+K6.  Without
    ``order_free`` an ordered view aliases its plain one, as in the
    reference (``deneva_tpu/cc/base.py:587``)."""
    src = {}
    for v in views:
        base = conflict.ORDERED.get(v, v) if order_free is None else v
        src[v] = base
        src.setdefault(base, base)
    built = tuple(dict.fromkeys(src.values()))
    fams, b1 = conflict.hashed_incidence(
        batch.table_ids, batch.keys, batch.is_read, batch.is_write,
        batch.valid, batch.active, order_free, n_buckets,
        2 if exact else 1, built)
    kw = {}
    for f in (1, 2):
        fam = fams[f - 1] if f <= len(fams) else {}
        for v in conflict.VIEWS:
            kw[f"{v}{f}"] = fam.get(src[v]) if v in src else None
    return Incidence(bucket1=b1, **kw)


def committed_write_frontier_plain(cfg, batch: AccessBatch, inc: Incidence,
                                   committed: torch.Tensor,
                                   losers: torch.Tensor) -> torch.Tensor:
    """Plain K13a, op for op from ``deneva_tpu/cc/base.py:193``: bool[B, A]
    marking each loser's ordered read lanes whose bucket a committed txn
    wrote (in both families under ``conflict_exact``).  The f32 products
    of the integer counts are exact."""
    wrote = torch.matmul(committed.float()[None, :], inc.w1.float())[0] > 0
    hit = wrote[inc.bucket1.long()]
    if inc.w2 is not None:
        ident = combine_key(batch.table_ids, batch.keys)
        b2 = bucket_hash(ident, inc.w2.shape[1], family=1)
        wrote2 = torch.matmul(committed.float()[None, :],
                              inc.w2.float())[0] > 0
        hit = hit & wrote2[b2.long()]
    rmask = batch.valid & losers[:, None] & batch.is_read
    if batch.order_free is not None:
        rmask = rmask & ~batch.order_free
    return rmask & hit


def committed_write_frontier(cfg, batch: AccessBatch, inc: Incidence,
                             committed: torch.Tensor,
                             losers: torch.Tensor) -> torch.Tensor:
    """K13a: the invalidated-read frontier of transaction repair.  One
    launch: the committed rows' column OR of ``w1`` (and ``w2``) into
    per-bucket flags, then one thread per lane gathers its flags (family
    2 hashed in the kernel) and applies the loser / read / order_free
    mask."""
    if inc is None or inc.w1 is None:
        raise ValueError("the repair frontier needs the incidence's write "
                         "view (build_conflict_incidence adds it under "
                         "cfg.repair)")
    if kernels.on_cpu(batch.keys, committed, inc.w1):
        return committed_write_frontier_plain(cfg, batch, inc, committed,
                                              losers)
    b, a = batch.keys.shape
    k = inc.w1.shape[1]
    dev = batch.keys.device
    for name, t, dt in (("table_ids", batch.table_ids, torch.int32),
                        ("keys", batch.keys, torch.int32),
                        ("valid", batch.valid, torch.bool),
                        ("is_read", batch.is_read, torch.bool),
                        ("bucket1", inc.bucket1, torch.int32)):
        kernels.check(name, t, dt, (b, a), dev)
    kernels.check("committed", committed, torch.bool, (b,), dev)
    kernels.check("losers", losers, torch.bool, (b,), dev)
    kernels.check("w1", inc.w1, torch.bfloat16, (b, k), dev)
    two = inc.w2 is not None
    if two:
        kernels.check("w2", inc.w2, torch.bfloat16, (b, k), dev)
    if batch.order_free is not None:
        kernels.check("order_free", batch.order_free, torch.bool, (b, a),
                      dev)
    if k % 8 or k & (k - 1):
        raise ValueError("K13a reads 16-byte rows: K must be a power of "
                         "two and a multiple of 8")
    wrote = torch.zeros((2 if two else 1) * k, dtype=torch.uint8,
                        device=dev)
    out = torch.empty((b, a), dtype=torch.bool, device=dev)
    K13A_FRONTIER.launch(
        kernels.ptr(committed), kernels.ptr(inc.w1),
        kernels.ptr(inc.w2) if two else None, kernels.ptr(inc.bucket1),
        kernels.ptr(batch.table_ids), kernels.ptr(batch.keys),
        kernels.ptr(batch.valid), kernels.ptr(batch.is_read),
        kernels.ptr(losers),
        None if batch.order_free is None else kernels.ptr(batch.order_free),
        b, a, k, kernels.ptr(wrote), kernels.ptr(out),
        kernels.stream(batch.keys))
    return out
