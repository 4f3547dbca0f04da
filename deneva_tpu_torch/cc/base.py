"""CC backend interface: batched epoch validation (port of ``deneva_tpu/cc/base.py``).

An algorithm is a pure function over one epoch's planned accesses,
``validate(cfg, state, batch, incidence) -> (Verdict, state)``.  The
port carries the records, the incidence construction of the sweep backends
and the ``get_overlap`` seam; the repair, audit and density planes come
with ROADMAP.md queue 1, item 16.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deneva_tpu_torch.ops import conflict


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
