"""OCC — Kung-Robinson backward validation (port of ``deneva_tpu/cc/occ.py``).

Every txn of an epoch read the epoch-start snapshot, so validation
against earlier epochs passes vacuously.  Within the epoch, serial
validation in rank order admits txn i iff no already-admitted j has
``W_j ∩ (R_i ∪ W_i) ≠ ∅``: the lex-first maximal-independent-set sweep
(K8) over the directed union-vs-write overlap (K7).  With an escrow
exemption the union is the ordered one (``uo``); YCSB declares none, so
``uo`` aliases ``u``.
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.cc import base
from deneva_tpu_torch.cc.base import (AccessBatch, Incidence, Verdict,
                                      get_overlap)
from deneva_tpu_torch.ops import conflict


def views(cfg) -> tuple[str, ...]:
    """The incidence views `validate_occ` reads."""
    return ("uo", "w")


def repair_frontier(cfg, state, batch, inc, committed, losers):
    """OCC's transaction-repair rule (``deneva_tpu/cc/occ.py:43``): the
    loser's ordered reads of a bucket a committed txn wrote (K13a).  The
    repair sub-round then re-runs `validate_occ` on the losers."""
    return base.committed_write_frontier(cfg, batch, inc, committed,
                                         losers)


def validate_occ(cfg, state, batch: AccessBatch, inc: Incidence):
    ov = get_overlap(cfg)
    uo1 = inc.u1 if inc.uo1 is None else inc.uo1
    uo2 = inc.u2 if inc.uo1 is None else inc.uo2
    uw = ov(uo1, inc.w1, uo2, inc.w2)
    win, lose, und = conflict.first_fit(uw, batch.rank, batch.active,
                                        cfg.sweep_rounds)
    v = Verdict(commit=win, abort=lose, defer=und, order=batch.rank,
                level=torch.zeros_like(batch.rank))
    return v, state
