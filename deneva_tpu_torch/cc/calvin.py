"""CALVIN and TPU_BATCH validation (port of ``deneva_tpu/cc/calvin.py``).

The epoch is the sequencer batch and ``rank`` the sequence number.  A
txn's level is its longest conflict chain through earlier-ranked txns
(K9a, `ops.conflict.wavefront`); the chained executor runs levels
as sub-rounds, and a chain deeper than ``exec_subrounds`` defers whole
to the next epoch.  Nothing aborts.

On YCSB, whose writes are blind, the engine takes the forwarding
executor instead under ``mode=NORMAL`` and never calls this function;
it validates under ``mode=SIMPLE`` and ``QRY_ONLY``, where the engine
then executes nothing (``deneva_tpu/engine/step.py:245-365``).  TPC-C
and PPS, whose writes read, run the chained executor over these levels
(`engine.step._run_levels`).
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.cc.base import (AccessBatch, Incidence, Verdict,
                                      get_overlap)
from deneva_tpu_torch.ops import conflict


def views(cfg) -> tuple[str, ...]:
    """The incidence views `validate_calvin` reads."""
    return ("uo", "w")


def validate_calvin(cfg, state, batch: AccessBatch, inc: Incidence):
    ov = get_overlap(cfg)
    # a pair conflicts iff it overlaps and one side is an ordered access
    # (uo aliases u when nothing is exempt)
    uo1 = inc.u1 if inc.uo1 is None else inc.uo1
    uo2 = inc.u2 if inc.uo2 is None else inc.uo2
    uw = ov(uo1, inc.w1, uo2, inc.w2)
    # the earlier edges of c = uw | uw.T, then their levels (K9a)
    lv, overflow = conflict.wavefront(uw, batch.rank, batch.active,
                                      max_level=cfg.exec_subrounds - 1)
    commit = batch.active & ~overflow
    v = Verdict(commit=commit, abort=torch.zeros_like(batch.active),
                defer=batch.active & overflow, order=batch.rank,
                level=torch.where(commit, lv, 0))
    return v, state


validate_tpu_batch = validate_calvin
