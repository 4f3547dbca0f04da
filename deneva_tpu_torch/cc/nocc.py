"""NOCC oracle mode (port of ``deneva_tpu/cc/nocc.py``; reference ``NOCC_MODE``).

Every active txn commits; no conflict matrices are built.  Duplicate
committed writes still resolve to the last writer by rank (K10 in the
executor), so results are deterministic.
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.cc.base import AccessBatch, Verdict


def validate_nocc(cfg, state, batch: AccessBatch, inc=None):
    z = torch.zeros_like(batch.active)
    v = Verdict(commit=batch.active, abort=z, defer=z, order=batch.rank,
                level=torch.zeros_like(batch.rank))
    return v, state
