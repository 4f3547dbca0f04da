"""Concurrency control as batched epoch validation.

The registry of ``deneva_tpu/cc/__init__.py``, one backend per reference
algorithm, with the reference's flags.  The port registers:

* TPU_BATCH — on YCSB the forwarding executor (``forward=True``): the
  sort is the validation, so it needs no validate function here;
* OCC — Kung-Robinson validation through the incidence sweep;
* NOCC — the oracle that commits every active txn.

The other algorithms come with ROADMAP.md queue 1, items 13, 14 and 16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from deneva_tpu_torch.cc import occ as _occ
from deneva_tpu_torch.cc.base import (AccessBatch, Incidence,  # noqa: F401
                                      Verdict, build_conflict_incidence,
                                      build_incidence, gate_order_free)
from deneva_tpu_torch.cc.nocc import validate_nocc
from deneva_tpu_torch.cc.occ import validate_occ
from deneva_tpu_torch.config import CCAlg


@dataclass(frozen=True)
class CCBackend:
    alg: CCAlg
    validate: Callable[..., tuple[Verdict, Any]] | None
    needs_incidence: bool = True
    chained: bool = False
    fresh_ts_on_restart: bool = True
    # single-pass forwarding executor on blind-write workloads
    forward: bool = False
    exempt_order_free: bool = False
    repair_rule: Any = None
    # the incidence views ``validate`` reads (the reference leaves the
    # others to XLA's dead-code elimination; the port builds only these)
    views: tuple[str, ...] = ()


_REGISTRY: dict[CCAlg, CCBackend] = {
    CCAlg.NOCC: CCBackend(CCAlg.NOCC, validate_nocc, needs_incidence=False),
    CCAlg.OCC: CCBackend(CCAlg.OCC, validate_occ, exempt_order_free=True,
                         repair_rule=_occ.repair_frontier, views=_occ.VIEWS),
    CCAlg.TPU_BATCH: CCBackend(CCAlg.TPU_BATCH, None, chained=True,
                               forward=True, exempt_order_free=True),
}


def get_backend(alg: CCAlg | str) -> CCBackend:
    alg = CCAlg(alg)
    if alg not in _REGISTRY:
        raise NotImplementedError(
            f"cc_alg={alg.value} is not ported to deneva_tpu_torch yet "
            "(ROADMAP.md queue 1, items 13, 14 and 16)")
    return _REGISTRY[alg]
