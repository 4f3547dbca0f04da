"""Concurrency control as batched epoch validation.

The registry of ``deneva_tpu/cc/__init__.py``, one backend per reference
algorithm, with the reference's flags.  The port registers:

* TPU_BATCH and CALVIN — on YCSB the forwarding executor
  (``forward=True``): the sort is the validation; under ``mode=SIMPLE``
  and ``QRY_ONLY``, and on TPC-C and PPS (whose writes read, run by the
  chained executor), the wavefront levels of `validate_calvin`;
* OCC — Kung-Robinson validation through the incidence sweep;
* NO_WAIT, WAIT_DIE — 2PL through the same sweep, at four isolation
  levels;
* TIMESTAMP, MVCC — T/O watermarks carried across epochs, with the
  later-reader sweep;
* MAAT — reader-before-writer precedence: the mutual-pair sweep, the
  level gate, and the closure and peel where the gate is set;
* DGCC — the dependency-graph wavefront: the lane sort (K15a), its
  census (K15b) and the wave relaxation (K16) assign each txn a wave,
  which the chained executor runs (no incidence views);
* NOCC — the oracle that commits every active txn.

The six sweep backends carry a ``repair_rule``, the invalidated-read
frontier of transaction repair (`engine.repair`).  The metrics plane's
`conflict_density` and the audit plane's `audit_init`, `audit_observe`
and `audit_mutate_verdict` (`cc.base`) are exported here, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from deneva_tpu_torch.cc import calvin as _calvin
from deneva_tpu_torch.cc import dgcc as _dgcc
from deneva_tpu_torch.cc import maat as _maat
from deneva_tpu_torch.cc import occ as _occ
from deneva_tpu_torch.cc import timestamp as _ts
from deneva_tpu_torch.cc import twopl as _twopl
from deneva_tpu_torch.cc.base import (AUDIT_KEY, AUDIT_RW,  # noqa: F401
                                      AUDIT_WR, AUDIT_WW, AccessBatch,
                                      Incidence, Verdict, audit_init,
                                      audit_levels, audit_mutate_verdict,
                                      audit_observe,
                                      build_conflict_incidence,
                                      build_incidence, conflict_density,
                                      gate_order_free)
from deneva_tpu_torch.cc.nocc import validate_nocc
from deneva_tpu_torch.cc.occ import validate_occ
from deneva_tpu_torch.config import CCAlg


def _no_state(cfg, device):
    return ()


def _no_views(cfg) -> tuple[str, ...]:
    return ()


@dataclass(frozen=True)
class CCBackend:
    alg: CCAlg
    validate: Callable[..., tuple[Verdict, Any]]
    # (cfg, device) -> the cross-epoch state validate carries
    init_state: Callable[[Any, Any], Any] = _no_state
    chained: bool = False
    fresh_ts_on_restart: bool = True
    # single-pass forwarding executor on blind-write workloads
    forward: bool = False
    exempt_order_free: bool = False
    # the reference's distributed VOTE hook: cross-epoch state for a
    # globally decided commit set (None = stateless)
    commit_state: Any = None
    repair_rule: Any = None
    # cfg -> the incidence views ``validate`` reads (the reference leaves
    # the others to XLA's dead-code elimination; the port builds only
    # these, and no incidence at all when there are none, as for NOCC)
    views: Callable[[Any], tuple[str, ...]] = _no_views


_REGISTRY: dict[CCAlg, CCBackend] = {
    CCAlg.NOCC: CCBackend(CCAlg.NOCC, validate_nocc),
    CCAlg.NO_WAIT: CCBackend(CCAlg.NO_WAIT, _twopl.validate_no_wait,
                             exempt_order_free=True,
                             repair_rule=_twopl.repair_frontier,
                             views=_twopl.views),
    CCAlg.WAIT_DIE: CCBackend(CCAlg.WAIT_DIE, _twopl.validate_wait_die,
                              fresh_ts_on_restart=False,
                              exempt_order_free=True,
                              repair_rule=_twopl.repair_frontier,
                              views=_twopl.views),
    CCAlg.OCC: CCBackend(CCAlg.OCC, validate_occ, exempt_order_free=True,
                         repair_rule=_occ.repair_frontier, views=_occ.views),
    CCAlg.TIMESTAMP: CCBackend(CCAlg.TIMESTAMP, _ts.validate_timestamp,
                               _ts.init_to_state,
                               commit_state=_ts.commit_to_state,
                               exempt_order_free=True,
                               repair_rule=_ts.repair_frontier_timestamp,
                               views=_ts.views),
    CCAlg.MVCC: CCBackend(CCAlg.MVCC, _ts.validate_mvcc, _ts.init_mvcc_state,
                          commit_state=_ts.commit_to_state,
                          exempt_order_free=True,
                          repair_rule=_ts.repair_frontier_mvcc,
                          views=_ts.views),
    CCAlg.MAAT: CCBackend(CCAlg.MAAT, _maat.validate_maat,
                          exempt_order_free=True,
                          repair_rule=_maat.repair_frontier,
                          views=_maat.views),
    CCAlg.CALVIN: CCBackend(CCAlg.CALVIN, _calvin.validate_calvin,
                            chained=True, forward=True,
                            exempt_order_free=True, views=_calvin.views),
    CCAlg.TPU_BATCH: CCBackend(CCAlg.TPU_BATCH, _calvin.validate_tpu_batch,
                               chained=True, forward=True,
                               exempt_order_free=True,
                               views=_calvin.views),
    # the exact-key lane graph needs no hashed incidence; the waves run
    # through the chained executor with the last-writer tournament
    CCAlg.DGCC: CCBackend(CCAlg.DGCC, _dgcc.validate_dgcc, chained=True,
                          exempt_order_free=True),
}


def get_backend(alg: CCAlg | str) -> CCBackend:
    return _REGISTRY[CCAlg(alg)]
