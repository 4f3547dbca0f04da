"""Port parity of whole TPC-C epochs: 5 epochs of ``deneva_tpu_torch``
against ``deneva_tpu`` from the same state, leaf by leaf (every table's
rows ``[0, capacity)`` and ``row_cnt``, the pool with its ``TPCCQuery``,
the cc state, rng, epoch and every counter), at ``tests/test_tpcc.py``'s
sizes, under all eight algorithms and NOCC:

* TPU_BATCH and CALVIN through the chained executor, at a contention
  where committed levels above 0 and overflow defers occur;
* NO_WAIT, WAIT_DIE, OCC (escrow on and off), TIMESTAMP, MVCC and MAAT
  through the sweep path, whose stock winners go through K10;
* perc_payment 0, 0.5 and 1, the full schema, the by-last-name bypass,
  and an ``insert_table_cap`` whose rings wrap inside the run.

The port's own ``init_state`` equals the reference's; the run starts
from the reference's state carried by ``convert``.
"""

import dataclasses

import jax
import numpy as np
import pytest
from test_torch_tpcc import assert_same_db, tpcc_args

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.workloads import get_workload

EPOCHS = 5


def assert_same_state(jstate, tstate) -> None:
    jstate = jax.device_get(jstate)
    assert_same_db(jstate.db, tstate.db)
    ref = convert.flatten_reference(jstate)
    got = convert.to_numpy_state(tstate)
    assert sorted(ref) == sorted(got)
    for path, want in ref.items():
        if path.startswith("db/"):
            continue
        have = got[path]
        assert have.dtype == want.dtype and have.shape == want.shape, path
        np.testing.assert_array_equal(have, want, err_msg=path)


def _record_levels(eng) -> list:
    """Wrap the engine's validate to keep each epoch's deepest committed
    level."""
    seen = []
    be = eng.backend

    def validate(cfg, state, batch, inc):
        v, st = be.validate(cfg, state, batch, inc)
        lv = v.level[v.commit]
        seen.append(int(lv.max()) if lv.numel() else 0)
        return v, st
    eng.backend = dataclasses.replace(be, validate=validate)
    return seen


CASES = [
    ("TPU_BATCH", dict(num_wh=1)),
    ("CALVIN", dict(num_wh=1, perc_payment=0.3)),
    ("NO_WAIT", {}),
    ("WAIT_DIE", {}),
    ("OCC", {}),
    ("OCC", dict(escrow_sweep=False)),
    ("TIMESTAMP", {}),
    ("MVCC", {}),
    ("MAAT", {}),
    ("NOCC", {}),
    ("TPU_BATCH", dict(perc_payment=0, tpcc_full_schema=True,
                       insert_table_cap=128)),
    ("NO_WAIT", dict(perc_payment=1)),
    ("TPU_BATCH", dict(perc_payment=1, tpcc_by_last_index=False)),
]


@pytest.mark.parametrize("alg,kw", CASES, ids=[
    "-".join([a] + [f"{k}={v}" for k, v in kw.items()]) for a, kw in CASES])
def test_epochs_match_reference(alg, kw):
    args = tpcc_args(cc_alg=alg, **kw)
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    js = jeng.init_state()
    assert_same_state(js, teng.init_state())
    ts = convert.from_reference_state(jax.device_get(js), tcfg, "cpu")
    levels = _record_levels(teng)
    js = jeng.jit_run(js, EPOCHS)
    ts = teng.run(ts, EPOCHS)
    assert_same_state(js, ts)
    st = {k: int(v.sum()) for k, v in ts.stats.items()}
    assert st["total_txn_commit_cnt"] > 0
    if alg in ("TPU_BATCH", "CALVIN"):
        assert st["total_txn_abort_cnt"] == 0
    if alg in ("TPU_BATCH", "CALVIN") and "perc_payment" not in kw \
            or alg == "CALVIN":
        # the chained executor ran passes above level 0, and chains
        # deeper than exec_subrounds deferred
        assert max(levels) >= 1 and st["defer_cnt"] > 0, (levels, st)
    if "insert_table_cap" in kw:
        assert int(ts.db["ORDER"].row_cnt) > tcfg.insert_table_cap
