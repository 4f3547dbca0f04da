"""Port parity of whole repair epochs: ``deneva_tpu_torch`` against
``deneva_tpu`` from the same carried state, leaf by leaf.

* YCSB at ``tests/test_repair.py``'s ``ycsb_cfg`` shape (4,096 rows, 4
  accesses, ``epoch_batch=128`` over a pool of 512, 1,024 buckets,
  theta 0.9, 90% writes) under the six sweep backends at
  ``repair_rounds`` 0, 1 and 2.  Queries come from one numpy zipf bank
  injected into both packages (the zipf power differs by an ulp between
  XLA and the port, see test_torch_sampling.py).  Three reference epochs
  first, then three in each package; rows ``[0, capacity)`` of the table
  and every other leaf — cc state, pool, rng, counters — are equal (the
  trash row, where masked writes land in an order neither framework
  defines, and the version ring's trash row are excluded as in
  test_torch_timestamp.py).
TPC-C's repair epochs are in test_torch_repair_tpcc.py.  Every run
checks the counter contract of ``deneva_tpu/engine/repair.py``:
without ``ycsb_abort_mode``, aborts equal ``rep_fallback_cnt``.
"""

import jax
import jax.numpy as jnp
import pytest
from test_torch_engine import _inject
from test_torch_repair import ENGINE, zipf_bank
from test_torch_timestamp import _assert_same

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.workloads import get_workload, ycsb

EPOCHS = 3
SWEEP_ALGS = ("NO_WAIT", "WAIT_DIE", "OCC", "TIMESTAMP", "MVCC", "MAAT")


def run_both(args, bank=None, check=None):
    """``EPOCHS`` reference epochs, then ``EPOCHS`` in each package from
    the carried state, compared by ``check`` (YCSB's leaf-by-leaf compare
    when None); returns the port's counters."""
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    if bank is not None:
        _inject(jeng.workload, teng.workload, *bank)
    js = jax.device_get(jeng.jit_run(jeng.init_state(), EPOCHS))
    ts = convert.from_reference_state(js, tcfg, "cpu")
    mid = js
    js = jeng.jit_run(jax.tree.map(jnp.asarray, js), EPOCHS)
    ts = teng.run(ts, EPOCHS)
    if check is None:
        ring = ts.db.get(ycsb.VER_TABLE)
        trash = None if ring is None \
            else mid.db[ycsb.VER_TABLE].wts[-ring.depth:]
        _assert_same(js, ts, tcfg, trash)
    else:
        check(js, ts)
    st = {k: int(v.sum()) for k, v in ts.stats.items()}
    assert st["total_txn_abort_cnt"] == st["rep_fallback_cnt"]
    return st


@pytest.mark.parametrize("rounds", [0, 1, 2])
@pytest.mark.parametrize("alg", SWEEP_ALGS)
def test_ycsb_repair_epochs_match_reference(alg, rounds):
    args = ENGINE + [f"--cc_alg={alg}", "--repair=true",
                     f"--repair_rounds={rounds}", "--watermark_buckets=64",
                     "--mvcc_his_len=4"]
    st = run_both(args, zipf_bank(4096, 0.9))
    assert st["total_txn_commit_cnt"] > 0
    if rounds == 0:
        assert st["rep_salvaged_cnt"] == 0 == st["rep_frontier_cnt"]
    elif alg != "MAAT":
        # MAAT's 90%-blind-write epochs have no loser to salvage
        assert st["rep_salvaged_cnt"] > 0, st


def test_ycsb_nolock_repair_epochs_match_reference():
    """NO_WAIT under NOLOCK validates without incidence views; under
    repair the port still builds ``w`` for the frontier (ROADMAP.md watch
    item 25), and its epochs equal the reference's."""
    args = ENGINE + ["--cc_alg=NO_WAIT", "--isolation_level=NOLOCK",
                     "--repair=true", "--repair_rounds=2"]
    st = run_both(args, zipf_bank(4096, 0.9))
    assert st["total_txn_commit_cnt"] > 0 and st["rep_fallback_cnt"] == 0
