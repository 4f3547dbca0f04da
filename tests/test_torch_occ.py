"""Port parity of the sweep path: 5 epochs of ``deneva_tpu_torch`` against
``deneva_tpu`` from the same state, leaf by leaf.

Config: YCSB over a partial pool (``max_txn_in_flight = 256``,
``epoch_batch = 64``), 4096 rows and ``conflict_buckets = 256`` so that
bucket collisions occur, dual hashing on, 10 requests per txn, 50%
writes, theta 0.9 with queries injected into both workload instances
from one numpy-seeded bank (see test_torch_engine.py).  Cases: OCC and
NOCC in fingerprint and full-row mode, with and without the forced
sentinel aborts of ``ycsb_abort_mode``, and TPU_BATCH forwarding over the
same partial pool.

Table rows ``[0, capacity)`` are compared; the trash row at
``capacity`` is not: the masked scatter steers losers' writes there with
duplicate slots, in an order XLA and torch each leave unspecified.  The
padded rows past the trash are checked untouched in the port (the
reference's forwarding scatter writes one, see test_torch_engine.py).
Every other leaf — pool, rng, epoch, every counter mod 2^32 — is equal.
"""

import jax
import numpy as np
import pytest
from test_torch_engine import _inject

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.workloads import get_workload

EPOCHS = 5
BATCH = 64
BASE = ["--epoch_batch=64", "--max_txn_in_flight=256",
        "--synth_table_size=4096", "--conflict_buckets=256",
        "--conflict_exact=true", "--req_per_query=10", "--write_perc=0.5",
        "--read_perc=0.5", "--zipf_theta=0.9", "--field_per_tuple=10",
        "--tup_size=100", "--seed=5"]


def _assert_same(jstate, tstate, capacity):
    ref = convert.flatten_reference(jax.device_get(jstate))
    got = convert.to_numpy_state(tstate)
    assert sorted(ref) == sorted(got)
    for path, want in ref.items():
        have = got[path]
        assert have.dtype == want.dtype and have.shape == want.shape, path
        if path.startswith("db/") and have.ndim >= 1 \
                and have.shape[0] > capacity:
            np.testing.assert_array_equal(have[:capacity], want[:capacity],
                                          err_msg=path)
            assert not have[capacity + 1:].any(), path   # padded rows
        else:
            np.testing.assert_array_equal(have, want, err_msg=path)


def _bank(n_rows, epochs=4, n=256, r=10, seed=17, write_perc=0.5):
    """Skewed numpy queries, milder than test_torch_engine's: key =
    n_rows * u^3, so an OCC epoch commits, aborts and defers."""
    rng = np.random.default_rng(seed)
    keys = np.minimum(n_rows * rng.random((epochs, n, r)) ** 3,
                      n_rows - 1).astype(np.int32)
    return keys, rng.random((epochs, n, r)) < write_perc


def _run(args):
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    assert not teng.pool.full_pool
    keys, is_w = _bank(tcfg.synth_table_size)
    _inject(jeng.workload, teng.workload, keys, is_w)
    js = jeng.init_state()
    ts = convert.from_reference_state(jax.device_get(js), tcfg, "cpu")
    js = jeng.jit_run(js, EPOCHS)
    ts = teng.run(ts, EPOCHS)
    _assert_same(js, ts, tcfg.synth_table_size)
    return {k: int(v.sum()) for k, v in ts.stats.items()}


@pytest.mark.parametrize("full,abort_mode,extra", [
    (False, False, []), (True, False, []), (False, True, []),
    (True, True, []),
    # the defer budget: a txn deferred twice running force-aborts
    (False, False, ["--sweep_rounds=1", "--defer_rounds_max=1"])])
def test_occ_epochs_match_reference(full, abort_mode, extra):
    st = _run(BASE + ["--cc_alg=OCC", "--sweep_rounds=3",
                      f"--sim_full_row={full}",
                      f"--ycsb_abort_mode={abort_mode}"] + extra)
    # the abort, backoff and defer paths are really held
    assert st["total_txn_commit_cnt"] > 0
    assert st["total_txn_abort_cnt"] > 0 and st["defer_cnt"] > 0
    assert st["unique_txn_abort_cnt"] > 0


@pytest.mark.parametrize("full,abort_mode", [(False, False), (True, True)])
def test_nocc_epochs_match_reference(full, abort_mode):
    st = _run(BASE + ["--cc_alg=NOCC", f"--sim_full_row={full}",
                      f"--ycsb_abort_mode={abort_mode}"])
    # every selected txn completes: a commit, or a forced abort
    assert st["defer_cnt"] == 0
    assert st["total_txn_commit_cnt"] + st["total_txn_abort_cnt"] \
        == BATCH * EPOCHS
    assert (st["total_txn_abort_cnt"] > 0) == abort_mode


def test_nocc_mode_over_tpu_batch_matches_reference():
    st = _run(BASE + ["--cc_alg=TPU_BATCH", "--mode=NOCC"])
    assert st["total_txn_commit_cnt"] == BATCH * EPOCHS


def test_forwarding_over_partial_pool_matches_reference():
    st = _run(BASE + ["--cc_alg=TPU_BATCH"])
    assert st["total_txn_commit_cnt"] == BATCH * EPOCHS
    assert st["total_txn_abort_cnt"] == 0


def test_calvin_epochs_match_reference():
    """CALVIN takes the forwarding executor on YCSB, as TPU_BATCH does."""
    st = _run(BASE + ["--cc_alg=CALVIN"])
    assert st["total_txn_commit_cnt"] == BATCH * EPOCHS
    assert st["total_txn_abort_cnt"] == 0


def test_calvin_chained_path_raises_on_reads_feeding_writes():
    """A workload whose reads feed its writes sends CALVIN to the chained
    executor.  The port used to raise there; it now has the executor
    (``engine.step._run_levels``), so such a YCSB workload's epochs run
    level by level and match the reference's chained epochs."""
    from deneva_tpu.workloads.ycsb import YCSBWorkload as JYCSB
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload

    class NotBlind(YCSBWorkload):
        blind_writes = False

    class JNotBlind(JYCSB):
        blind_writes = False
    args = BASE + ["--cc_alg=CALVIN"]
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, JNotBlind(jcfg))
    teng = Engine(tcfg, NotBlind(tcfg, device="cpu"))
    keys, is_w = _bank(tcfg.synth_table_size)
    _inject(jeng.workload, teng.workload, keys, is_w)
    js = jeng.init_state()
    ts = convert.from_reference_state(jax.device_get(js), tcfg, "cpu")
    js = jeng.jit_run(js, EPOCHS)
    ts = teng.run(ts, EPOCHS)
    _assert_same(js, ts, tcfg.synth_table_size)
    assert int(ts.stats["total_txn_abort_cnt"]) == 0
    assert int(ts.stats["total_txn_commit_cnt"]) > 0
    assert int(ts.stats["defer_cnt"]) > 0
