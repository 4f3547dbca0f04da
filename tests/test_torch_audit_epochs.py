"""Port parity of whole audited and metered epochs: ``deneva_tpu_torch``
against ``deneva_tpu`` from the same carried state, leaf by leaf.

* YCSB at ``tests/test_repair.py``'s shape (4,096 rows, 4 accesses,
  ``epoch_batch=128`` over a pool of 512, 1,024 conflict buckets, 1,024
  audit buckets, theta 0.9, 90% writes; one numpy zipf bank injected into
  both packages) with ``audit`` and ``metrics`` armed under OCC,
  TIMESTAMP, MVCC (version rings), CALVIN (forwarding visibility), DGCC
  (chained waves) and OCC with repair (salvage rounds as levels), at
  ``audit_cadence`` 1 and 8 (epochs on and off the cadence), and OCC with
  ``audit_mutate``.  The audit stamp tables, the ``audit_*`` counters and
  ``conflict_density`` are compared with every other leaf.
* TPC-C at 2 warehouses under TPU_BATCH (chained levels, escrow lanes
  excluded) and DGCC.
* The observation-only contract (``tests/test_audit.py::
  test_audit_observation_only_row_state``): armed and off runs of the
  port leave the same rows and verdict counters.
* ``convert`` of an armed MVCC state, rings included.
* ``run_simulation``'s ``mb_density_*`` and ``audit_*`` fields, read by
  the reference's ``parse_summary`` with the reference run's keys.

Rows a reference run wrote outside ``[0, capacity)`` — its trash rows,
carried across by ``convert`` — are not compared (as in
test_torch_timestamp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_engine import _inject
from test_torch_repair import ENGINE, zipf_bank
from test_torch_tpcc import tpcc_args

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.cc import AUDIT_KEY
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.workloads import get_workload

EPOCHS = 3
ARMED = ["--audit=true", "--metrics=true", "--audit_buckets=1024",
         "--watermark_buckets=64", "--mvcc_his_len=4"]


def assert_same_armed(js, ts) -> None:
    """Every leaf of both states; a table's rows [0, capacity) and a
    version ring's entries but its trash row's."""
    ref = convert.flatten_reference(jax.device_get(js))
    got = convert.to_numpy_state(ts)
    assert sorted(ref) == sorted(got)
    for path, want in ref.items():
        have = got[path]
        assert have.dtype == want.dtype and have.shape == want.shape, path
        entry = ts.db.get(path.split("/")[1]) if path.startswith("db/") \
            else None
        if hasattr(entry, "capacity") and have.ndim \
                and have.shape[0] > entry.capacity:
            have, want = have[:entry.capacity], want[:entry.capacity]
        elif hasattr(entry, "depth"):                 # a VersionRing
            have, want = have[:-entry.depth], want[:-entry.depth]
        np.testing.assert_array_equal(have, want, err_msg=path)


def run_both(args, bank=None, pre=EPOCHS, epochs=EPOCHS):
    """``pre`` reference epochs, then ``epochs`` in each package from the
    carried state; returns the port's summed counters."""
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    if bank is not None:
        _inject(jeng.workload, teng.workload, *bank)
    js = jax.device_get(jeng.jit_run(jeng.init_state(), pre))
    ts = convert.from_reference_state(js, tcfg, "cpu")
    js = jeng.jit_run(jax.tree.map(jnp.asarray, js), epochs)
    ts = teng.run(ts, epochs)
    assert_same_armed(js, ts)
    return {k: int(v.sum()) for k, v in ts.stats.items()}


@pytest.mark.parametrize("cadence", [1, 8])
@pytest.mark.parametrize("alg", ["OCC", "TIMESTAMP", "MVCC", "CALVIN",
                                 "DGCC"])
def test_ycsb_audited_epochs_match_reference(alg, cadence):
    # at cadence 8 the port runs epochs 6-8: two skipped, one audited
    st = run_both(ENGINE + ARMED + [f"--cc_alg={alg}",
                                    f"--audit_cadence={cadence}"],
                  zipf_bank(4096, 0.9), pre=3 if cadence == 1 else 6)
    assert st["conflict_density"] > 0 and st["audit_drop_cnt"] == 0
    if alg != "OCC":
        assert st["audit_edge_cnt"] > 0, st
    if alg in ("CALVIN", "DGCC"):
        assert st["audit_wit_cnt"] == 0      # no witnesses off the sweep


def test_ycsb_audited_repair_epochs_match_reference():
    """Salvaged txns observe the winners as a later level (``lvl =
    srounds``)."""
    st = run_both(ENGINE + ARMED + ["--cc_alg=OCC", "--audit_cadence=1",
                                    "--repair=true", "--repair_rounds=2"],
                  zipf_bank(4096, 0.9))
    assert st["rep_salvaged_cnt"] > 0 and st["audit_edge_cnt"] > 0


def test_ycsb_audit_mutate_epochs_match_reference():
    """OCC with ``audit_mutate`` on epochs 3 and 4: the flipped losers
    commit and execute in both packages alike, and the audit names
    claim-violating edges there."""
    args = ENGINE + ARMED + ["--cc_alg=OCC", "--audit_cadence=1"]
    clean = run_both(args, zipf_bank(4096, 0.9))
    bad = run_both(args + ["--audit_mutate=occ-read-skip:3:2"],
                   zipf_bank(4096, 0.9))
    assert bad["total_txn_commit_cnt"] > clean["total_txn_commit_cnt"]
    assert bad["audit_wit_cnt"] > clean["audit_wit_cnt"]


@pytest.mark.parametrize("alg", ["TPU_BATCH", "DGCC"])
def test_tpcc_audited_epochs_match_reference(alg):
    st = run_both(tpcc_args(cc_alg=alg, audit="true", metrics="true",
                            audit_cadence=1, audit_buckets=1024))
    assert st["audit_edge_cnt"] > 0 and st["conflict_density"] > 0


@pytest.mark.parametrize("alg", ["OCC", "CALVIN"])
def test_audit_is_observation_only(alg):
    """Armed and off runs of the port: the same rows, pool and verdict
    counters; the off run's audit counters never move."""
    runs = []
    for armed in (False, True):
        cfg = Config.from_args(ENGINE + [
            f"--cc_alg={alg}", f"--audit={armed}", "--audit_cadence=1",
            "--audit_buckets=1024"])
        eng = Engine(cfg, get_workload(cfg, device="cpu"))
        _inject(_Sink(), eng.workload, *zipf_bank(4096, 0.9))
        runs.append(convert.to_numpy_state(eng.run(eng.init_state(), 4)))
    off, on = runs
    assert off["stats/audit_edge_cnt"] == 0 < on["stats/audit_edge_cnt"]
    for path, want in off.items():
        if not path.startswith("stats/audit_"):
            np.testing.assert_array_equal(on[path], want, err_msg=path)
    assert sorted(set(on) - set(off)) == [f"db/{AUDIT_KEY}/epoch",
                                          f"db/{AUDIT_KEY}/writer"]


class _Sink:
    """A stand-in for the reference workload `_inject` also patches."""


def test_armed_mvcc_state_converts():
    """An armed MVCC state — stamp tables and version rings with writes in
    them — crosses into the port and back unchanged."""
    args = ENGINE + ARMED + ["--cc_alg=MVCC", "--audit_cadence=1"]
    jcfg = JConfig.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    js = jax.device_get(jeng.jit_run(jeng.init_state(), 3))
    assert int(np.asarray(js.db[AUDIT_KEY]["vpos"]).max()) > 0
    ts = convert.from_reference_state(js, Config.from_args(args), "cpu")
    ref, got = convert.flatten_reference(js), convert.to_numpy_state(ts)
    assert sorted(ref) == sorted(got)
    assert f"db/{AUDIT_KEY}/vts" in got
    for path, want in ref.items():
        np.testing.assert_array_equal(got[path], want, err_msg=path)


# -- the driver's [summary] fields ---------------------------------------------------

@pytest.mark.parametrize("alg", ["OCC", "CALVIN"])
def test_armed_summary_fields_match_reference_keys(alg):
    """``run_simulation`` under ``audit`` and ``metrics``: the reference's
    ``parse_summary`` reads the port's line, whose keys are the reference
    run's; the ``mb_density_*`` and ``audit_*`` fields appear only armed."""
    from deneva_tpu.engine.driver import run_simulation as j_run
    from deneva_tpu.stats import parse_summary as j_parse
    from deneva_tpu_torch.engine.driver import run_simulation
    args = ENGINE + [f"--cc_alg={alg}", "--warmup_secs=0",
                     "--done_secs=0.05", "--prog_timer_secs=0",
                     "--chunk_target_secs=0.000001"]
    armed = args + ["--audit=true", "--audit_cadence=1", "--metrics=true",
                    "--audit_buckets=1024"]
    line = run_simulation(Config.from_args(armed), device="cpu", chunk=1,
                          quiet=True).summary_line()
    got = j_parse(line)
    want = j_parse(j_run(JConfig.from_args(armed), chunk=1,
                         quiet=True).summary_line())
    assert sorted(got) == sorted(want)
    assert got["mb_density_total"] == got["mb_density_p0"] > 0
    assert got["audit_edge_cnt"] >= got["audit_drop_cnt"] == 0
    off = j_parse(run_simulation(Config.from_args(args), device="cpu",
                                 chunk=1, quiet=True).summary_line())
    assert not any(k.startswith(("mb_", "audit_")) for k in off)
