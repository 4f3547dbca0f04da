"""Port parity of whole DGCC epochs and of the driver's repair and DGCC
lines: ``deneva_tpu_torch`` against ``deneva_tpu`` on the CPU, exactly.

* Whole epochs leaf by leaf (`run_both` of test_torch_repair_epochs.py):
  YCSB at theta 0.6, 0.9 and 0.99 (4,096 rows, 4 accesses, ``epoch_batch
  =128`` over a pool of 512, 90% writes, one numpy zipf bank injected
  into both packages) and TPC-C at 2 warehouses.  At theta 0.9 an epoch
  commits a wave >= 4, which the chained executor runs only because DGCC
  takes ``dgcc_levels`` passes (ROADMAP.md watch item 24).
* The conversion of a DGCC state with non-zero ``dgcc_*`` counters.
* ``run_simulation``'s ``[summary]`` fields and ``[dgcc]`` line under
  DGCC and under repair, read by the reference's parsers, and the
  default line without either family.
"""

import dataclasses

import jax
import numpy as np
import pytest
from test_torch_repair import zipf_bank
from test_torch_repair_epochs import run_both
from test_torch_tpcc import tpcc_args
from test_torch_tpcc_epochs import assert_same_state

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.harness import parse as jparse
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.cc import dgcc
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.driver import run_simulation
from deneva_tpu_torch.stats import parse_summary

# -- whole epochs ---------------------------------------------------------------

YCSB = ["--synth_table_size=4096", "--req_per_query=4", "--max_accesses=4",
        "--epoch_batch=128", "--max_txn_in_flight=512", "--read_perc=0.1",
        "--write_perc=0.9", "--seed=5", "--cc_alg=DGCC"]


def _waves(monkeypatch):
    """Each epoch's committed waves, read off the port's DGCC verdicts."""
    from deneva_tpu_torch import cc
    seen = []
    be = cc.get_backend("DGCC")

    def counted(cfg, state, batch, inc=None, stats=None):
        v, st = dgcc.validate_dgcc(cfg, state, batch, inc, stats)
        lv = v.level[v.commit]
        seen.append(int(lv.max()) + 1 if lv.numel() else 0)
        return v, st
    monkeypatch.setitem(cc._REGISTRY, be.alg,
                        dataclasses.replace(be, validate=counted))
    return seen


@pytest.mark.parametrize("theta", [0.6, 0.9, 0.99])
def test_ycsb_dgcc_epochs_match_reference(theta, monkeypatch):
    waves = _waves(monkeypatch)
    st = run_both(YCSB + [f"--zipf_theta={theta}"],
                  zipf_bank(4096, theta))
    assert st["total_txn_abort_cnt"] == 0 and st["total_txn_commit_cnt"] > 0
    assert st["dgcc_edge_cnt"] > 0 and len(waves) == 3
    assert st["dgcc_wave_max"] >= max(waves)
    if theta == 0.9:
        # a wave above exec_subrounds committed and executed
        assert max(waves) >= 5, waves


def test_tpcc_dgcc_epochs_match_reference():
    st = run_both(tpcc_args(cc_alg="DGCC"), check=assert_same_state)
    assert st["total_txn_abort_cnt"] == 0 and st["dgcc_wave_max"] > 1


def test_dgcc_state_converts():
    """A DGCC engine state (cc state ``()``) and its non-zero ``dgcc_*``
    counters cross into the port and back unchanged."""
    args = YCSB + ["--zipf_theta=0.9"]
    jcfg = JConfig.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    js = jax.device_get(jeng.jit_run(jeng.init_state(), 2))
    assert js.cc_state == () and int(js.stats["dgcc_wave_cnt"]) > 0
    ts = convert.from_reference_state(js, Config.from_args(args), "cpu")
    assert ts.cc_state == ()
    ref, got = convert.flatten_reference(js), convert.to_numpy_state(ts)
    assert sorted(ref) == sorted(got)
    for path, want in ref.items():
        np.testing.assert_array_equal(got[path], want, err_msg=path)


# -- the driver's lines ---------------------------------------------------------

RUN = ["--warmup_secs=0", "--done_secs=0.3", "--prog_timer_secs=0"]


def test_dgcc_simulation_prints_the_dgcc_line(capsys):
    cfg = Config.from_args(YCSB + RUN + ["--zipf_theta=0.9"])
    st = run_simulation(cfg, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == st.summary_line()
    rows = jparse.parse_dgcc(lines)
    assert len(rows) == 1 and rows[0]["node"] == 0
    f = jparse.parse_summary(lines[-1])
    assert f == parse_summary(lines[-1])
    assert rows[0]["waves"] == f["dgcc_wave_cnt"] > 0
    assert rows[0]["wave_max"] == f["dgcc_wave_max"] > 1
    assert rows[0]["fallback"] == f["dgcc_fallback_cnt"]
    assert rows[0]["edges"] == f["dgcc_edge_cnt"] > 0
    assert f["total_txn_abort_cnt"] == 0


def test_repair_simulation_prints_the_rep_fields(capsys):
    cfg = Config.from_args(YCSB[:-1] + RUN + [
        "--zipf_theta=0.9", "--cc_alg=OCC", "--repair=true"])
    st = run_simulation(cfg, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == st.summary_line()
    assert jparse.parse_dgcc(lines) == []
    f = jparse.parse_summary(lines[-1])
    assert f["rep_salvaged_cnt"] > 0 and f["rep_frontier_cnt"] >= 0
    assert f["rep_fallback_cnt"] == f["total_txn_abort_cnt"]
    assert not any(k.startswith("dgcc_") for k in f)


def test_default_line_has_no_repair_or_dgcc_fields(capsys):
    cfg = Config.from_args(YCSB[:-1] + RUN + ["--cc_alg=OCC"])
    st = run_simulation(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "[dgcc]" not in out
    assert not any(k.startswith(("rep_", "dgcc_"))
                   for k in st.summary_fields())


