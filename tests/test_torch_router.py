"""The contention router and its control plane in the port, against
``deneva_tpu``:

* `cross_group_defer_plain` (K21's plain version) against the
  reference's einsums on seeded incidences, G = 3 and 4, and the glue:
  `coarsen_keys`, `txn_backend`, `static_knobs`, `candidate_index`;
* the controller copy's decisions against the reference `Controller` on
  scripted signal streams, ``[ctrl]`` lines through the port's
  `parse_ctrl` and `replay_decisions`;
* routed epochs with `static_knobs` equal to the port's unrouted epochs,
  leaf by leaf;
* routed epochs against the reference's ``jit_run_ctrl`` at
  ``part_cnt = 4``: every uniform branch, the mixed branch (with
  ``repair_cap`` and ``audit_cadence`` knobs and coarsened keys) and
  ``ctrl_dgcc``'s DGCC branch and four-group mixed branch, on YCSB and
  TPC-C;
* ``run_simulation`` with ``ctrl`` armed: its ``[ctrl]`` lines parse and
  replay, and the summary carries ``ctrl_decisions``.

Trash rows follow test_torch_partitions.py's rule.
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_partitions import assert_same, carried, engines

from deneva_tpu.cc import base as jbase
from deneva_tpu.cc import router as jr
from deneva_tpu.config import Config as JConfig
from deneva_tpu.runtime import controller as jctl
from deneva_tpu_torch import convert
from deneva_tpu_torch.cc import base as tbase
from deneva_tpu_torch.cc import router as tr
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.driver import run_simulation
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.runtime import controller as tctl
from deneva_tpu_torch.stats import parse_ctrl
from deneva_tpu_torch.workloads import get_workload

# tests/test_ctrl.py's ctl_cfg at part_cnt = 4, over a keyspace the bucket
# space covers and a mild skew, so the mixed branch commits most txns
CTRL = ["--synth_table_size=16384", "--part_cnt=4", "--req_per_query=4",
        "--max_accesses=4", "--epoch_batch=128", "--max_txn_in_flight=512",
        "--conflict_buckets=16384", "--zipf_theta=0.6", "--read_perc=0.5",
        "--write_perc=0.5", "--cc_alg=OCC", "--metrics=true", "--ctrl=true",
        "--escrow_order_free=false", "--repair=true", "--audit=true",
        "--audit_cadence=1", "--seed=3"]
TPCC = ["--workload=TPCC", "--num_wh=8", "--part_cnt=4",
        "--cust_per_dist=120", "--max_items=200", "--max_items_per_txn=5",
        "--max_accesses=8", "--epoch_batch=64", "--max_txn_in_flight=256",
        "--cc_alg=OCC", "--metrics=true", "--ctrl=true",
        "--escrow_order_free=false", "--audit=true", "--audit_cadence=1"]


def _batch_pair(b, a, keys_max, seed, parts=4):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, keys_max, (b, a)).astype(np.int32)
    valid = rng.random((b, a)) < 0.9
    is_w = rng.random((b, a)) < 0.4
    is_r = ~is_w | (rng.random((b, a)) < 0.2)
    active = rng.random(b) < 0.85
    tids = np.zeros((b, a), np.int32)
    ts = np.arange(1, b + 1, dtype=np.int32)

    def mk(mod, cls, arr):
        return cls(table_ids=arr(tids), keys=arr(keys), is_read=arr(is_r),
                   is_write=arr(is_w), valid=arr(valid), ts=arr(ts),
                   rank=arr(ts - 1), active=arr(active))
    jb = mk(jbase, jbase.AccessBatch, jnp.asarray)
    tb = mk(tbase, tbase.AccessBatch, torch.from_numpy)
    owner = (keys % parts).astype(np.int32)
    return jb, tb, owner


@pytest.mark.parametrize("groups", [3, 4])
@pytest.mark.parametrize("k", [64, 1024])
def test_cross_group_defer_plain_matches_reference(groups, k):
    jb, tb, owner = _batch_pair(256, 8, 4096, seed=groups * 7 + k)
    jinc = jbase.build_incidence(jb, k, False)
    tinc = tbase.build_incidence(tb, k, False, views=("u", "w"))
    assign = [0, 1, 2, 3][:groups] + [groups - 1] * (4 - groups)
    jk = jr.knobs_from_decision(JConfig(), assign, [0] * 4, 2, 1)
    tk = tr.knobs_from_decision(Config(), assign, [0] * 4, 2, 1, "cpu")
    jg = jr.txn_backend(jk, jnp.asarray(owner))
    tg = tr.txn_backend(tk, torch.from_numpy(owner))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    want = np.asarray(jr.cross_group_defer(jinc, jb, jg, n_groups=groups))
    got = tr.cross_group_defer(tinc, tb, tg, n_groups=groups).numpy()
    np.testing.assert_array_equal(got, want)
    # at K = 64 buckets collide and every active txn defers
    assert 0 < got.sum() <= tb.active.sum()
    assert (got.sum() < tb.active.sum()) == (k > 64)
    assert not got[~tb.active.numpy()].any()


def test_coarsen_keys_and_knobs_match_reference():
    jb, tb, owner = _batch_pair(64, 4, 1 << 20, seed=1)
    gshift = [0, 2, 5, 16]
    jk = jr.knobs_from_decision(JConfig(), [1, 1, 1, 1], gshift, 1, 3)
    tk = tr.knobs_from_decision(Config(), [1, 1, 1, 1], gshift, 1, 3, "cpu")
    jc = jr.coarsen_keys(jb, jnp.asarray(owner), jk.gshift)
    tc = tr.coarsen_keys(tb, torch.from_numpy(owner), tk)
    np.testing.assert_array_equal(tc.keys.numpy(), np.asarray(jc.keys))
    zero = tr.knobs_from_decision(Config(), [0] * 4, [0] * 4, 1, 1, "cpu")
    assert tr.coarsen_keys(tb, torch.from_numpy(owner), zero) is tb
    for args in (CTRL, CTRL + ["--cc_alg=TPU_BATCH", "--repair=false"],
                 CTRL + ["--ctrl_dgcc=true", "--cc_alg=DGCC",
                         "--repair=false"]):
        jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
        js, ts = jr.static_knobs(jcfg), tr.static_knobs(tcfg, "cpu")
        assert list(ts.assign) == np.asarray(js.assign).tolist()
        assert list(ts.gshift) == np.asarray(js.gshift).tolist()
        assert ts.repair_cap == int(js.repair_cap)
        assert ts.audit_cadence == int(js.audit_cadence)
        assert tr.candidates(tcfg) == jr.candidates(jcfg)
    for alg in ("NO_WAIT", "OCC", "TPU_BATCH", "DGCC"):
        assert tr.candidate_index(alg) == jr.candidate_index(alg)
    with pytest.raises(ValueError):
        tr.candidate_index("MVCC")


def _signal_stream(cfg, n=40, seed=0):
    """Scripted boundary ticks: densities that sweep through every class,
    repair and witness counts, and a stale gap and a stalled tick that
    trip the governor."""
    rng = np.random.default_rng(seed)
    p = max(cfg.part_cnt, 1)
    out = []
    for e in range(n):
        level = [0.001, 0.1, 0.5][(e // 6) % 3]
        dens = [int(level * cfg.epoch_batch * 8 / p * rng.uniform(0.5, 1.5))
                for _ in range(p)]
        out.append(dict(
            epoch=e * 8, epochs=0 if e == 25 else 8, dens=dens,
            fallback=int(rng.integers(0, 5)), salvaged=int(rng.integers(0, 3)),
            witnesses=int(rng.integers(0, 2)) if e % 7 == 0 else 0,
            breaches=0, gap_us=3_000_000 if e == 17 else 1000))
    return out


@pytest.mark.parametrize("dgcc", [False, True])
def test_controller_copy_matches_reference(dgcc):
    args = CTRL + (["--ctrl_dgcc=true"] if dgcc else []) \
        + ["--ctrl_cooldown=1", "--ctrl_confirm=1", "--repair_rounds=3"]
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jc, tc = jctl.Controller(jcfg), tctl.Controller(tcfg)
    lines = []
    moves = set()
    for sig in _signal_stream(tcfg):
        jd = jc.decide(jctl.CtrlSignals(**sig))
        ts = tctl.CtrlSignals(**sig)
        td = tc.decide(ts)
        assert vars(td) == vars(jd)
        assert tctl.ctrl_line(0, ts, td) == jctl.ctrl_line(
            0, jctl.CtrlSignals(**sig), jd)
        lines.append(tctl.ctrl_line(0, ts, td))
        moves.add(tuple(td.assign))
    assert len(moves) >= 3 and tc.stale_trips >= 1
    rows = parse_ctrl(["noise", *lines])
    assert len(rows) == len(lines)
    assert tctl.replay_decisions(tcfg, rows) == []
    rows[5]["cap"] = 7
    assert tctl.replay_decisions(tcfg, rows) != []
    assert tctl.quota_scale(2) == jctl.quota_scale(2)
    assert tctl.default_backend_map(tcfg) == jctl.default_backend_map(jcfg)


@pytest.mark.parametrize("args", [
    CTRL, CTRL + ["--cc_alg=NO_WAIT", "--audit_cadence=2"],
    CTRL + ["--cc_alg=TPU_BATCH", "--repair=false"],
    CTRL + ["--ctrl_dgcc=true", "--cc_alg=DGCC", "--repair=false"],
    TPCC + ["--cc_alg=TPU_BATCH"]],
    ids=["occ", "no_wait", "tpu_batch", "dgcc", "tpcc_tpu_batch"])
def test_static_knobs_equal_unrouted_epochs(args):
    cfg = Config.from_args(args)
    eng = Engine(cfg, get_workload(cfg, device="cpu"))
    a = eng.run(eng.init_state(), 4)
    b = eng.run_ctrl(eng.init_state(), tr.static_knobs(cfg, "cpu"), 4)
    ga, gb = convert.to_numpy_state(a), convert.to_numpy_state(b)
    assert sorted(ga) == sorted(gb)
    for path, v in ga.items():
        np.testing.assert_array_equal(gb[path], v, err_msg=path)
    assert int(a.stats["total_txn_commit_cnt"]) > 0


@functools.cache
def _engines(args: tuple):
    """One engine pair per config: knob values are operands of the
    reference's compiled routed scan, so its cases share one compile."""
    return engines(list(args))


def routed_both(args, assign, gshift, cap, cadence, epochs=3):
    """``epochs`` routed epochs in both packages under one decision, from
    one carried state, compared after each; the port's final state."""
    jeng, teng, tcfg = _engines(tuple(args))
    jk = jr.knobs_from_decision(jeng.cfg, assign, gshift, cap, cadence)
    tk = tr.knobs_from_decision(tcfg, assign, gshift, cap, cadence, "cpu")
    # the pre epochs through the same compiled routed step, static knobs
    sk = jr.static_knobs(jeng.cfg)
    js, ts = carried(jeng, tcfg,
                     step=lambda s: jeng.jit_run_ctrl(s, sk, 1))
    for _ in range(epochs):
        js = jeng.jit_run_ctrl(jax.tree.map(jnp.asarray, js), jk, 1)
        ts = teng.run_ctrl(ts, tk, 1)
        assert_same(js, ts)
    return ts


@pytest.mark.parametrize("assign,gshift,extra", [
    ([0, 1, 2, 2], [0, 2, 0, 0], []),
    ([0, 1, 2, 3], [0, 2, 0, 1], ["--ctrl_dgcc=true"]),
    ([3, 3, 3, 3], [1, 1, 1, 1], ["--ctrl_dgcc=true"]),
    ([2, 2, 2, 2], [0, 0, 0, 0], []),
    ([0, 0, 0, 0], [2, 0, 0, 0], [])],
    ids=["mixed", "mixed_dgcc", "dgcc", "tpu_batch", "no_wait_coarse"])
def test_routed_epochs_match_reference(assign, gshift, extra):
    ts = routed_both(CTRL + extra, assign, gshift, cap=1, cadence=2)
    st = {k: int(v.sum()) for k, v in ts.stats.items()}
    assert st["total_txn_commit_cnt"] > 0
    if len(set(assign)) > 1:
        assert st["defer_cnt"] > 0          # the cross-group defers
    if 3 in assign:
        assert st["dgcc_wave_cnt"] > 0


@pytest.mark.parametrize("assign", [[0, 1, 2, 2], [2, 2, 2, 2]],
                         ids=["mixed", "tpu_batch"])
def test_routed_tpcc_epochs_match_reference(assign):
    ts = routed_both(TPCC, assign, [0] * 4, cap=2, cadence=1)
    assert int(ts.stats["total_txn_commit_cnt"]) > 0


def test_run_simulation_with_ctrl_replays():
    # one-epoch chunks; each window runs at least one, so the warmup's
    # tick takes the baseline and the measured window's decides, however
    # slow the host
    args = CTRL + ["--warmup_secs=0.01", "--done_secs=0.5",
                   "--ctrl_confirm=1", "--ctrl_cooldown=0",
                   "--chunk_target_secs=0.001"]
    cfg = Config.from_args(args)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = run_simulation(cfg, device="cpu", chunk=1)
    lines = buf.getvalue().splitlines()
    rows = parse_ctrl(lines)
    assert rows and st.counters["ctrl_decisions"] == len(rows)
    assert tctl.replay_decisions(cfg, rows) == []
    assert all(len(str(r["dens"]).split(":")) == 4 for r in rows)
    summary = [ln for ln in lines if ln.startswith("[summary]")]
    assert summary and "ctrl_decisions=" in summary[0] \
        and "mb_density_p3=" in summary[0]
