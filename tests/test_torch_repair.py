"""Port parity of transaction repair: ``deneva_tpu_torch`` against
``deneva_tpu`` on the CPU, exactly.

* K13a's plain version against ``cc.base.committed_write_frontier`` on
  seeded random batches, with one and two hash families, with and
  without ``order_free`` lanes, and with random, empty and full
  committed sets.
* Each sweep backend's ``repair_rule`` against the reference's, after a
  validate of the same batch; TIMESTAMP and MVCC on a carried state whose
  watermarks sit above the batch's stamps, so the stale-read lanes add
  to the frontier.
* The scripted cases of ``tests/test_repair.py`` (one epoch, hand-built
  plans, `run_repair` on the main round's artifacts) through both
  packages: verdicts, salvaged masks, sub-rounds, every counter and the
  table rows ``[0, capacity)`` equal (the trash row, where masked writes
  land in an order neither framework defines, is not compared), and the
  reference's own assertions on the port's results.
* Engine-level: salvaged txns count as commits, ``repair_rounds=0``
  salvages nothing, ``repair=false`` runs no repair code, and an armed
  repair on an epoch without losers is bit-identical to ``repair=false``.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _inject

from deneva_tpu.cc import AccessBatch as JBatch
from deneva_tpu.cc import build_conflict_incidence as j_incidence
from deneva_tpu.cc import build_incidence as j_build_incidence
from deneva_tpu.cc import committed_write_frontier as j_frontier
from deneva_tpu.cc import get_backend as j_backend
from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.repair import repair_line as j_repair_line
from deneva_tpu.engine.repair import repair_ts as j_repair_ts
from deneva_tpu.engine.repair import run_repair as j_run_repair
from deneva_tpu.engine.step import init_device_stats as j_init_stats
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu.workloads.ycsb import TABLE
from deneva_tpu.workloads.ycsb import YCSBQuery as JQuery
from deneva_tpu.workloads.ycsb import _field_fingerprint as j_fingerprint
from deneva_tpu_torch import convert
from deneva_tpu_torch.cc import (AccessBatch, build_conflict_incidence,
                                 build_incidence, get_backend)
from deneva_tpu_torch.cc.base import committed_write_frontier
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine import step as t_step
from deneva_tpu_torch.engine.repair import repair_ts, run_repair
from deneva_tpu_torch.engine.step import Engine, init_device_stats
from deneva_tpu_torch.stats import repair_line
from deneva_tpu_torch.workloads import get_workload
from deneva_tpu_torch.workloads.ycsb import YCSBQuery

SWEEP_ALGS = ("NO_WAIT", "WAIT_DIE", "OCC", "TIMESTAMP", "MVCC", "MAAT")
REP = ("rep_salvaged_cnt", "rep_frontier_cnt", "rep_fallback_cnt",
       "read_checksum", "write_cnt")


def _np_batch(rng, b, a, n_keys, order_free):
    arr = dict(table_ids=rng.integers(0, 2, (b, a)).astype(np.int32),
               keys=rng.integers(0, n_keys, (b, a)).astype(np.int32),
               is_read=rng.random((b, a)) < 0.6,
               is_write=rng.random((b, a)) < 0.5,
               valid=rng.random((b, a)) < 0.9,
               ts=(rng.permutation(b) + 1).astype(np.int32),
               rank=rng.permutation(b).astype(np.int32),
               active=rng.random(b) < 0.9)
    arr["order_free"] = (rng.random((b, a)) < 0.3) if order_free else None
    return arr


def _both(arr):
    j = JBatch(**{k: None if v is None else jnp.asarray(v)
                  for k, v in arr.items()})
    t = AccessBatch(**{k: None if v is None else torch.from_numpy(v)
                       for k, v in arr.items()})
    return j, t


# -- K13a ----------------------------------------------------------------------

@pytest.mark.parametrize("committed_kind", ["random", "empty", "full"])
@pytest.mark.parametrize("order_free", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_frontier_plain_matches_reference(exact, order_free, committed_kind):
    rng = np.random.default_rng(7 + exact + 2 * order_free)
    b, a, k = 48, 6, 64
    for _ in range(3):
        arr = _np_batch(rng, b, a, 40, order_free)
        jb, tb = _both(arr)
        of_j = None if arr["order_free"] is None else jb.order_free
        jinc = j_build_incidence(jb, k, exact, order_free=of_j)
        tinc = build_incidence(tb, k, exact, order_free=tb.order_free,
                               views=("w",))
        committed = {"random": rng.random(b) < 0.4,
                     "empty": np.zeros(b, bool),
                     "full": np.ones(b, bool)}[committed_kind]
        losers = (rng.random(b) < 0.5) & ~committed
        if committed_kind == "full":
            losers = rng.random(b) < 0.5
        want = np.asarray(j_frontier(None, jb, jinc, jnp.asarray(committed),
                                     jnp.asarray(losers)))
        got = committed_write_frontier(None, tb, tinc,
                                       torch.from_numpy(committed),
                                       torch.from_numpy(losers)).numpy()
        np.testing.assert_array_equal(got, want)
        if committed_kind == "empty":
            assert not got.any()
        else:
            assert got.any()


def test_frontier_wrappers_take_no_other_device():
    """On a tensor that lies neither on the CPU nor on CUDA the wrapper
    raises rather than run its plain version."""
    rng = np.random.default_rng(1)
    arr = _np_batch(rng, 8, 4, 10, False)
    _, tb = _both(arr)
    inc = build_incidence(tb, 16, True, views=("w",))
    meta = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="devices"):
        committed_write_frontier(None, tb, inc, meta, meta)
    no_w = dataclasses.replace(inc, w1=None)
    with pytest.raises(ValueError, match="write view"):
        committed_write_frontier(None, tb, no_w, meta, meta)


# -- every backend's frontier -------------------------------------------------

CFG_KW = dict(epoch_batch=32, conflict_buckets=64, max_accesses=6,
              req_per_query=6, synth_table_size=1024, watermark_buckets=16,
              mvcc_his_len=2, repair=True)


@pytest.mark.parametrize("alg", SWEEP_ALGS)
def test_backend_frontiers_match_reference(alg):
    jcfg, tcfg = JConfig(**CFG_KW), Config(**CFG_KW)
    jbe, tbe = j_backend(alg), get_backend(alg)
    jst, tst = jbe.init_state(jcfg), tbe.init_state(tcfg, "cpu")
    rng = np.random.default_rng(11)
    stale_total = 0
    for epoch in range(3):
        arr = _np_batch(rng, 32, 6, 24, False)
        arr["table_ids"][:] = 0
        # later epochs stamp BELOW the watermarks the earlier ones left
        arr["ts"] = (arr["ts"] + (60 if epoch == 0 else 0)).astype(np.int32)
        jb, tb = _both(arr)
        jinc = j_incidence(jcfg, jbe, jb, None)
        tinc = build_conflict_incidence(tcfg, tbe, tb, None)
        jv, jst = jbe.validate(jcfg, jst, jb, jinc)
        tv, tst = tbe.validate(tcfg, tst, tb, tinc)
        np.testing.assert_array_equal(tv.commit.numpy(),
                                      np.asarray(jv.commit))
        losers = tv.abort & tb.active
        want = np.asarray(jbe.repair_rule(jcfg, jst, jb, jinc, jv.commit,
                                          jnp.asarray(losers.numpy())))
        got = tbe.repair_rule(tcfg, tst, tb, tinc, tv.commit, losers)
        np.testing.assert_array_equal(got.numpy(), want)
        base = committed_write_frontier(tcfg, tb, tinc, tv.commit, losers)
        stale_total += int((got & ~base).sum())
    if alg in ("TIMESTAMP", "MVCC"):
        assert stale_total > 0, "the stale-read lanes never contributed"
    else:
        assert stale_total == 0


def test_nolock_repair_builds_the_write_view():
    """2PL under NOLOCK validates without incidence; under repair the
    views still hold ``w`` (and ``w2``), so the frontier has its input."""
    kw = {**CFG_KW, "isolation_level": "NOLOCK"}
    be = get_backend("NO_WAIT")
    arr = _np_batch(np.random.default_rng(2), 32, 6, 24, False)
    _, tb = _both(arr)
    assert build_conflict_incidence(Config(**{**kw, "repair": False}), be,
                                    tb, None) is None
    inc = build_conflict_incidence(Config(**kw), be, tb, None)
    assert inc.w1 is not None and inc.w2 is not None


# -- the scripted cases of tests/test_repair.py:138-327 ----------------------

B, R = 8, 2


def _args(alg, **kw):
    base = dict(synth_table_size=1024, req_per_query=R, max_accesses=R,
                epoch_batch=B, zipf_theta=0.0, conflict_buckets=1024,
                max_txn_in_flight=512, read_perc=0.1, write_perc=0.9,
                repair=True, cc_alg=alg)
    base.update(kw)
    return [f"--{k}={v}" for k, v in base.items()]


def _scripts(scripts):
    keys = np.zeros((B, R), np.int32)
    is_w = np.zeros((B, R), bool)
    for i in range(B):
        for s in range(R):
            keys[i, s] = 600 + i * R + s     # cold pad reads
        for s, (key, mode) in enumerate(scripts[i] if i < len(scripts)
                                        else ()):
            keys[i, s] = key
            is_w[i, s] = mode == "w"
    active = np.zeros(B, bool)
    active[:len(scripts)] = True
    return keys, is_w, active


class Rig:
    """The main round of one scripted epoch in both packages: plan,
    validate (from ``states`` when given), execute — `run_repair`'s inputs
    as ``Engine.step`` hands them over."""

    def __init__(self, alg, scripts, states=None, **cfg_kw):
        args = _args(alg, **cfg_kw)
        self.jcfg, self.tcfg = JConfig.from_args(args), Config.from_args(args)
        keys, is_w, active = _scripts(scripts)
        ts = np.arange(1, B + 1, dtype=np.int32)
        rank = np.arange(B, dtype=np.int32)
        # reference
        self.jwl, self.jbe = j_workload(self.jcfg), j_backend(alg)
        db = self.jwl.load()
        self.jq = JQuery(keys=jnp.asarray(keys), is_write=jnp.asarray(is_w))
        p = self.jwl.plan(db, self.jq)
        self.jb = JBatch(table_ids=p["table_ids"], keys=p["keys"],
                         is_read=p["is_read"], is_write=p["is_write"],
                         valid=p["valid"], ts=jnp.asarray(ts),
                         rank=jnp.asarray(rank), active=jnp.asarray(active))
        self.jinc = j_incidence(self.jcfg, self.jbe, self.jb, None)
        jst = self.jbe.init_state(self.jcfg) if states is None else states[0]
        self.jv, self.jst = self.jbe.validate(self.jcfg, jst, self.jb,
                                              self.jinc)
        self.jstats = j_init_stats()
        self.jdb = self.jwl.execute(db, self.jq, self.jv.commit,
                                    self.jv.order, self.jstats)
        # port
        self.twl = get_workload(self.tcfg, device="cpu")
        self.tbe = get_backend(alg)
        db = self.twl.load()
        self.tq = YCSBQuery(keys=torch.from_numpy(keys),
                            is_write=torch.from_numpy(is_w))
        p = self.twl.plan(db, self.tq)
        self.tb = AccessBatch(table_ids=p["table_ids"], keys=p["keys"],
                              is_read=p["is_read"], is_write=p["is_write"],
                              valid=p["valid"], ts=torch.from_numpy(ts),
                              rank=torch.from_numpy(rank),
                              active=torch.from_numpy(active))
        self.tinc = build_conflict_incidence(self.tcfg, self.tbe, self.tb,
                                             None)
        tst = self.tbe.init_state(self.tcfg, "cpu") if states is None \
            else states[1]
        self.tv, self.tst = self.tbe.validate(self.tcfg, tst, self.tb,
                                              self.tinc)
        self.tstats = init_device_stats()
        self.tdb = self.twl.execute(db, self.tq, self.tv.commit,
                                    self.tv.order, self.tstats)
        np.testing.assert_array_equal(self.tv.abort.numpy(),
                                      np.asarray(self.jv.abort))

    def repair(self, rounds=2, ts_base=None, cap=None):
        """`run_repair` in both (``cap``: the ``rounds_cap`` knob, a traced
        scalar there and a host int here); asserts equal results; returns
        the port's (F0, verdict, salvaged, rounds, stats) as numpy."""
        jcfg = self.jcfg.replace(repair_rounds=rounds)
        tcfg = self.tcfg.replace(repair_rounds=rounds)
        jstats, tstats = dict(self.jstats), dict(self.tstats)
        jdb, _, jv, jsalv, jrnd = j_run_repair(
            jcfg, self.jwl, self.jbe, self.jdb, self.jq, self.jb, self.jinc,
            self.jv, self.jst, jstats, self.jv.commit,
            ts_base=None if ts_base is None else jnp.int32(ts_base),
            rounds_cap=None if cap is None else jnp.int32(cap))
        tdb, _, tv, tsalv, trnd = run_repair(
            tcfg, self.twl, self.tbe, self.tdb, self.tq, self.tb, self.tinc,
            self.tv, self.tst, tstats, self.tv.commit,
            ts_base=None if ts_base is None else torch.tensor(
                ts_base, dtype=torch.int32), rounds_cap=cap)
        for f in ("commit", "abort", "defer", "order"):
            np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                          np.asarray(getattr(jv, f)), f)
        np.testing.assert_array_equal(tsalv.numpy(), np.asarray(jsalv))
        np.testing.assert_array_equal(trnd.numpy(), np.asarray(jrnd))
        for k in REP:
            assert int(tstats[k]) == int(jstats[k]), k
        cap = self.tcfg.synth_table_size
        f0 = tdb[TABLE].columns["F0"].numpy().view(np.uint32)
        np.testing.assert_array_equal(
            f0[:cap], np.asarray(jdb[TABLE].columns["F0"])[:cap])
        v = {f: getattr(tv, f).numpy() for f in ("commit", "abort", "order")}
        return f0, v, tsalv.numpy(), trnd.numpy(), \
            {k: int(x) for k, x in tstats.items() if x.numel() == 1}


def _fp(key, order):
    return int(np.asarray(j_fingerprint(jnp.int32(key), jnp.int32(order))))


def test_empty_frontier_salvages_write_only_loser():
    rig = Rig("OCC", [[(5, "w")], [(5, "w")]])
    f0, v, salvaged, rounds, st = rig.repair()
    assert salvaged[1] and v["commit"][1] and not v["abort"][1]
    assert rounds[1] == 1
    assert st["rep_frontier_cnt"] == 0 and st["rep_salvaged_cnt"] == 1
    assert st["rep_fallback_cnt"] == 0
    assert f0[5] == _fp(5, v["order"][1])


def test_full_frontier_reader_observes_winner_value():
    rig = Rig("OCC", [[(5, "w")], [(5, "r")]])
    pre = int(rig.tstats["read_checksum"])
    f0, v, salvaged, _, st = rig.repair()
    assert salvaged[1] and st["rep_frontier_cnt"] == 1
    delta = (st["read_checksum"] - pre) % (1 << 32)
    assert delta == (_fp(5, v["order"][0]) + _fp(603, 0)) % (1 << 32)


@pytest.mark.parametrize("rounds", [0, 1, 2, 3])
def test_cyclic_reinvalidation_falls_back(rounds):
    rig = Rig("OCC", [[(5, "w")] for _ in range(4)])
    f0, v, salvaged, rnd, st = rig.repair(rounds=rounds)
    assert int(salvaged.sum()) == min(rounds, 3)
    assert st["rep_fallback_cnt"] == 3 - min(rounds, 3)
    assert sorted(rnd[salvaged]) == list(range(1, min(rounds, 3) + 1))
    last = 0 if rounds == 0 else min(rounds, 3)
    assert f0[5] == _fp(5, v["order"][last])


def test_timestamp_watermark_loser_restamps_and_salvages():
    first = Rig("TIMESTAMP", [[(5, "w")] for _ in range(8)])
    rig = Rig("TIMESTAMP", [[(5, "r")]], states=(first.jst, first.tst))
    assert rig.tv.abort[0], "stale reader must abort before repair"
    _, v, salvaged, _, st = rig.repair(ts_base=20)
    assert salvaged[0] and not v["abort"][0]
    assert st["rep_frontier_cnt"] >= 1
    # a base below the watermark: the re-check declines the salvage
    rig = Rig("TIMESTAMP", [[(5, "r")]], states=(first.jst, first.tst))
    _, v, salvaged, _, _ = rig.repair(ts_base=2)
    assert not salvaged[0] and v["abort"][0]
    # without a base, fresh stamps sit above every active stamp
    fresh = repair_ts(rig.tb).numpy()
    np.testing.assert_array_equal(fresh, np.asarray(j_repair_ts(rig.jb)))
    assert fresh.min() > int(rig.tb.ts[rig.tb.active].max())


def test_escrow_reads_never_enter_frontier():
    kw = dict(synth_table_size=1024, req_per_query=R, max_accesses=R,
              epoch_batch=B, repair=True, cc_alg="OCC")
    keys = np.array([[5, 600], [5, 601]] + [[602 + i, 610 + i]
                                            for i in range(B - 2)], np.int32)
    is_w = np.zeros((B, R), bool)
    is_w[0, 0] = True
    of = np.zeros((B, R), bool)
    of[1, 0] = True
    arr = dict(table_ids=np.zeros((B, R), np.int32), keys=keys,
               is_read=~is_w, is_write=is_w, valid=np.ones((B, R), bool),
               ts=np.arange(1, B + 1, dtype=np.int32),
               rank=np.arange(B, dtype=np.int32), active=np.ones(B, bool),
               order_free=of)
    committed = np.zeros(B, bool)
    committed[0] = True
    losers = np.zeros(B, bool)
    losers[1] = True
    for escrow in (True, False):
        a = dict(arr, order_free=of if escrow else None)
        jb, tb = _both(a)
        jcfg, tcfg = JConfig(**kw), Config(**kw)
        jinc = j_incidence(jcfg, j_backend("OCC"), jb, jb.order_free)
        tinc = build_conflict_incidence(tcfg, get_backend("OCC"), tb,
                                        tb.order_free)
        want = np.asarray(j_frontier(jcfg, jb, jinc, jnp.asarray(committed),
                                     jnp.asarray(losers)))
        got = committed_write_frontier(tcfg, tb, tinc,
                                       torch.from_numpy(committed),
                                       torch.from_numpy(losers)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[1, 0] == (not escrow)


def test_repair_line_matches_reference():
    fields = {"salvaged": 3, "frontier": 7, "fallback": 1, "rounds": 2}
    assert repair_line(0, fields) == j_repair_line(0, fields)


def test_rounds_cap_is_not_ported():
    """The control plane's ``rounds_cap`` (ported with it): rounds at or
    past the cap do nothing, as the reference's ``lax.cond`` skips them,
    and a cap of ``repair_rounds`` equals no cap."""
    rig = Rig("OCC", [[(5, "w"), (9, "r")], [(5, "w")], [(9, "w")],
                      [(9, "w"), (5, "r")]])
    salvaged = []
    for cap in (0, 1, 2, None):
        _, _, salv, _, st = rig.repair(rounds=2, cap=cap)
        salvaged.append(int(salv.sum()))
        if cap == 0:
            assert st["rep_salvaged_cnt"] == 0 == st["rep_frontier_cnt"]
    assert salvaged[2] == salvaged[3] and salvaged[0] < salvaged[3]


# -- engine level ------------------------------------------------------------

ENGINE = ["--synth_table_size=4096", "--req_per_query=4", "--max_accesses=4",
          "--epoch_batch=128", "--conflict_buckets=1024",
          "--max_txn_in_flight=512", "--zipf_theta=0.9", "--read_perc=0.1",
          "--write_perc=0.9", "--seed=5"]


def zipf_bank(n_rows, theta, epochs=4, n=512, r=4, seed=17, write_perc=0.9):
    """Queries drawn from numpy's zipf law at ``theta`` (p(k) ~ 1/(k+1)^
    theta over the rows): one bank injected into both packages."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_rows + 1, dtype=np.float64) ** theta
    keys = rng.choice(n_rows, size=(epochs, n, r), p=p / p.sum())
    return keys.astype(np.int32), rng.random((epochs, n, r)) < write_perc


def _port_run(args, epochs=8):
    """The port alone, from its own init, on one zipf bank."""
    cfg = Config.from_args(args)
    eng = Engine(cfg, get_workload(cfg, device="cpu"))
    keys, is_w = zipf_bank(cfg.synth_table_size, cfg.zipf_theta,
                           write_perc=cfg.write_perc)
    _inject(SimpleNamespace(), eng.workload, keys, is_w)
    st = eng.run(eng.init_state(), epochs)
    return st, convert.to_numpy_state(st)


def test_salvaged_txns_are_commits_not_aborts():
    st, _ = _port_run(ENGINE + ["--cc_alg=OCC", "--repair=true"])
    s = {k: int(v.sum()) for k, v in st.stats.items()}
    assert s["rep_salvaged_cnt"] > 0, "contention point inert"
    assert s["total_txn_abort_cnt"] == s["rep_fallback_cnt"]
    off, _ = _port_run(ENGINE + ["--cc_alg=OCC", "--repair=false"])
    assert s["total_txn_commit_cnt"] > int(off.stats["total_txn_commit_cnt"])


def test_repair_rounds_zero_salvages_nothing():
    st, _ = _port_run(ENGINE + ["--cc_alg=OCC", "--repair=true",
                                "--repair_rounds=0"])
    off, _ = _port_run(ENGINE + ["--cc_alg=OCC"])
    assert int(st.stats["rep_salvaged_cnt"]) == 0
    for k in ("total_txn_commit_cnt", "total_txn_abort_cnt"):
        assert int(st.stats[k]) == int(off.stats[k])
    assert int(st.stats["rep_fallback_cnt"]) == \
        int(st.stats["total_txn_abort_cnt"])


def test_repair_off_runs_no_repair_code(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("run_repair called with repair=false")
    monkeypatch.setattr(t_step, "run_repair", refuse)
    st, _ = _port_run(ENGINE + ["--cc_alg=OCC"], epochs=3)
    assert int(st.stats["total_txn_abort_cnt"]) > 0


@pytest.mark.parametrize("alg", ["OCC", "TIMESTAMP", "MVCC"])
def test_repair_noop_when_no_losers_bit_identical(alg):
    """All-read epochs: no losers, so the armed machinery is an exact
    no-op on every table row, cc-state leaf, pool leaf and counter."""
    kw = [f"--cc_alg={alg}", "--read_perc=1.0", "--write_perc=0.0",
          "--watermark_buckets=64"]
    _, on = _port_run(ENGINE + kw + ["--repair=true"], epochs=4)
    _, off = _port_run(ENGINE + kw + ["--repair=false"], epochs=4)
    assert sorted(on) == sorted(off)
    cap = 4096
    for path, want in off.items():
        have = on[path]
        if path.startswith("db/") and have.ndim and have.shape[0] > cap:
            have, want = have[:cap], want[:cap]
        np.testing.assert_array_equal(have, want, err_msg=path)
    assert on["stats/rep_salvaged_cnt"] == 0
    assert on["stats/rep_frontier_cnt"] == 0
