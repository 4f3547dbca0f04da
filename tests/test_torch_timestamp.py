"""Port parity of TIMESTAMP and MVCC: ``deneva_tpu_torch`` against
``deneva_tpu`` on the CPU, exactly.

Unit cases mirror the reference's own (``tests/test_cc.py``: T/O, MVCC,
the version ring and its historical bytes) with the same inputs through
both packages: verdicts, ``order``, watermarks, ``his`` / ``pos`` and
ring entries are equal.

Whole epochs (`run_epochs`, shared with test_torch_twopl.py): YCSB over
a partial pool (``max_txn_in_flight = 256``, ``epoch_batch = 64``), 4096
rows, ``conflict_buckets = 256`` and ``watermark_buckets = 64`` so that
buckets collide, ``mvcc_his_len = 4``, theta 0.9 with queries injected
from one numpy bank into both packages.  The reference runs two epochs
first; its state (non-zero watermarks) crosses into the port through
``convert.from_reference_state``, then five epochs run in each and every
leaf is compared, except the table's trash row (losers' writes land
there in an order neither framework defines) and the version ring's
last row, which the reference fills with unspecified values and the
port leaves zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _inject
from test_torch_occ import _bank

from deneva_tpu.cc import AccessBatch as JBatch
from deneva_tpu.cc import build_incidence as j_build_incidence
from deneva_tpu.cc import get_backend as j_backend
from deneva_tpu.cc import timestamp as j_timestamp
from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.storage.table import VersionRing as JRing
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.cc import (AccessBatch, build_conflict_incidence,
                                 get_backend, timestamp)
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.storage.table import VersionRing
from deneva_tpu_torch.workloads import get_workload, ycsb

EPOCHS = 5
BASE = ["--epoch_batch=64", "--max_txn_in_flight=256",
        "--synth_table_size=4096", "--conflict_buckets=256",
        "--watermark_buckets=64", "--mvcc_his_len=4",
        "--conflict_exact=true", "--req_per_query=10", "--write_perc=0.5",
        "--read_perc=0.5", "--zipf_theta=0.9", "--field_per_tuple=10",
        "--tup_size=100", "--seed=5"]


# -- whole epochs ----------------------------------------------------------

def _assert_same(jstate, tstate, cfg, ring_trash=None):
    """Leaf by leaf; ``ring_trash`` is what the port's ring trash row held
    when it was carried across (it must still hold it)."""
    cap, h = cfg.synth_table_size, cfg.mvcc_his_len
    ref = convert.flatten_reference(jax.device_get(jstate))
    got = convert.to_numpy_state(tstate)
    assert sorted(ref) == sorted(got)
    for path, want in ref.items():
        have = got[path]
        assert have.dtype == want.dtype and have.shape == want.shape, path
        if path == f"db/{ycsb.VER_TABLE}/wts":
            np.testing.assert_array_equal(have[:-h], want[:-h], err_msg=path)
            np.testing.assert_array_equal(    # the ring's trash row
                have[-h:], np.zeros(h, np.int32) if ring_trash is None
                else ring_trash, err_msg=path)
        elif path.startswith("db/") and have.ndim >= 1 \
                and have.shape[0] > cap:
            np.testing.assert_array_equal(have[:cap], want[:cap],
                                          err_msg=path)
            assert not have[cap + 1:].any(), path   # padded rows
        else:
            np.testing.assert_array_equal(have, want, err_msg=path)


def run_epochs(args, write_perc=0.5, pre=2, perturb=None, hook=None):
    """``pre`` reference epochs, then ``EPOCHS`` in each package from the
    carried state, compared leaf by leaf.  ``perturb`` may rewrite the
    reference's host state before it is carried (both packages start
    from the result); ``hook(engine)`` sees the port's engine before its
    epochs.  Returns (port state, port engine, reference host state
    after ``pre``)."""
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    assert not teng.pool.full_pool
    keys, is_w = _bank(tcfg.synth_table_size, write_perc=write_perc)
    _inject(jeng.workload, teng.workload, keys, is_w)
    js = jax.device_get(jeng.jit_run(jeng.init_state(), pre))
    if perturb is not None:
        js = perturb(js)
    mid = js
    ts = convert.from_reference_state(js, tcfg, "cpu")
    if hook is not None:
        hook(teng)
    js = jeng.jit_run(jax.tree.map(jnp.asarray, js), EPOCHS)
    ts = teng.run(ts, EPOCHS)
    ring = ts.db.get(ycsb.VER_TABLE)
    trash = None if ring is None else mid.db[ycsb.VER_TABLE].wts[-ring.depth:]
    _assert_same(js, ts, tcfg, trash)
    return ts, teng, mid


def _count_watermark_aborts(monkeypatch):
    seen = {"wm_abort": 0}
    real = timestamp._watermark_check

    def counted(cfg, state, batch, mvcc):
        wm, ro = real(cfg, state, batch, mvcc)
        seen["wm_abort"] += int((wm & batch.active).sum())
        return wm, ro
    monkeypatch.setattr(timestamp, "_watermark_check", counted)
    return seen


def _count_ring_reads(monkeypatch):
    """Committed reads served from the ring (``has_newer``)."""
    seen = {"served": 0, "reads": 0}
    real = ycsb._versioned_read_f0

    def counted(f0, ring, keys, slots, rmask, ver_ts, capacity):
        _, has = ring.select_version(slots, ver_ts[:, None].expand(
            slots.shape))
        seen["served"] += int((has & rmask).sum())
        seen["reads"] += int(rmask.sum())
        return real(f0, ring, keys, slots, rmask, ver_ts, capacity)
    monkeypatch.setattr(ycsb, "_versioned_read_f0", counted)
    return seen


@pytest.mark.parametrize("abort_mode", [False, True])
def test_timestamp_epochs_match_reference(monkeypatch, abort_mode):
    seen = _count_watermark_aborts(monkeypatch)
    ts, _, mid = run_epochs(BASE + ["--cc_alg=TIMESTAMP",
                                    f"--ycsb_abort_mode={abort_mode}"])
    assert mid.cc_state.rts.any() and mid.cc_state.wts.any()
    st = {k: int(v.sum()) for k, v in ts.stats.items()}
    assert st["total_txn_commit_cnt"] > 0 and st["defer_cnt"] > 0
    assert seen["wm_abort"] > 0 and st["total_txn_abort_cnt"] > 0


@pytest.mark.parametrize("full,abort_mode,read_perc", [
    (False, False, 0.5), (True, False, 0.5), (False, True, 0.5),
    (True, True, 0.8)])
def test_mvcc_epochs_match_reference(monkeypatch, full, abort_mode,
                                     read_perc):
    seen = _count_watermark_aborts(monkeypatch)
    ring = _count_ring_reads(monkeypatch)
    args = BASE + ["--cc_alg=MVCC", f"--sim_full_row={full}",
                   f"--ycsb_abort_mode={abort_mode}",
                   f"--read_perc={read_perc}",
                   f"--write_perc={1 - read_perc:.1f}"]
    ts, _, mid = run_epochs(args, write_perc=1 - read_perc)
    assert mid.cc_state.his.any() and mid.cc_state.wts.any()
    st = {k: int(v.sum()) for k, v in ts.stats.items()}
    assert st["total_txn_commit_cnt"] > 0
    assert seen["wm_abort"] > 0
    # committed stale reads served historical versions from the ring
    assert ring["served"] > 0


def test_watermark_buckets_must_be_a_power_of_two():
    # as in the reference, validate admits it and the hash refuses it at
    # first use
    args = BASE + ["--cc_alg=TIMESTAMP", "--watermark_buckets=1000"]
    tcfg = Config.from_args(args)
    assert JConfig.from_args(args).watermark_buckets == 1000
    eng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    st = eng.init_state()
    with pytest.raises(ValueError, match="power of two"):
        eng.step(st)


# -- unit cases (tests/test_cc.py:157-252) -----------------------------------

CFG_KW = dict(epoch_batch=16, conflict_buckets=4096, max_accesses=4,
              req_per_query=4, synth_table_size=1024)


def _batch_np(txns, ts=None, rank=None, a=4, bp=16):
    """``tests/test_cc.py`` make_batch, as numpy arrays."""
    b = len(txns)
    keys = np.zeros((bp, a), np.int32)
    is_r, is_w, valid = (np.zeros((bp, a), bool) for _ in range(3))
    for i, script in enumerate(txns):
        for s, (key, mode) in enumerate(script):
            keys[i, s] = key
            valid[i, s] = True
            is_r[i, s] = "r" in mode
            is_w[i, s] = "w" in mode
    ts = np.arange(1, b + 1, dtype=np.int32) if ts is None \
        else np.asarray(ts, np.int32)
    rank = np.arange(b, dtype=np.int32) if rank is None \
        else np.asarray(rank, np.int32)
    ts = np.concatenate([ts, np.full(bp - b, ts.max() + 1, np.int32)])
    rank = np.concatenate([rank, np.arange(bp - b, dtype=np.int32)
                           + rank.max() + 1])
    active = np.zeros(bp, bool)
    active[:b] = True
    return dict(table_ids=np.zeros((bp, a), np.int32), keys=keys,
                is_read=is_r, is_write=is_w, valid=valid, ts=ts, rank=rank,
                active=active)


class Both:
    """One backend in both packages, its state carried side by side."""

    def __init__(self, alg, **cfg_kw):
        kw = {**CFG_KW, **cfg_kw}
        self.jcfg, self.tcfg = JConfig(**kw), Config(**kw)
        self.jbe, self.tbe = j_backend(alg), get_backend(alg)
        self.jst = self.jbe.init_state(self.jcfg)
        self.tst = self.tbe.init_state(self.tcfg, "cpu")
        jcfg, jbe = self.jcfg, self.jbe

        @jax.jit
        def go(state, batch):
            inc = j_build_incidence(batch, jcfg.conflict_buckets,
                                    jcfg.conflict_exact) \
                if jbe.needs_incidence else None
            return jbe.validate(jcfg, state, batch, inc)
        self._go = go

    def run(self, txns, **kw):
        """Validate one scripted batch in both; assert equal verdicts and
        states; return the port's verdict as numpy."""
        arr = _batch_np(txns, **kw)
        jv, self.jst = self._go(self.jst, JBatch(
            **{k: jnp.asarray(v) for k, v in arr.items()}))
        tb = AccessBatch(**{k: torch.from_numpy(v) for k, v in arr.items()})
        inc = build_conflict_incidence(self.tcfg, self.tbe, tb, None)
        tv, self.tst = self.tbe.validate(self.tcfg, self.tst, tb, inc)
        out = {}
        for f in ("commit", "abort", "defer", "order", "level"):
            want, have = np.asarray(getattr(jv, f)), getattr(tv, f).numpy()
            np.testing.assert_array_equal(have, want, err_msg=f)
            out[f] = have
        for f in convert.CC_FIELDS:
            if hasattr(self.jst, f):
                np.testing.assert_array_equal(
                    getattr(self.tst, f).numpy(),
                    np.asarray(getattr(self.jst, f)), err_msg=f)
        return out


def test_to_reader_after_writer_waits():
    be = Both("TIMESTAMP")
    v = be.run([[(5, "w")], [(5, "r")]], ts=[1, 2])
    assert v["commit"][0] and v["defer"][1] and not v["abort"][1]
    assert be.run([[(5, "r")]], ts=[2])["commit"][0]


def test_to_reader_before_writer_both_commit():
    v = Both("TIMESTAMP").run([[(5, "r")], [(5, "w")]], ts=[1, 2])
    assert v["commit"][:2].all()


def test_to_blind_ww_thomas_rule():
    v = Both("TIMESTAMP").run([[(5, "w")], [(5, "w")]], ts=[1, 2])
    assert v["commit"][:2].all() and v["order"][1] > v["order"][0]


def test_to_watermarks_cross_epoch():
    be = Both("TIMESTAMP")
    assert be.run([[(5, "w")]], ts=[10])["commit"][0]
    v = be.run([[(5, "r")], [(5, "r")], [(5, "w")]], ts=[5, 15, 7])
    assert v["abort"][0] and v["commit"][1] and v["abort"][2]


def test_mvcc_readonly_always_commits():
    be = Both("MVCC")
    be.run([[(5, "w")]], ts=[10])
    v = be.run([[(5, "r")]], ts=[5])
    assert v["commit"][0] and v["order"][0] == 0


def test_mvcc_rw_txn_still_validates():
    be = Both("MVCC")
    be.run([[(5, "w")]], ts=[10])
    assert be.run([[(5, "rw")]], ts=[7])["abort"][0]


def test_mvcc_version_ring_serves_stale_read():
    txns = [[(5, "r"), (6, "w")]]
    be = Both("MVCC")
    be.run([[(5, "w")]], ts=[10])
    assert be.run(txns, ts=[7])["commit"][0]
    to = Both("TIMESTAMP")
    to.run([[(5, "w")]], ts=[10])
    assert to.run(txns, ts=[7])["abort"][0]


def test_mvcc_recycled_version_aborts():
    be = Both("MVCC")
    for wts in (10, 20, 30, 40):           # mvcc_his_len = 4 boundaries
        assert be.run([[(5, "w")]], ts=[wts])["commit"][0]
    # the ring wraps: a fifth boundary overwrites the oldest entry
    assert be.run([[(5, "w")]], ts=[50])["commit"][0]
    assert be.run([[(5, "r"), (6, "w")]], ts=[15])["abort"][0]
    assert be.run([[(5, "r"), (6, "w")]], ts=[25])["commit"][0]
    # a reader exactly at the oldest retained boundary is served
    assert be.run([[(5, "r"), (7, "w")]], ts=[20])["commit"][0]


def test_escrow_rules_match_reference():
    """The order_free branches of the watermark check and commit."""
    rng = np.random.default_rng(3)
    for alg in ("TIMESTAMP", "MVCC"):
        kw = dict(epoch_batch=16, conflict_buckets=64, max_accesses=4,
                  req_per_query=4, synth_table_size=1024,
                  watermark_buckets=16)
        jcfg, tcfg = JConfig(**kw), Config(**kw)
        jst = j_backend(alg).init_state(jcfg)
        tst = get_backend(alg).init_state(tcfg, "cpu")
        for epoch in range(4):
            arr = {"table_ids": np.zeros((16, 4), np.int32),
                   "keys": rng.integers(0, 40, (16, 4)).astype(np.int32),
                   "is_read": rng.random((16, 4)) < 0.6,
                   "is_write": rng.random((16, 4)) < 0.5,
                   "valid": rng.random((16, 4)) < 0.9,
                   "ts": (rng.permutation(16) + 1 + 16 * epoch
                          ).astype(np.int32),
                   "rank": np.arange(16, dtype=np.int32),
                   "active": rng.random(16) < 0.9,
                   "order_free": rng.random((16, 4)) < 0.3}
            jb = JBatch(**{k: jnp.asarray(v) for k, v in arr.items()})
            tb = AccessBatch(**{k: torch.from_numpy(v)
                                for k, v in arr.items()})
            mvcc = alg == "MVCC"
            want = np.asarray(j_timestamp._watermark_aborts(jcfg, jst, jb,
                                                            mvcc))
            wm, _ = timestamp._watermark_check(tcfg, tst, tb, mvcc)
            np.testing.assert_array_equal(wm.numpy(), want)
            commit = arr["active"] & ~want
            jst = j_timestamp._commit_watermarks(jcfg, jst, jb,
                                                 jnp.asarray(commit))
            tst = timestamp._commit_watermarks(tcfg, tst, tb,
                                               torch.from_numpy(commit))
            for f in convert.CC_FIELDS:
                if hasattr(jst, f):
                    np.testing.assert_array_equal(
                        getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))


def test_version_ring_matches_reference():
    rng = np.random.default_rng(9)
    nrows, h = 64, 4
    jr, tr = JRing.create(nrows, h), VersionRing.create(nrows, h, "cpu")
    for t in range(1, 12):
        # one winner per row, as the executor's last-writer pass leaves
        slots = rng.permutation(nrows - 1)[:20].astype(np.int32)
        mask = rng.random(20) < 0.7
        wts = np.full(20, 10 * t, np.int32)
        jr = jr.push(jnp.asarray(slots), jnp.asarray(wts), jnp.asarray(mask))
        tr = tr.push(torch.from_numpy(slots), torch.from_numpy(wts),
                     torch.from_numpy(mask))
        np.testing.assert_array_equal(tr.wts.numpy()[:-h],
                                      np.asarray(jr.wts)[:-h])
        assert not tr.wts[-h:].any()
        q = rng.integers(0, nrows - 1, (8, 3)).astype(np.int32)
        qts = rng.integers(0, 10 * t + 10, (8, 3)).astype(np.int32)
        jv = jr.select_version(jnp.asarray(q), jnp.asarray(qts))
        tv = tr.select_version(torch.from_numpy(q), torch.from_numpy(qts))
        for a, b in zip(tv, jv):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class _MvccEpochs:
    """MVCC epochs of scripted YCSB txns through both packages' plan,
    validate and execute (``tests/test_cc.py:252``'s harness): the
    verdicts, read checksums and version rings must agree."""

    def __init__(self):
        from deneva_tpu.engine.step import init_device_stats as j_stats
        from deneva_tpu_torch.engine.step import init_device_stats
        kw = dict(cc_alg="MVCC", synth_table_size=1024, req_per_query=2,
                  max_accesses=2, epoch_batch=4, conflict_buckets=512,
                  max_txn_in_flight=4)
        self.jcfg, self.tcfg = JConfig(**kw), Config(**kw)
        self.jwl = j_workload(self.jcfg)
        self.twl = get_workload(self.tcfg, device="cpu")
        self.jdb, self.tdb = self.jwl.load(), self.twl.load()
        self.jbe, self.tbe = j_backend("MVCC"), get_backend("MVCC")
        self.jst = self.jbe.init_state(self.jcfg)
        self.tst = self.tbe.init_state(self.tcfg, "cpu")
        self.jstats, self.tstats = j_stats(2), init_device_stats(2)

    @staticmethod
    def f(key, ver):
        return int(ycsb._field_fingerprint(torch.tensor(key),
                                           torch.tensor(ver)))

    def checksum(self):
        return int(self.tstats["read_checksum"])

    def run(self, keys, is_write, ts):
        from deneva_tpu.workloads.ycsb import YCSBQuery as JQuery
        n = len(keys)
        jq = JQuery(keys=jnp.asarray(keys, jnp.int32),
                    is_write=jnp.asarray(is_write))
        tq = ycsb.YCSBQuery(keys=torch.tensor(keys, dtype=torch.int32),
                            is_write=torch.tensor(is_write))
        p = self.jwl.plan(self.jdb, jq)
        jb = JBatch(table_ids=p["table_ids"], keys=p["keys"],
                    is_read=p["is_read"], is_write=p["is_write"],
                    valid=p["valid"], ts=jnp.asarray(ts, jnp.int32),
                    rank=jnp.arange(n, dtype=jnp.int32),
                    active=jnp.ones(n, bool))
        jv, self.jst = self.jbe.validate(
            self.jcfg, self.jst, jb, j_build_incidence(
                jb, self.jcfg.conflict_buckets, self.jcfg.conflict_exact))
        self.jdb = self.jwl.execute(self.jdb, jq, jv.commit & jb.active,
                                    jv.order, self.jstats)
        p = self.twl.plan(self.tdb, tq)
        tb = AccessBatch(table_ids=p["table_ids"], keys=p["keys"],
                         is_read=p["is_read"], is_write=p["is_write"],
                         valid=p["valid"],
                         ts=torch.tensor(ts, dtype=torch.int32),
                         rank=torch.arange(n, dtype=torch.int32),
                         active=torch.ones(n, dtype=torch.bool))
        tv, self.tst = self.tbe.validate(
            self.tcfg, self.tst, tb,
            build_conflict_incidence(self.tcfg, self.tbe, tb, None))
        self.tdb = self.twl.execute(self.tdb, tq, tv.commit & tb.active,
                                    tv.order, self.tstats)
        for f in ("commit", "defer"):
            np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                          np.asarray(getattr(jv, f)))
        assert self.checksum() == int(np.asarray(self.jstats["read_checksum"]))
        ring = self.tdb[ycsb.VER_TABLE].wts.numpy()
        np.testing.assert_array_equal(
            ring[:-4], np.asarray(self.jdb[ycsb.VER_TABLE].wts)[:-4])
        return tv


def test_mvcc_serves_historical_bytes():
    """``tests/test_cc.py:252`` through both packages: committed stale
    reads return the version current at their ts, read-only txns the
    live snapshot; the checksums and the states agree."""
    m = _MvccEpochs()
    assert m.run([[5, 5]], [[True, True]], [10]).commit[0]
    assert m.run([[5, 5]], [[True, True]], [20]).commit[0]
    c0 = m.checksum()
    v = m.run([[5, 7], [5, 9], [5, 5]],
              [[False, True], [False, True], [False, False]], [5, 15, 30])
    assert v.commit[:3].all()
    got = (m.checksum() - c0) & 0xFFFFFFFF
    assert got == (m.f(5, 0) + m.f(5, 10) + 2 * m.f(5, 20)) & 0xFFFFFFFF


def test_mvcc_reader_behind_overwritten_writer_misses_its_version():
    """Pins the MVCC fault both packages share (ROADMAP.md queue 3): the
    ring keeps one version per row and epoch.  W (ts 10) and W' (ts 20)
    write key 5 in one epoch while T (ts 15) reads it; T waits behind W,
    both writers commit and only W' is stored.  Next epoch T commits
    reading f(5, 0), where serial order owes it W's f(5, 10).  When the
    fix lands this test must change to expect f(5, 10)."""
    m = _MvccEpochs()
    v = m.run([[5, 5], [5, 7], [5, 5]],
              [[True, True], [False, True], [True, True]], [10, 15, 20])
    assert v.commit[0] and v.commit[2] and v.defer[1] and not v.commit[1]
    ring = m.tdb[ycsb.VER_TABLE]
    assert sorted(ring.rows(torch.tensor([5]))[0].tolist()) == [0, 0, 0, 20]
    c0 = m.checksum()
    assert m.run([[5, 7]], [[False, True]], [15]).commit[0]
    got = (m.checksum() - c0) & 0xFFFFFFFF
    serial = m.f(5, 10)
    assert serial != m.f(5, 0)
    assert got == m.f(5, 0) and got != serial


def test_reference_state_carries_across():
    """`convert` carries MVCCState and the ring both ways, leaf for leaf."""
    args = BASE + ["--cc_alg=MVCC", "--sim_full_row=false"]
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    js = jax.device_get(jeng.init_state())
    js = dataclasses.replace(js, cc_state=dataclasses.replace(
        js.cc_state, his=np.arange(64 * 4, dtype=np.int32).reshape(64, 4)))
    ts = convert.from_reference_state(js, tcfg, "cpu")
    assert isinstance(ts.cc_state, timestamp.MVCCState)
    ref, got = convert.flatten_reference(js), convert.to_numpy_state(ts)
    assert "cc_state/his" in got and f"db/{ycsb.VER_TABLE}/wts" in got
    for path, want in ref.items():
        np.testing.assert_array_equal(got[path], want, err_msg=path)
