"""Port parity of the isolation audit plane: ``deneva_tpu_torch`` against
``deneva_tpu`` on the CPU.

* The helpers of ``deneva_tpu/cc/depgraph.py`` the audit adds
  (``next_writer``, the edge codecs, ``compact_lanes``,
  ``version_select``, ``witness_count``) on seeded random inputs.
* ``audit_observe`` on the scripted cases of ``tests/test_audit.py``
  (write skew, a clean set, an uncommitted side, forward and level
  visibility, escrow lanes, a self-RMW, cap overflow, stamps and
  digests, MVCC's version rings) and on random batches under every
  visibility rule, with and without MVCC rings, on and off the cadence.
  The stamp tables, ``cnt``, ``dropped`` and both digests are compared
  exactly; the edges and their buckets as sorted multisets, because the
  reference's unstable lane sort leaves the order of tied reads open
  (ROADMAP.md watch item 26).  The port's witness count equals the
  reference's ``witness_count`` of the exported edges when nothing was
  dropped.
* ``audit_mutate_verdict`` on the reference's scripted case (its
  end-to-end mutation test is red; the function is the oracle here).
* ``audit_init`` and the refusal of the CUDA path without a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.cc import AccessBatch as JBatch
from deneva_tpu.cc import audit_init as j_audit_init
from deneva_tpu.cc import audit_mutate_verdict as j_mutate
from deneva_tpu.cc import audit_observe as j_observe
from deneva_tpu.cc import build_conflict_incidence as j_build_inc
from deneva_tpu.cc import depgraph as jdg
from deneva_tpu.cc import get_backend as j_backend
from deneva_tpu.config import Config as JConfig
from deneva_tpu_torch.cc import (AUDIT_RW, AUDIT_WR, AUDIT_WW, AccessBatch,
                                 audit_init, audit_mutate_verdict,
                                 audit_observe, base,
                                 build_conflict_incidence, depgraph,
                                 get_backend)
from deneva_tpu_torch.config import Config

BASE = dict(audit=True, audit_cadence=1, audit_buckets=1024,
            audit_edges_max=64, cc_alg="OCC", epoch_batch=128,
            synth_table_size=1024)


def _cfgs(**kw):
    d = {**BASE, **kw}
    return JConfig(**d).validate(), Config(**d).validate()


def _scripted(scripts, b=8, a=2, order_free=None, ts=None):
    """Numpy batch from per-txn [(key, 'r'|'w'|'rw'), ...] scripts; txns
    past the scripts are inactive (``tests/test_audit.py:_batch``)."""
    keys = np.zeros((b, a), np.int32)
    is_r, is_w, valid = (np.zeros((b, a), bool) for _ in range(3))
    for i, script in enumerate(scripts):
        for s, (key, mode) in enumerate(script):
            keys[i, s] = key
            is_r[i, s] = "r" in mode
            is_w[i, s] = "w" in mode
            valid[i, s] = True
    active = np.zeros(b, bool)
    active[:len(scripts)] = True
    return dict(table_ids=np.zeros((b, a), np.int32), keys=keys,
                is_read=is_r, is_write=is_w, valid=valid,
                ts=np.arange(b, dtype=np.int32) if ts is None
                else np.full(b, ts, np.int32),
                rank=np.arange(b, dtype=np.int32), active=active,
                order_free=order_free)


def _random(rng, b, a, n_keys, order_free=False):
    arr = dict(table_ids=rng.integers(0, 3, (b, a)).astype(np.int32),
               keys=rng.integers(0, n_keys, (b, a)).astype(np.int32),
               is_read=rng.random((b, a)) < 0.7,
               is_write=rng.random((b, a)) < 0.5,
               valid=rng.random((b, a)) < 0.9,
               ts=rng.permutation(b).astype(np.int32) * 3 + 1,
               rank=rng.permutation(b).astype(np.int32),
               active=rng.random(b) < 0.9)
    arr["order_free"] = (rng.random((b, a)) < 0.2) if order_free else None
    return arr


def _both(arr):
    j = JBatch(**{k: None if v is None else jnp.asarray(v)
                  for k, v in arr.items()})
    t = AccessBatch(**{k: None if v is None else torch.from_numpy(v)
                       for k, v in arr.items()})
    return j, t


def _stamps_equal(jaud, taud):
    assert sorted(jaud) == sorted(taud)
    for f, want in jaud.items():
        np.testing.assert_array_equal(taud[f].numpy(), np.asarray(want),
                                      err_msg=f)


class Audit:
    """One audit state in both packages, carried side by side."""

    def __init__(self, **kw):
        self.jcfg, self.tcfg = _cfgs(**kw)
        self.jaud = j_audit_init(self.jcfg)
        self.taud = audit_init(self.tcfg)
        _stamps_equal(self.jaud, self.taud)

    def observe(self, arr, committed, lvl=None, order_vis=False, epoch=0,
                order=None):
        """Both packages' ``audit_observe``; asserts equal outputs and
        returns the port's sorted decoded edges, cnt, dropped, vdig,
        rdig and witness count."""
        b = arr["keys"].shape[0]
        jb, tb = _both(arr)
        committed = np.asarray(committed, bool)
        lvl = np.zeros(b, np.int32) if lvl is None \
            else np.asarray(lvl, np.int32)
        order = arr["rank"] if order is None else np.asarray(order, np.int32)
        jout = j_observe(self.jcfg, jb, jnp.asarray(committed),
                         jnp.asarray(order), jnp.asarray(lvl), order_vis,
                         self.jaud, jnp.int32(epoch))
        tout = audit_observe(self.tcfg, tb, torch.from_numpy(committed),
                             torch.from_numpy(order), torch.from_numpy(lvl),
                             order_vis, self.taud,
                             torch.tensor(epoch, dtype=torch.int32),
                             int(lvl.max()) + 1)
        jaud, jedges, jbkt, jcnt, jdrop, jvd, jrd = jout
        taud, tedges, tbkt, tcnt, tdrop, tvd, trd, twit = tout
        _stamps_equal(jaud, taud)
        assert int(tcnt) == int(jcnt) and int(tdrop) == int(jdrop)
        assert int(tvd) == int(jvd) and int(trd) == int(jrd)
        # the edges (with their buckets) as multisets
        want = sorted(zip(np.asarray(jedges).tolist(),
                          np.asarray(jbkt).tolist()))
        have = sorted(zip(tedges.tolist(), tbkt.tolist()))
        if int(jdrop) == 0:
            assert have == want
            assert int(twit) == int(jdg.witness_count(jedges,
                                                      jnp.asarray(lvl)))
        else:
            # which edges survive the cap depends on the tie order
            assert len(have) == len(want)
        self.jaud, self.taud = jaud, taud
        es = sorted((int(depgraph.edge_kind(e)), int(depgraph.edge_src(e)),
                     int(depgraph.edge_dst(e)))
                    for e in tedges[:min(int(tcnt), tedges.numel())])
        return es, int(tcnt), int(tdrop), int(tvd), int(trd), int(twit)


def _mask(b, ids):
    m = np.zeros(b, bool)
    m[list(ids)] = True
    return m


# -- the depgraph helpers -------------------------------------------------------

@pytest.mark.parametrize("seed,n,n_keys", [(0, 40, 5), (1, 300, 30),
                                           (2, 1000, 400)])
def test_scan_helpers_and_codecs_match_reference(seed, n, n_keys):
    rng = np.random.default_rng(seed)
    sk = np.sort(rng.integers(0, n_keys, n)).astype(np.int64)
    cand = np.where(rng.random(n) < 0.4, rng.integers(0, 50, n),
                    -1).astype(np.int32)
    jh, jt = jdg.segment_bounds(jnp.asarray(sk.astype(np.uint32)))
    th, tt = depgraph.segment_bounds(torch.from_numpy(sk))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for jfn, tfn, flags in ((jdg.prev_writer, depgraph.prev_writer, jh),
                            (jdg.next_writer, depgraph.next_writer, jt)):
        want = jfn(flags, jnp.asarray(cand))
        have = tfn(torch.from_numpy(np.array(flags)),
                   torch.from_numpy(cand))
        np.testing.assert_array_equal(have.numpy(), np.asarray(want))
    kind = rng.integers(0, 3, n).astype(np.int32)
    src = rng.integers(0, 16384, n).astype(np.int32)
    dst = rng.integers(0, 16384, n).astype(np.int32)
    je = jdg.pack_edge(jnp.asarray(kind), jnp.asarray(src), jnp.asarray(dst))
    te = depgraph.pack_edge(torch.from_numpy(kind), torch.from_numpy(src),
                            torch.from_numpy(dst))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    for jf, tf in ((jdg.edge_kind, depgraph.edge_kind),
                   (jdg.edge_src, depgraph.edge_src),
                   (jdg.edge_dst, depgraph.edge_dst)):
        np.testing.assert_array_equal(tf(te).numpy(), np.asarray(jf(je)))
    assert int(depgraph.pack_edge(AUDIT_RW, torch.tensor(3, dtype=torch.int32),
                                  torch.tensor(5, dtype=torch.int32))) \
        == int(jdg.pack_edge(2, jnp.int32(3), jnp.int32(5)))
    assert (AUDIT_WW, AUDIT_WR, AUDIT_RW) == (0, 1, 2)


@pytest.mark.parametrize("n,cap,p", [(50, 64, 0.3), (500, 64, 0.5),
                                     (300, 300, 1.0), (10, 64, 0.0)])
def test_compact_lanes_matches_reference(n, cap, p):
    rng = np.random.default_rng(n + cap)
    flags = rng.random(n) < p
    pay = (rng.integers(0, 2**30, n).astype(np.int32),
           rng.integers(0, 1024, n).astype(np.int32))
    (ja, jb), jc, jd = jdg.compact_lanes(
        jnp.asarray(flags), tuple(jnp.asarray(x) for x in pay), cap)
    (ta, tb), tc, td = depgraph.compact_lanes(
        torch.from_numpy(flags), tuple(torch.from_numpy(x) for x in pay),
        cap)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(tc) == int(jc) and int(td) == int(jd)


@pytest.mark.parametrize("seed,h", [(0, 1), (1, 4), (2, 8)])
def test_version_select_and_witness_count_match_reference(seed, h):
    rng = np.random.default_rng(seed)
    vts = rng.integers(-1, 30, (200, h)).astype(np.int32)
    vts[rng.random((200, h)) < 0.2] = -1
    vts[:20, :] = 7                      # ties: the first of equal maxima
    read_ts = rng.integers(-2, 35, 200).astype(np.int32)
    np.testing.assert_array_equal(
        depgraph.version_select(torch.from_numpy(vts),
                                torch.from_numpy(read_ts)).numpy(),
        np.asarray(jdg.version_select(jnp.asarray(vts),
                                      jnp.asarray(read_ts))))
    b = 64
    lvl = rng.integers(0, 3, b).astype(np.int32)
    edges = np.where(rng.random(300) < 0.8,
                     rng.integers(0, 3, 300) << 28
                     | rng.integers(0, b, 300) << 14
                     | rng.integers(0, b, 300), -1).astype(np.int32)
    assert int(depgraph.witness_count(torch.from_numpy(edges),
                                      torch.from_numpy(lvl))) \
        == int(jdg.witness_count(jnp.asarray(edges), jnp.asarray(lvl)))


def test_audit_init_matches_reference():
    for alg in ("OCC", "MVCC"):
        jcfg, tcfg = _cfgs(cc_alg=alg, mvcc_his_len=3)
        _stamps_equal(j_audit_init(jcfg), audit_init(tcfg))
    assert "vts" not in audit_init(_cfgs()[1])


# -- the scripted cases of tests/test_audit.py -----------------------------------

def test_snapshot_write_skew_two_rw_cycle():
    au = Audit()
    es, _, drop, *_ = au.observe(
        _scripted([[(10, "r"), (20, "w")], [(20, "r"), (10, "w")]]),
        _mask(8, [0, 1]))
    assert es == [(2, 0, 1), (2, 1, 0)] and drop == 0


def test_clean_set_and_uncommitted_side():
    au = Audit()
    es, cnt, *_ = au.observe(
        _scripted([[(10, "r"), (20, "w")], [(30, "r"), (40, "w")]]),
        _mask(8, [0, 1]))
    assert es == [] and cnt == 0
    es, *_ = au.observe(
        _scripted([[(10, "r"), (20, "w")], [(20, "r"), (10, "w")]]),
        _mask(8, [0]))
    assert es == []


def test_forward_and_level_visibility():
    au = Audit()
    es, *_ = au.observe(_scripted([[(5, "w")], [(5, "r")], [(5, "w")]]),
                        _mask(8, [0, 1, 2]), order_vis=True)
    assert es == [(0, 0, 2), (1, 0, 1), (2, 1, 2)]
    es, *_ = au.observe(
        _scripted([[(5, "w"), (7, "r")], [(5, "r"), (7, "w")]]),
        _mask(8, [0, 1]), lvl=[0, 1, 0, 0, 0, 0, 0, 0])
    assert es == [(1, 0, 1), (2, 0, 1)]


def test_escrow_lanes_and_self_rmw_emit_nothing():
    au = Audit()
    of = np.zeros((8, 2), bool)
    of[0] = of[1] = True
    es, *_ = au.observe(
        _scripted([[(10, "r"), (20, "w")], [(20, "r"), (10, "w")]],
                  order_free=of), _mask(8, [0, 1]))
    assert es == []
    es, *_ = au.observe(_scripted([[(5, "rw")]]), _mask(8, [0]),
                        order_vis=True)
    assert es == []


def test_edge_cap_overflow_counted():
    au = Audit(epoch_batch=64)
    es, cnt, drop, *_ = au.observe(
        _scripted([[(5, "r"), (5, "w")] for _ in range(40)], b=64),
        _mask(64, range(40)))
    assert cnt > 64 and drop == cnt - 64 and len(es) == 64


def test_stamps_and_digests():
    au = Audit()
    w, r = _scripted([[(5, "w")]]), _scripted([[(5, "r")]])
    fresh = au.observe(r, _mask(8, [0]))[4]
    au.observe(w, _mask(8, [0]), epoch=3)
    assert int(au.taud["epoch"].max()) == 3
    assert au.observe(r, _mask(8, [0]))[4] != fresh


def test_mvcc_version_rings():
    au = Audit(cc_alg="MVCC")
    for e, wts in ((1, 10), (2, 20), (3, 30), (4, 40), (5, 50)):
        au.observe(_scripted([[(5, "w")], [(9, "w")]], ts=wts),
                   _mask(8, [0, 1]), epoch=e)
    digs = {ts: au.observe(_scripted([[(5, "r")]], ts=ts), _mask(8, [0]))[4]
            for ts in (5, 25, 35, 99)}
    assert len(set(digs.values())) == 4


@pytest.mark.parametrize("cadence,epochs", [(1, (0, 1)), (8, (3, 8, 16))])
def test_cadence_gate(cadence, epochs):
    au = Audit(audit_cadence=cadence)
    arr = _scripted([[(10, "r"), (20, "w")], [(20, "r"), (10, "w")]])
    for e in epochs:
        es, cnt, drop, vd, rd, _ = au.observe(arr, _mask(8, [0, 1]), epoch=e)
        due = e % cadence == 0
        assert (cnt > 0) == due and (vd != 0) == due


# -- random batches ----------------------------------------------------------------

CASES = [
    # (seed, b, a, n_keys, order_vis, lvl levels, order_free, alg, cap)
    (0, 32, 4, 12, False, 1, False, "OCC", 64),
    (1, 64, 6, 40, True, 1, False, "TPU_BATCH", 512),
    (2, 64, 6, 30, False, 4, True, "TPU_BATCH", 512),
    (3, 128, 4, 60, False, 3, False, "OCC", 64),
    (4, 64, 4, 20, False, 1, False, "MVCC", 1024),
    (5, 128, 8, 500, False, 32, False, "DGCC", 4096),
    (6, 16, 2, 3, True, 1, True, "CALVIN", 64),
]


@pytest.mark.parametrize("seed,b,a,n_keys,order_vis,levels,order_free,alg,cap",
                         CASES)
def test_random_batches_match_reference(seed, b, a, n_keys, order_vis, levels,
                                        order_free, alg, cap):
    rng = np.random.default_rng(seed)
    au = Audit(cc_alg=alg, epoch_batch=b, audit_edges_max=cap,
               mvcc_his_len=3)
    for e in range(4):
        arr = _random(rng, b, a, n_keys, order_free)
        committed = arr["active"] & (rng.random(b) < 0.7)
        lvl = np.where(committed, rng.integers(0, levels, b), 0)
        order = rng.integers(0, b // 2, b).astype(np.int32)   # ties too
        au.observe(arr, committed, lvl, order_vis, epoch=e, order=order)


RANK_EDGES = ["equal_orders", "negative_orders", "committed_int32_max",
              "none_committed", "all_committed", "ragged_b"]


def _rank_case(case, rng):
    """(arr, committed, order) of one of K17's rank edge cases, at B = 37:
    no multiple of any tile of the kernel's (``ragged_b`` is the plain
    random case)."""
    b = 37
    arr = _random(rng, b, 3, 15)
    committed = arr["active"] & (rng.random(b) < 0.7)
    order = rng.integers(0, b // 4, b).astype(np.int32)
    if case == "equal_orders":
        order[:] = 5
    elif case == "negative_orders":
        order = rng.integers(-4, 4, b).astype(np.int32)
        order[rng.random(b) < 0.2] = -2**31
    elif case == "committed_int32_max":
        # ties the uncommitted txns' key: ordered among them by index
        order[rng.random(b) < 0.4] = 2**31 - 1
    elif case == "none_committed":
        committed[:] = False
    elif case == "all_committed":
        arr["active"][:] = True
        committed[:] = True
    return arr, committed, order


@pytest.mark.parametrize("case", RANK_EDGES)
def test_rank_edge_cases_match_reference(case):
    """K17's rank where it is easy to get wrong, through the whole audit
    (forwarding visibility, so every read's position carries the rank)
    against the reference, and the rank alone against numpy's stable
    argsort."""
    rng = np.random.default_rng(RANK_EDGES.index(case))
    arr, committed, order = _rank_case(case, rng)
    b = order.shape[0]
    au = Audit(cc_alg="TPU_BATCH", epoch_batch=64, audit_edges_max=4096)
    au.observe(arr, committed, None, True, epoch=1, order=order)
    key = np.where(committed, order, 2**31 - 1)
    want = np.empty(b, np.int32)
    want[np.argsort(key, kind="stable")] = np.arange(b)
    have = base.audit_rank(torch.from_numpy(committed),
                           torch.from_numpy(order))
    np.testing.assert_array_equal(have.numpy(), want)


def test_rank_at_the_audits_largest_batch():
    """The rank at the largest ``epoch_batch`` the audit takes (16,384),
    with many ties and committed txns at ``INT32_MAX``, against numpy's
    stable argsort."""
    rng = np.random.default_rng(16384)
    b = 16384
    committed = rng.random(b) < 0.8
    order = rng.integers(-64, 64, b).astype(np.int32)
    order[rng.random(b) < 0.05] = 2**31 - 1
    key = np.where(committed, order, 2**31 - 1)
    want = np.empty(b, np.int32)
    want[np.argsort(key, kind="stable")] = np.arange(b)
    have = base.audit_rank(torch.from_numpy(committed),
                           torch.from_numpy(order))
    np.testing.assert_array_equal(have.numpy(), want)


def test_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        from deneva_tpu_torch import kernels
        kernels.resolve_device("cuda")


# -- the seeded mutation ------------------------------------------------------------

def test_mutate_flips_only_clean_losers_inside_window():
    kw = dict(audit_mutate="occ-read-skip:7:2", epoch_batch=8,
              conflict_buckets=256)
    jcfg, tcfg = _cfgs(**kw)
    arr = _scripted([[(5, "w")], [(5, "r"), (9, "w")],
                     [(5, "r"), (5, "w")]])
    jb, tb = _both(arr)
    jbe, tbe = j_backend("OCC"), get_backend("OCC")
    jinc = j_build_inc(jcfg, jbe, jb, None)
    tinc = build_conflict_incidence(tcfg, tbe, tb, None)
    jv, _ = jbe.validate(jcfg, jbe.init_state(jcfg), jb, jinc)
    tv, _ = tbe.validate(tcfg, tbe.init_state(tcfg, "cpu"), tb, tinc)
    for epoch in (6, 7, 8, 9):
        jo = j_mutate(jcfg, jb, jinc, jv, jnp.int32(epoch))
        to = audit_mutate_verdict(tcfg, tb, tinc, tv,
                                  torch.tensor(epoch, dtype=torch.int32))
        for f in ("commit", "abort", "defer", "order", "level"):
            np.testing.assert_array_equal(getattr(to, f).numpy(),
                                          np.asarray(getattr(jo, f)))
        flipped = bool(to.commit[1])
        assert flipped == (epoch in (7, 8))
        assert bool(to.abort[2])               # a dirty write stays aborted


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutate_random_batches_match_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(audit_mutate="occ-read-skip:0:1", epoch_batch=64,
              conflict_buckets=64, conflict_exact=seed != 1)
    jcfg, tcfg = _cfgs(**kw)
    arr = _random(rng, 64, 4, 30, order_free=seed == 2)
    jb, tb = _both(arr)
    jbe, tbe = j_backend("OCC"), get_backend("OCC")
    jinc = j_build_inc(jcfg, jbe, jb, jb.order_free)
    tinc = build_conflict_incidence(tcfg, tbe, tb, tb.order_free)
    jv, _ = jbe.validate(jcfg, jbe.init_state(jcfg), jb, jinc)
    tv, _ = tbe.validate(tcfg, tbe.init_state(tcfg, "cpu"), tb, tinc)
    jo = j_mutate(jcfg, jb, jinc, jv, jnp.int32(0))
    to = audit_mutate_verdict(tcfg, tb, tinc, tv,
                              torch.tensor(0, dtype=torch.int32))
    np.testing.assert_array_equal(to.commit.numpy(), np.asarray(jo.commit))
    np.testing.assert_array_equal(to.abort.numpy(), np.asarray(jo.abort))
    assert int(to.commit.sum()) > int(tv.commit.sum())


def test_mutation_view_is_built_for_every_backend_gate():
    """Under ``audit_mutate`` the write view is part of the incidence even
    where validation reads no view (the repair rule, watch item 25)."""
    tcfg = Config(**{**BASE, "audit_mutate": "occ-read-skip:0",
                     "conflict_buckets": 64}).validate()
    be = dataclasses.replace(get_backend("OCC"), views=lambda cfg: ())
    arr = _scripted([[(5, "w")], [(5, "r")]])
    inc = build_conflict_incidence(tcfg, be, _both(arr)[1], None)
    assert inc is not None and inc.w1 is not None
