"""Port parity of the DGCC wavefront backend: ``deneva_tpu_torch`` against
``deneva_tpu`` on the CPU, exactly.

* K15a's plain version against ``depgraph.lane_sort``, and the scan
  helpers (``segment_bounds``, ``prev_writer``, ``seg_excl_max``) and
  K15b's plain census against the reference's, on seeded random lane
  sets built as DGCC builds them.
* ``dgcc_levels`` (K15a, K15b, K16's plain versions) against the
  reference's on random batches with inactive txns, ``order_free``
  lanes, a key that combines to ``LANE_PAD`` (ROADMAP.md watch item 23:
  it must be dead, not sorted first), a hot chain deeper than ``dgcc_levels``,
  and ``dgcc_levels=1``.
* ``dgcc_levels`` at ``dgcc_contention``'s shape (B = 2,048, 10
  requests, 90% writes, zipf 0.9 from one numpy bank) against the
  reference's.
* A numpy model of K16 as its cluster runs it (each thread's run of the
  lanes up to the last live one, the segment ids by a prefix count of
  heads, each CTA's block scan and the carry from the lower CTAs, each
  CTA's candidates merged over every CTA's copy) held against the plain
  version at 1, 2, 4 and 8 CTAs of 4, 32 and 1,024 threads.
* The reference's scripted cases (``tests/test_dgcc.py:37-122``) through
  both packages, with the reference's assertions on the port's verdict.
* The refusal of the CUDA path without a card, and of a device that is
  neither the CPU nor CUDA.

Whole epochs and the driver's lines are in test_torch_dgcc_epochs.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cc import check_verdict
from test_torch_dgcc_epochs import YCSB
from test_torch_timestamp import Both, _batch_np

from deneva_tpu.cc import AccessBatch as JBatch
from deneva_tpu.cc import depgraph as jdg
from deneva_tpu.cc.dgcc import dgcc_levels as j_dgcc_levels
from deneva_tpu.config import Config as JConfig
from deneva_tpu_torch.cc import AccessBatch, depgraph, dgcc, get_backend
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.driver import run_simulation
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.ops.hashing import MULTS
from deneva_tpu_torch.workloads import get_workload

# the int32 key whose combine_key with table 0 is LANE_PAD
PAD_KEY = np.uint32(0xFFFFFFFF * pow(MULTS[0], -1, 1 << 32)
                    % (1 << 32)).view(np.int32).item()


def _np_batch(rng, b, a, n_keys, order_free=False, pad_key=False):
    arr = dict(table_ids=np.zeros((b, a), np.int32),
               keys=rng.integers(0, n_keys, (b, a)).astype(np.int32),
               is_read=rng.random((b, a)) < 0.6,
               is_write=rng.random((b, a)) < 0.5,
               valid=rng.random((b, a)) < 0.9,
               ts=(rng.permutation(b) + 1).astype(np.int32),
               rank=rng.permutation(b).astype(np.int32),
               active=rng.random(b) < 0.85)
    if pad_key:
        arr["keys"][rng.random((b, a)) < 0.1] = PAD_KEY
    arr["order_free"] = (rng.random((b, a)) < 0.2) if order_free else None
    return arr


def _both(arr):
    j = JBatch(**{k: None if v is None else jnp.asarray(v)
                  for k, v in arr.items()})
    t = AccessBatch(**{k: None if v is None else torch.from_numpy(v)
                       for k, v in arr.items()})
    return j, t


def test_pad_key_combines_to_the_sentinel():
    from deneva_tpu_torch.ops.hashing import combine_key
    k = combine_key(0, torch.tensor([PAD_KEY], dtype=torch.int32))
    assert int(k) == depgraph.LANE_PAD


# -- K15a, K15b ----------------------------------------------------------------

@pytest.mark.parametrize("seed,b,a,n_keys", [(0, 16, 4, 6), (1, 64, 8, 40),
                                             (2, 200, 10, 3000)])
def test_lane_sort_and_scans_match_reference(seed, b, a, n_keys):
    rng = np.random.default_rng(seed)
    _, tb = _both(_np_batch(rng, b, a, n_keys, order_free=seed == 1,
                            pad_key=True))
    keys, pos, tid = dgcc.lanes(tb)
    assert int(keys.max()) == depgraph.LANE_PAD
    sk, sp, sid = depgraph.lane_sort(keys, pos, tid, b)
    jk, jp, jt = jdg.lane_sort(jnp.asarray(keys.numpy().astype(np.uint32)),
                               jnp.asarray(pos.numpy()),
                               jnp.asarray(tid.numpy()))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(sid.numpy(), np.asarray(jt))
    # the helpers, op for op
    head, tail = depgraph.segment_bounds(sk)
    jhead, jtail = jdg.segment_bounds(jk)
    np.testing.assert_array_equal(head.numpy(), np.asarray(jhead))
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
    vals = rng.integers(-1, 9, sk.shape[0]).astype(np.int32)
    np.testing.assert_array_equal(
        depgraph.seg_excl_max(head, torch.from_numpy(vals)).numpy(),
        np.asarray(jdg.seg_excl_max(jhead, jnp.asarray(vals))))
    # K15b's census against the reference's composition (dgcc.py:106-122)
    h, pw, pr, edges = depgraph.census(sk, sp, sid)
    sw = (np.asarray(jp) & 1) == 1
    live = np.asarray(jk) != np.uint32(jdg.LANE_PAD)
    jsid = np.asarray(jt)
    jpw = np.asarray(jdg.prev_writer(jhead, jnp.asarray(
        np.where(sw & live, jsid, -1).astype(np.int32))))
    jpr = np.asarray(jdg.prev_writer(jhead, jnp.asarray(
        np.where(~sw & live, jsid, -1).astype(np.int32))))
    dep = live & (((jpw >= 0) & (jpw != jsid))
                  | (sw & (jpr >= 0) & (jpr != jsid)))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jhead))
    np.testing.assert_array_equal(pw.numpy(), jpw)
    np.testing.assert_array_equal(pr.numpy(), jpr)
    assert int(edges) == int(dep.sum()) > 0


# -- K16 and the wave assignment ----------------------------------------------

LEVEL_CASES = [
    # (seed, b, a, n_keys, dgcc_levels, order_free, pad_key)
    (0, 32, 4, 8, 32, False, True),
    (1, 64, 6, 12, 4, True, False),
    (2, 128, 4, 5, 32, False, False),     # hot chains past the budget
    (3, 48, 4, 10, 1, False, True),
    (4, 200, 8, 400, 32, True, True),
]


@pytest.mark.parametrize("case", LEVEL_CASES, ids=[
    f"b{c[1]}-keys{c[3]}-levels{c[4]}-of{int(c[5])}" for c in LEVEL_CASES])
def test_dgcc_levels_match_reference(case):
    seed, b, a, n_keys, levels, of, pad = case
    cfg = SimpleNamespace(dgcc_levels=levels)
    jb, tb = _both(_np_batch(np.random.default_rng(seed), b, a, n_keys, of,
                             pad))
    jlv, jov, jedges = j_dgcc_levels(cfg, jb)
    lv, ov, edges = dgcc.dgcc_levels(cfg, tb)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    assert int(edges) == int(jedges)
    if seed == 2:
        assert ov.any() and (lv >= levels).any()   # saturation defers


def _contention_batch(b=2048, a=10, theta=0.9, n_rows=1 << 20, seed=9):
    """A ``dgcc_contention``-shaped batch: ``a`` requests a txn, 90%
    writes, keys from numpy's zipf law at ``theta``, every txn active."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_rows + 1, dtype=np.float64) ** theta
    keys = rng.choice(n_rows, size=(b, a), p=p / p.sum()).astype(np.int32)
    w = rng.random((b, a)) < 0.9
    return dict(table_ids=np.zeros((b, a), np.int32), keys=keys,
                is_read=~w, is_write=w, valid=np.ones((b, a), bool),
                ts=np.arange(1, b + 1, dtype=np.int32),
                rank=np.arange(b, dtype=np.int32),
                active=np.ones(b, bool), order_free=None)


def test_dgcc_levels_match_reference_at_contention_shape():
    cfg = SimpleNamespace(dgcc_levels=Config().dgcc_levels)
    jb, tb = _both(_contention_batch())
    jlv, jov, jedges = j_dgcc_levels(cfg, jb)
    lv, ov, edges = dgcc.dgcc_levels(cfg, tb)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    assert int(edges) == int(jedges)
    assert int(lv.max()) > 4 and ov.any()       # deep chains, saturation


def _run_excl_max(vals, run, start):
    """Exclusive running max of ``vals`` (>= -1) inside each run (``run``
    ascending, one id a lane), each run starting from ``start[run]``."""
    if run.size == 0:
        return vals
    z = run.astype(np.int64) << 32 | (vals + 1)
    incl = np.maximum.accumulate(z)
    excl = np.concatenate([[-1], incl[:-1]])
    prev = np.where((excl >> 32) == run, (excl & 0xFFFFFFFF) - 1, -1)
    prev[np.r_[True, run[1:] != run[:-1]]] = -1
    return np.maximum(prev, start[run])


def k16_cluster_model(head, sid, sw, live, b: int, rounds: int, ctas: int,
                      threads: int):
    """K16 as ``csrc/depgraph.cu`` runs it in a cluster of ``ctas`` CTAs of
    ``threads`` threads, in numpy: the lanes up to the last live one split
    into equal contiguous runs, a run a thread; segment ids from a prefix
    count of heads (each thread's heads, scanned over the block, plus the
    lower CTAs' totals); per round, each run's writer / reader maxima of
    seg << 10 | lv + 1, a block exclusive max-scan with the lower CTAs'
    totals as carry, the candidates into the CTA's own nxt, then the max
    over every CTA's copy.  Returns (lv, changed, rounds run)."""
    head, sid, sw, live = (np.asarray(x) for x in (head, sid, sw, live))
    n_end = int(np.nonzero(live)[0].max()) + 1 if live.any() else 0
    nthr = ctas * threads
    per = max(-(-n_end // nthr), 1)
    lane = np.arange(n_end)
    run = lane // per                     # the thread holding the lane
    cta = run // threads
    head, sid, sw, live = head[:n_end], sid[:n_end], sw[:n_end], live[:n_end]
    # a thread's heads, its block's inclusive scan, the lower CTAs' totals
    h = np.bincount(run, weights=head, minlength=nthr).astype(np.int64)
    incl = np.cumsum(h.reshape(ctas, threads), axis=1)
    carry = np.concatenate([[0], np.cumsum(incl[:, -1])[:-1]])
    s_base = (carry[:, None] + incl).reshape(-1) - h - 1
    cs = np.cumsum(head)                  # heads through each lane of a run
    first = run * per
    seg = s_base[run] + cs - cs[first] + head[first]

    def thread_max(x):
        m = np.full(nthr, -1, np.int64)
        np.maximum.at(m, run, x)
        return m

    def block_carry(m):
        """Exclusive max over the threads of each CTA, then the lower
        CTAs' totals."""
        m = m.reshape(ctas, threads)
        excl = np.concatenate([np.full((ctas, 1), -1), np.maximum.accumulate(
            m, axis=1)[:, :-1]], axis=1)
        tot = m.max(axis=1)
        carry = np.concatenate([[-1], np.maximum.accumulate(tot)[:-1]])
        return np.maximum(excl, carry[:, None]).reshape(-1)
    lv = np.zeros(b, np.int64)
    changed, it = True, 0
    while changed and it < 2 * rounds + 4:
        e = np.where(live, seg << 10 | (lv[sid] + 1), -1)
        cw = block_carry(thread_max(np.where(sw, e, -1)))
        cr = block_carry(thread_max(np.where(~sw, e, -1)))
        lw = _run_excl_max(np.where(sw, e, -1), run, cw)
        lr = _run_excl_max(np.where(~sw, e, -1), run, cr)
        s = e >> 10
        exw = np.where(lw >> 10 == s, (lw & 1023) - 1, -1)
        exr = np.where(lr >> 10 == s, (lr & 1023) - 1, -1)
        cand = np.minimum(np.where(sw, np.maximum(np.maximum(exw, exr), 0),
                                   np.where(exw >= 0, exw + 1, 0)), rounds)
        copies = np.repeat(lv[None], ctas, axis=0)
        for c in range(ctas):
            m = live & (cta == c)
            np.maximum.at(copies[c], sid[m], cand[m])
        merged = copies.max(axis=0)
        changed = bool((merged != lv).any())
        lv, it = merged, it + 1
    return lv, changed, it


def _blind_chain(b):
    """Txn 1 reads txn 0's write (wave 1); txn i >= 2 writes key i - 1
    after txn i - 1 and key i before txn i + 1: blind writes that carry
    wave 1 one txn a round, past any budget under b rounds."""
    i = np.arange(b, dtype=np.int32)
    w = np.ones((b, 2), bool)
    w[1, 0] = False
    valid = np.ones((b, 2), bool)
    valid[0, 1] = False
    return dict(table_ids=np.zeros((b, 2), np.int32),
                keys=np.stack([np.maximum(i - 1, 0), i], 1), is_read=~w,
                is_write=w, valid=valid, ts=i + 1, rank=i,
                active=np.ones(b, bool), order_free=None)


def _relax_inputs(arr, levels):
    _, tb = _both(arr)
    sk, sp, sid = depgraph.lane_sort(*dgcc.lanes(tb), tb.shape[0])
    head, *_ = depgraph.census(sk, sp, sid)
    return head, sid, (sp & 1) == 1, sk != depgraph.LANE_PAD


RELAX_MODEL_CASES = {
    "random": lambda: (_np_batch(np.random.default_rng(3), 200, 6, 50),
                       32),
    "hot_key": lambda: (_np_batch(np.random.default_rng(4), 150, 4, 1), 32),
    "no_live": lambda: (dict(_np_batch(np.random.default_rng(5), 64, 4, 9),
                             active=np.zeros(64, bool)), 4),
    "budget_cut": lambda: (_blind_chain(128), 2),
    "contention": lambda: (_contention_batch(b=512, a=10), 32),
}


@pytest.mark.parametrize("threads", [4, 32, 1024])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(RELAX_MODEL_CASES))
def test_relax_cluster_model_matches_plain(case, ctas, threads):
    arr, levels = RELAX_MODEL_CASES[case]()
    b = arr["active"].shape[0]
    head, sid, sw, live = _relax_inputs(arr, levels)
    want = dgcc.relax_plain(head, sid, sw, live, b, levels)
    got = k16_cluster_model(head.numpy(), sid.numpy().astype(np.int64),
                            sw.numpy(), live.numpy(), b, levels, ctas,
                            threads)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert got[1] == bool(want[1]) and got[2] == int(want[2])
    if case == "budget_cut":
        assert got[1]       # the 2 * levels + 4 budget cut it


def test_sentinel_key_is_dead():
    """Watch item 23: a writer and a reader of the key that combines to
    LANE_PAD carry no edge, as in the reference; the same script on an
    ordinary key chains the reader into wave 1."""
    for key, want in ((PAD_KEY, 0), (77, 1)):
        v = Both("DGCC").run([[(key, "w")], [(key, "r")]])
        assert v["commit"][:2].all() and v["level"][1] == want


def test_relax_saturates_at_the_clamp():
    """A 12-deep rw chain: under a budget of 2 levels the candidates clamp
    and the relaxation still reaches its fixpoint; under 256 the levels
    are the exact chain depths."""
    txns = [[(5, "rw")] for _ in range(12)]
    arr = {k: torch.from_numpy(v) for k, v in _batch_np(txns).items()}
    tb = AccessBatch(**arr)
    keys, pos, tid = dgcc.lanes(tb)
    sk, sp, sid = depgraph.lane_sort(keys, pos, tid, 16)
    head, *_ = depgraph.census(sk, sp, sid)
    sw, live = (sp & 1) == 1, sk != depgraph.LANE_PAD
    lv, changed, iters = dgcc.relax(head, sid, sw, live, 16, 2)
    assert bool(changed) is False and int(lv.max()) == 2
    assert int(iters) <= 2 * 2 + 4
    lv, changed, iters = dgcc.relax_plain(head, sid, sw, live, 16, 256)
    assert int(lv[11]) == 11 and not bool(changed) and int(iters) > 11


# -- the scripted cases of tests/test_dgcc.py:37-122 --------------------------

def _check(v, txns):
    verdict = SimpleNamespace(**v)
    batch = SimpleNamespace(active=np.arange(16) < len(txns))
    return check_verdict(verdict, batch, txns, chained=True)


def test_chain_levels_exact():
    txns = [[(5, "w")], [(5, "rw")], [(5, "r")], [(9, "r")]]
    v = Both("DGCC").run(txns)
    c, a, d = _check(v, txns)
    assert c[:4].all() and not a.any() and not d.any()
    assert list(v["level"][:4]) == [0, 1, 2, 0]


def test_wr_forces_next_wave():
    txns = [[(5, "w")], [(5, "r")]]
    v = Both("DGCC").run(txns)
    c, a, _ = _check(v, txns)
    assert c[:2].all() and not a.any()
    assert list(v["level"][:2]) == [0, 1]


def test_rw_antidep_shares_wave():
    txns = [[(5, "r")], [(5, "w")]]
    v = Both("DGCC").run(txns)
    c, a, _ = _check(v, txns)
    assert c[:2].all() and not a.any()
    assert list(v["level"][:2]) == [0, 0]


def test_blind_ww_shares_wave_distinct_order():
    txns = [[(5, "w")], [(5, "w")]]
    v = Both("DGCC").run(txns)
    c, a, d = _check(v, txns)
    assert c[:2].all() and not a.any() and not d.any()
    assert list(v["level"][:2]) == [0, 0]
    assert v["order"][0] != v["order"][1]


def test_overdeep_closure_defers_never_aborts():
    txns = [[(5, "rw")] for _ in range(10)]
    v = Both("DGCC", dgcc_levels=4).run(txns)
    c, a, d = _check(v, txns)
    assert not a.any() and c[:4].all() and d[4:].all()
    assert list(v["level"][:4]) == [0, 1, 2, 3]


def test_dependent_of_saturated_txn_defers():
    txns = [[(5, "rw")] for _ in range(6)] + [[(5, "r")], [(9, "r")]]
    v = Both("DGCC", dgcc_levels=4).run(txns)
    c, a, d = _check(v, txns)
    assert not a.any() and d[6] and not d[7] and c[7]
    assert v["level"][7] == 0


def test_order_free_lanes_exempt_commit_wave_zero():
    txns = [[(7, "rw")] for _ in range(5)]
    arr = _batch_np(txns)
    arr["order_free"] = arr["valid"].copy()
    jb, tb = _both(arr)
    kw = dict(epoch_batch=16, max_accesses=4, req_per_query=4,
              synth_table_size=1024)
    jv, _ = get_backend("DGCC").validate(Config(**kw), (), tb)
    from deneva_tpu.cc.dgcc import validate_dgcc as j_validate
    rv, _ = j_validate(JConfig(**kw), (), jb)
    for f in ("commit", "abort", "defer", "order", "level"):
        np.testing.assert_array_equal(getattr(jv, f).numpy(),
                                      np.asarray(getattr(rv, f)), f)
    assert jv.commit[:5].all() and not jv.defer.any()
    assert (jv.level[:5] == 0).all()


def test_randomized_verdicts_match_reference():
    rng = np.random.default_rng(1234)
    be = Both("DGCC")
    for _ in range(6):
        txns = [[(int(rng.integers(0, 8)), str(rng.choice(["r", "w", "rw"])))
                 for _ in range(int(rng.integers(1, 5)))] for _ in range(12)]
        v = be.run(txns)
        _check(v, txns)
        assert not v["abort"].any() and v["commit"].sum() >= 1


def test_dgcc_and_repair_need_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for extra in (["--cc_alg=DGCC"], ["--cc_alg=OCC", "--repair=true"]):
        cfg = Config.from_args(YCSB[:-1] + extra)
        with pytest.raises(RuntimeError, match="CUDA"):
            run_simulation(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(cfg, get_workload(cfg, device="cpu"), device="cuda")


def test_dgcc_wrappers_take_no_other_device():
    """On tensors that lie neither on the CPU nor on CUDA each wrapper
    raises rather than run its plain version."""
    m = torch.zeros(8, dtype=torch.int32, device="meta")
    mk = torch.zeros(8, dtype=torch.int64, device="meta")
    mb = torch.zeros(8, dtype=torch.bool, device="meta")
    for call in (lambda: depgraph.lane_sort(mk, m, m, 4),
                 lambda: depgraph.census(mk, m, m),
                 lambda: dgcc.relax(mb, m, mb, mb, 4, 2)):
        with pytest.raises(ValueError, match="devices"):
            call()
