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
