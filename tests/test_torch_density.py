"""Port parity of the metrics plane's conflict density (K13b's plain
version) against ``deneva_tpu.cc.conflict_density`` on the CPU, exactly.

* Both of the reference's arms — column sums of an incidence, and the
  forwarding backends' bucket scatter-adds — at one and two partitions,
  on seeded random batches with inactive txns, lanes that neither read
  nor write (where the two arms' touch rules part), txns revisiting their
  own bucket, RMW lanes and ``order_free`` lanes.
* The reference's scripted case (``tests/test_metricsbus.py``): write
  contention lands in its owner partition, solo reads stay zero, the
  arms agree, inactive txns contribute nothing.
* Through the engine: the counter stays 0 with ``metrics`` off, equals
  the reference's leaf by leaf with it on (forwarding, sweep and DGCC),
  and ranks OCC's contention like its aborts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _inject
from test_torch_repair import zipf_bank

from deneva_tpu.cc import AccessBatch as JBatch
from deneva_tpu.cc import build_incidence as j_build_incidence
from deneva_tpu.cc import conflict_density as j_density
from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.cc import AccessBatch, base
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.workloads import get_workload


def _np_batch(rng, b, a, n_keys, order_free=False):
    keys = rng.integers(0, n_keys, (b, a)).astype(np.int32)
    # a txn revisiting its own key, and its own bucket under another key
    keys[: b // 4, 1] = keys[: b // 4, 0]
    arr = dict(table_ids=rng.integers(0, 2, (b, a)).astype(np.int32),
               keys=keys, is_read=rng.random((b, a)) < 0.7,
               is_write=rng.random((b, a)) < 0.5,
               valid=rng.random((b, a)) < 0.9,
               ts=np.arange(b, dtype=np.int32),
               rank=rng.permutation(b).astype(np.int32),
               active=rng.random(b) < 0.85)
    arr["order_free"] = (rng.random((b, a)) < 0.3) if order_free else None
    return arr


def _both(arr):
    j = JBatch(**{k: None if v is None else jnp.asarray(v)
                  for k, v in arr.items()})
    t = AccessBatch(**{k: None if v is None else torch.from_numpy(v)
                       for k, v in arr.items()})
    return j, t


def _density_both(arr, part_cnt, k, exact, owner):
    kw = dict(part_cnt=part_cnt, conflict_buckets=k)
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    jb, tb = _both(arr)
    jo, to = jnp.asarray(owner), torch.from_numpy(owner)
    out = {}
    for arm in (False, True):
        inc = j_build_incidence(jb, k, exact, order_free=jb.order_free) \
            if arm else None
        want = np.asarray(j_density(jcfg, jb, jo, inc))
        have = base.conflict_density(tcfg, tb, to, arm)
        assert have.dtype == torch.int32
        np.testing.assert_array_equal(have.numpy(), want)
        out[arm] = want
    return out


@pytest.mark.parametrize("seed,b,a,n_keys,k,p,exact,order_free", [
    (0, 64, 4, 30, 256, 1, True, False),
    (1, 128, 8, 500, 1024, 2, False, True),
    (2, 32, 16, 7, 64, 2, True, False),
    (3, 200, 10, 5000, 64, 1, False, False),
    (4, 16, 2, 3, 8, 2, True, True)])
def test_density_matches_reference_both_arms(seed, b, a, n_keys, k, p, exact,
                                             order_free):
    rng = np.random.default_rng(seed)
    arr = _np_batch(rng, b, a, n_keys, order_free)
    owner = (arr["keys"] % p).astype(np.int32)
    out = _density_both(arr, p, k, exact, owner)
    assert out[False].sum() > 0


def test_rmw_lanes_and_owner_fold():
    """An RMW lane writes and reads; owners outside [0, P) count nowhere;
    a txn's own repeated lanes never contend with themselves."""
    arr = dict(table_ids=np.zeros((4, 3), np.int32),
               keys=np.array([[1, 1, 9], [1, 4, 4], [6, 6, 6], [8, 2, 2]],
                             np.int32),
               is_read=np.array([[1, 0, 1], [1, 1, 0], [1, 1, 1],
                                 [1, 1, 1]], bool),
               is_write=np.array([[1, 1, 0], [0, 1, 1], [1, 1, 1],
                                  [0, 1, 0]], bool),
               valid=np.ones((4, 3), bool), ts=np.arange(4, dtype=np.int32),
               rank=np.arange(4, dtype=np.int32),
               active=np.ones(4, bool), order_free=None)
    owner = np.array([[0, 1, 0], [1, 0, 5], [1, 1, 1], [0, -1, 0]], np.int32)
    out = _density_both(arr, 2, 1024, True, owner)
    # txn 2 alone on key 6 and txn 3 alone on keys 8 and 2 never contend;
    # on key 1 both write lanes of txn 0 (owners 0 and 1) and the read of
    # txn 1 (owner 1) do
    assert out[False].tolist() == [1, 2]


def test_scripted_partitions_and_arms_agree():
    """``tests/test_metricsbus.py::test_conflict_density_partitions_and_
    paths_agree`` through both packages."""
    keys = np.array([[2, 2], [2, 2], [3, 7], [5, 9]], np.int32)
    w = np.array([[1, 1], [1, 1], [0, 0], [0, 0]], bool)

    def batch(active):
        return dict(table_ids=np.zeros((4, 2), np.int32), keys=keys,
                    is_read=~w, is_write=w, valid=np.ones((4, 2), bool),
                    ts=np.arange(4, dtype=np.int32),
                    rank=np.arange(4, dtype=np.int32),
                    active=np.array(active, bool), order_free=None)
    owner = (keys % 2).astype(np.int32)
    out = _density_both(batch([1, 1, 1, 1]), 2, 256, False, owner)
    assert out[True][0] >= 4 and out[True][1] == 0
    out = _density_both(batch([1, 0, 1, 1]), 2, 256, False, owner)
    assert out[False].tolist() == [0, 0]


# -- through the engine ------------------------------------------------------------

ENGINE = ["--synth_table_size=4096", "--req_per_query=4", "--max_accesses=4",
          "--epoch_batch=128", "--conflict_buckets=1024",
          "--max_txn_in_flight=512", "--zipf_theta=0.9", "--read_perc=0.1",
          "--write_perc=0.9", "--seed=5", "--watermark_buckets=64"]


def test_counter_stays_zero_when_metrics_is_off():
    cfg = Config.from_args(ENGINE + ["--cc_alg=OCC"])
    eng = Engine(cfg, get_workload(cfg, device="cpu"))
    st = eng.run(eng.init_state(), 3)
    assert int(st.stats["conflict_density"].sum()) == 0
    assert int(st.stats["total_txn_abort_cnt"]) > 0


@pytest.mark.parametrize("alg", ["OCC", "CALVIN", "NO_WAIT", "DGCC", "NOCC"])
def test_metered_epochs_match_reference(alg):
    """Three reference epochs, then three in each package from the carried
    state: the density counter (and every other counter) equal."""
    args = ENGINE + [f"--cc_alg={alg}", "--metrics=true"]
    if alg == "NO_WAIT":
        args.append("--isolation_level=NOLOCK")   # no views in the port
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    _inject(jeng.workload, teng.workload, *zipf_bank(4096, 0.9))
    js = jax.device_get(jeng.jit_run(jeng.init_state(), 3))
    ts = convert.from_reference_state(js, tcfg, "cpu")
    js = jax.device_get(jeng.jit_run(jax.tree.map(jnp.asarray, js), 3))
    ts = teng.run(ts, 3)
    ref, got = convert.flatten_reference(js), convert.to_numpy_state(ts)
    for path, want in ref.items():
        if path.startswith("stats/"):
            np.testing.assert_array_equal(got[path], want, err_msg=path)
    assert int(ts.stats["conflict_density"].sum()) > \
        int(js.stats["conflict_density"].sum()) // 2 > 0


def test_density_ranks_like_abort_rates():
    """``tests/test_metricsbus.py::test_density_ranks_order_like_abort_
    rates`` on the port: OCC at theta 0, 0.6 and 0.9 (four partitions of
    the owner map, one device)."""
    dens, aborts = [], []
    for theta in (0.0, 0.6, 0.9):
        kw = dict(cc_alg="OCC", epoch_batch=64, conflict_buckets=2048,
                  synth_table_size=1024, max_txn_in_flight=128,
                  req_per_query=4, max_accesses=4, zipf_theta=theta,
                  write_perc=0.9, read_perc=0.1, metrics=True)
        cfg = Config(**kw).validate()
        eng = Engine(cfg, get_workload(cfg, device="cpu"))
        st = eng.run(eng.init_state(), 12)
        dens.append(int(st.stats["conflict_density"].sum()))
        aborts.append(int(st.stats["total_txn_abort_cnt"]))
    assert np.argsort(dens).tolist() == np.argsort(aborts).tolist(), \
        (dens, aborts)
    assert dens[0] < dens[2] and aborts[0] < aborts[2]
