"""Port parity of TPC-C's dynamic ORDER index (``tpcc_order_index``)
against ``deneva_tpu`` on the CPU, exactly:

* `DynamicSortedIndex` build and insert over several masked epochs,
  with duplicate keys, initial entries and a capacity that overflows:
  keys, slots (the padded tail included) and ``cnt`` equal the
  reference's after every insert, and so do the probes (``lookup``,
  ``lookup_count``, ``range_slots``, ``range_between``) — the plain
  versions of K14e merge and K14e probes (``tests/test_storage.py:
  174-225``);
* whole TPC-C epochs with the index on, leaf by leaf including
  ``db/ORDER_IDX/{keys,slots,cnt}``, under TPU_BATCH and CALVIN (the
  chained executor: one merge per pass), OCC and NO_WAIT;
* the reference test's invariant on the port alone (``tests/
  test_tpcc.py:87-117``): every ORDER ring row is found at its slot,
  and a district's range walk ascends;
* ``run_simulation`` refuses a run whose index overflowed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tpcc import assert_same_db, tpcc_args

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.storage.index import DynamicSortedIndex as JIndex
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.driver import run_simulation
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.storage.index import DynamicSortedIndex
from deneva_tpu_torch.workloads import get_workload

IDX = "ORDER_IDX"
EPOCHS = 5


def _same_index(jidx, tidx, label=""):
    assert (tidx.cap, tidx.miss_slot) == (jidx.cap, jidx.miss_slot)
    for f in ("keys", "slots", "cnt"):
        np.testing.assert_array_equal(getattr(tidx, f).numpy(),
                                      np.asarray(getattr(jidx, f)),
                                      err_msg=f"{label} {f}")
    assert bool(tidx.overflowed()) == bool(np.asarray(jidx.overflowed()))


def _same_probes(jidx, tidx, rng):
    q = rng.integers(-3, 60, size=37).astype(np.int32)
    hi = q + rng.integers(0, 25, size=37).astype(np.int32)
    tq, thi = torch.from_numpy(q), torch.from_numpy(hi)
    jq, jhi = jnp.asarray(q), jnp.asarray(hi)
    np.testing.assert_array_equal(tidx.lookup(tq).numpy(),
                                  np.asarray(jidx.lookup(jq)))
    np.testing.assert_array_equal(tidx.lookup_count(tq).numpy(),
                                  np.asarray(jidx.lookup_count(jq)))
    for width in (1, 9, 70):
        for got, want in zip(tidx.range_between(tq, thi, width),
                             jidx.range_between(jq, jhi, width)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tidx.range_slots(tq, width),
                             jidx._view().range_slots(jq, width)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap,init,m,rounds", [
    (64, 2, 8, 4), (64, 0, 8, 6), (20, 3, 9, 4), (4, 0, 8, 2),
    (300, 17, 40, 5)])
def test_dynamic_index_matches_reference(cap, init, m, rounds):
    rng = np.random.default_rng(cap * 31 + m)
    k0 = rng.integers(0, 40, size=init).astype(np.int32)
    s0 = rng.integers(0, 1000, size=init).astype(np.int32)
    jidx = JIndex.build(k0, s0, miss_slot=999, cap=cap)
    tidx = DynamicSortedIndex.build(k0, s0, miss_slot=999, cap=cap)
    _same_index(jidx, tidx, "build")
    _same_probes(jidx, tidx, rng)
    for r in range(rounds):
        ks = rng.integers(0, 40, size=m).astype(np.int32)   # duplicates
        ss = np.arange(100 + r * m, 100 + (r + 1) * m, dtype=np.int32)
        mask = rng.random(m) < 0.75
        mask[0] = r != 0 or mask[0]
        jidx = jidx.insert(jnp.asarray(ks), jnp.asarray(ss),
                           jnp.asarray(mask))
        tidx = tidx.insert(torch.from_numpy(ks), torch.from_numpy(ss),
                           torch.from_numpy(mask))
        _same_index(jidx, tidx, f"insert {r}")
        _same_probes(jidx, tidx, rng)
    # an all-masked and an empty insert change nothing
    ks = np.arange(5, dtype=np.int32)
    tidx2 = tidx.insert(torch.from_numpy(ks), torch.from_numpy(ks),
                        torch.zeros(5, dtype=torch.bool))
    _same_index(jidx.insert(jnp.asarray(ks), jnp.asarray(ks),
                            jnp.zeros(5, bool)), tidx2, "all masked")
    z = torch.zeros(0, dtype=torch.int32)
    _same_index(jidx, tidx.insert(z, z, torch.zeros(0, dtype=torch.bool)),
                "empty")
    assert bool(tidx.overflowed()) == (cap <= 20)


def assert_same_state_with_index(jstate, tstate) -> None:
    """Every leaf of both states: the tables as ``assert_same_db`` holds
    them, ``db/ORDER_IDX/*`` whole, and every other path."""
    jstate = jax.device_get(jstate)
    assert_same_db({k: v for k, v in jstate.db.items() if k != IDX},
                   {k: v for k, v in tstate.db.items() if k != IDX})
    _same_index(jstate.db[IDX], tstate.db[IDX])
    ref = convert.flatten_reference(jstate)
    got = convert.to_numpy_state(tstate)
    assert sorted(ref) == sorted(got)
    for path, want in ref.items():
        if path.startswith("db/") and not path.startswith(f"db/{IDX}/"):
            continue
        have = got[path]
        assert have.dtype == want.dtype and have.shape == want.shape, path
        np.testing.assert_array_equal(have, want, err_msg=path)


CASES = [("TPU_BATCH", dict(num_wh=1)), ("CALVIN", dict(perc_payment=0.3)),
         ("OCC", {}), ("NO_WAIT", dict(insert_table_cap=64))]


@pytest.mark.parametrize("alg,kw", CASES, ids=[
    "-".join([a] + [f"{k}={v}" for k, v in kw.items()]) for a, kw in CASES])
def test_epochs_with_index_match_reference(alg, kw):
    args = tpcc_args(cc_alg=alg, tpcc_order_index=True, **kw)
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    js = jeng.init_state()
    assert_same_state_with_index(js, teng.init_state())
    ts = convert.from_reference_state(jax.device_get(js), tcfg, "cpu")
    js = jeng.jit_run(js, EPOCHS)
    ts = teng.run(ts, EPOCHS)
    assert_same_state_with_index(js, ts)
    idx = ts.db[IDX]
    assert int(idx.cnt) == int(ts.db["ORDER"].row_cnt) > 0
    if "insert_table_cap" in kw:
        # the ring and the index both overran their capacity
        assert bool(idx.overflowed())


def test_index_tracks_inserted_orders():
    """``tests/test_tpcc.py:87-117`` on the port: 20 TPU_BATCH epochs;
    each ORDER row is found by its key at its ring slot, and one
    district's range walk gives its orders in ascending o_id."""
    cfg = Config.from_args(tpcc_args(cc_alg="TPU_BATCH",
                                     tpcc_order_index=True))
    wl = get_workload(cfg, device="cpu")
    eng = Engine(cfg, wl)
    st = eng.run(eng.init_state(0), 20)
    idx, order = st.db[IDX], st.db["ORDER"]
    n_ord = int(order.row_cnt)
    assert 0 < n_ord < cfg.insert_table_cap and not bool(idx.overflowed())
    o_w, o_d, o_id = (order.columns[c][:n_ord]
                      for c in ("O_W_ID", "O_D_ID", "O_ID"))
    keys = wl.order_index_key(o_w, o_d, o_id)
    assert torch.equal(idx.lookup(keys),
                       torch.arange(n_ord, dtype=torch.int32))
    assert torch.equal(idx.lookup_count(keys), torch.ones_like(keys))
    dk = int(o_w[0]) * wl.n_dist + int(o_d[0])
    lo = torch.tensor([dk << 21], dtype=torch.int32)
    hi = torch.tensor([(dk << 21) + (1 << 21) - 1], dtype=torch.int32)
    slots, ok = idx.range_between(lo, hi, 256)
    walk = slots[0][ok[0]].long()
    mine = torch.nonzero((o_w == o_w[0]) & (o_d == o_d[0]))[:, 0]
    assert sorted(walk.tolist()) == sorted(mine.tolist())
    assert bool((torch.diff(o_id[walk]) >= 1).all())


def test_run_simulation_refuses_an_overflowed_index():
    cfg = Config.from_args(tpcc_args(
        cc_alg="TPU_BATCH", tpcc_order_index=True, insert_table_cap=64,
        warmup_secs=0.01, done_secs=0.05, chunk_target_secs=0.000001))
    with pytest.raises(RuntimeError, match="overflowed"):
        run_simulation(cfg, device="cpu", chunk=1, quiet=True)
