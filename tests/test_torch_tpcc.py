"""Port parity of TPC-C (``deneva_tpu_torch.workloads.tpcc``) against
``deneva_tpu.workloads.tpcc`` on the CPU, exactly, at the sizes of
``tests/test_tpcc.py`` (2 warehouses, 120 customers per district, 200
items, 5 items per txn, 8 accesses, 64 txns per epoch):

* the loader: every column of the nine tables (short and full schema,
  1 and 2 warehouses), and the CUSTOMER_LAST index and postings;
* ``generate`` (the plain versions of K19 and K14a): all twelve query
  fields, float32 ``h_amount`` bit for bit, with 1, 2 and 4 warehouses,
  the by-last-name index on and off, ``mpr_neworder`` 0, 0.01 and 1, 15
  items per txn, and ``max_items=100000`` (randint's wrapping fold);
* ``plan``: every array of the RW-set;
* the pool: refill, select and update of ``TPCCQuery`` batches over a
  full and a partial pool;
* the reference's TPC-C invariants on the port alone: money
  conservation, dense per-district O_IDs, the stock rule and MVCC's
  read checksum (``tests/test_tpcc.py:121-216``).

Whole epochs are in ``test_torch_tpcc_epochs.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.config import Config as JConfig
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu.workloads.tpcc import TPCCQuery as JQuery
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.ops import prng
from deneva_tpu_torch.workloads import get_workload
from deneva_tpu_torch.workloads.tpcc import TPCCQuery

BASE = dict(num_wh=2, cust_per_dist=120, max_items=200, max_items_per_txn=5,
            max_accesses=8, epoch_batch=64, conflict_buckets=1024,
            max_txn_in_flight=256, insert_table_cap=1 << 14)
FIELDS = [f.name for f in dataclasses.fields(TPCCQuery)]


def tpcc_args(**kw) -> list[str]:
    d = {**BASE, **kw}
    return ["--workload=TPCC"] + [f"--{k}={v}" for k, v in d.items()]


def both_workloads(**kw):
    args = tpcc_args(**kw)
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    return j_workload(jcfg), get_workload(tcfg, device="cpu"), tcfg


def _column(t: torch.Tensor, ref: np.ndarray) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32) if ref.dtype == np.uint32 else a


def assert_same_db(jdb, tdb) -> None:
    """Every table of both packages: rows [0, capacity), ``row_cnt``, the
    ring flag; the port's padded rows untouched (the trash row, written
    in an unspecified order by the reference, is not compared)."""
    assert sorted(jdb) == sorted(tdb)
    for name, jt in jdb.items():
        tt = tdb[name]
        cap = tt.capacity
        assert (cap, tt.ring) == (jt.capacity, jt.ring), name
        assert int(tt.row_cnt) == int(jt.row_cnt), name
        assert sorted(jt.columns) == sorted(tt.columns), name
        for col, arr in jt.columns.items():
            want = np.asarray(arr)
            have = _column(tt.columns[col], want)
            assert have.dtype == want.dtype and have.shape == want.shape
            np.testing.assert_array_equal(have[:cap], want[:cap],
                                          err_msg=f"{name}/{col}")
            assert not have[cap + 1:].any(), f"{name}/{col} padded rows"


@pytest.mark.parametrize("full,num_wh", [(False, 2), (True, 1)])
def test_loader_matches_reference(full, num_wh):
    jwl, twl, _ = both_workloads(tpcc_full_schema=full, num_wh=num_wh)
    assert_same_db(jax.device_get(jwl.load()), twl.load())
    ref = jax.device_get(jwl.last_idx)
    idx = twl.last_idx
    np.testing.assert_array_equal(idx.keys.numpy(), np.asarray(ref.keys))
    np.testing.assert_array_equal(idx.slots.numpy(), np.asarray(ref.slots))
    assert (idx.cap, idx.max_probe, idx.miss_slot) == (
        ref.cap, ref.max_probe, ref.miss_slot)
    np.testing.assert_array_equal(twl.last_postings.numpy(),
                                  np.asarray(jwl.last_postings))


GEN_CASES = [
    dict(num_wh=1),
    dict(num_wh=2, mpr_neworder=1.0, max_items_per_txn=15,
         max_accesses=18),
    dict(num_wh=4, tpcc_by_last_index=False, mpr_neworder=0.0),
    dict(num_wh=2, max_items=100000, mpr_neworder=1.0, perc_payment=0.3),
]


@pytest.mark.parametrize("kw", GEN_CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_generate_matches_reference(kw):
    jwl, twl, cfg = both_workloads(**kw)
    gen = jax.jit(jwl.generate, static_argnums=1)
    n = 512
    for seed in (0, 5):
        want = jax.device_get(gen(jax.random.PRNGKey(seed), n))
        got = twl.generate(prng.key_from_seed(seed, "cpu"), n)
        for f in FIELDS:
            w, h = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            assert h.dtype == w.dtype and h.shape == w.shape, f
            np.testing.assert_array_equal(h, w, err_msg=f)
    pay = got.txn_type.numpy() == 0
    assert 0 < pay.sum() < n
    if cfg.num_wh > 1:
        assert (got.c_w_id != got.w_id).any()          # remote customers
    if cfg.mpr_neworder == 1.0:
        assert (got.supply_w != got.w_id[:, None]).any()
    if cfg.max_items_per_txn == 15:                     # duplicates dropped
        in_cnt = torch.arange(15)[None, :] < got.ol_cnt[:, None]
        assert (in_cnt & ~got.item_valid).any()


def test_plan_matches_reference():
    jwl, twl, _ = both_workloads(max_items_per_txn=15, max_accesses=20,
                                 mpr_neworder=1.0)
    q = twl.generate(prng.key_from_seed(3, "cpu"), 256)
    jq = JQuery(**{f: jnp.asarray(getattr(q, f).numpy()) for f in FIELDS})
    want = jax.device_get(jwl.plan(None, jq))
    got = twl.plan(None, q)
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)


def test_partition_helpers_match_reference_on_one_partition():
    """``partition_owned`` and ``partition_slot`` equal the reference's
    single-partition forms, and its striped forms at 2 and 4 partitions
    (every node's view; a key another node owns resolves to n_local)."""
    from deneva_tpu.workloads import base as jbase
    from deneva_tpu_torch.workloads import base
    key = np.arange(-3, 40, dtype=np.int32)
    tk = torch.from_numpy(key)
    np.testing.assert_array_equal(
        base.partition_owned(tk, 1, 0).numpy(),
        np.asarray(jbase.partition_owned(jnp.asarray(key), 1, 0)))
    np.testing.assert_array_equal(
        base.partition_slot(tk, 1, 0, 40).numpy(),
        np.asarray(jbase.partition_slot(jnp.asarray(key), 1, 0, 40)))
    for parts in (2, 4):
        for me in range(parts):
            np.testing.assert_array_equal(
                base.partition_owned(tk, parts, me).numpy(),
                np.asarray(jbase.partition_owned(jnp.asarray(key), parts,
                                                 me)))
            np.testing.assert_array_equal(
                base.partition_slot(tk, parts, me, 20).numpy(),
                np.asarray(jbase.partition_slot(jnp.asarray(key), parts, me,
                                                20)))


def _run_port(args, epochs, seed=0):
    cfg = Config.from_args(args)
    wl = get_workload(cfg, device="cpu")
    eng = Engine(cfg, wl)
    s0 = eng.init_state(seed)
    d0 = {n: {c: v.clone() for c, v in t.columns.items()}
          for n, t in s0.db.items()}
    return cfg, wl, d0, eng.run(s0, epochs)


def test_money_conservation_and_dense_order_ids():
    """``tests/test_tpcc.py:164``'s audit on the port: D_YTD, W_YTD and
    the balances move by exactly the HISTORY amounts; D_NEXT_O_ID's
    advance equals the ORDER and NEW-ORDER rows; each district's O_IDs
    are 3001.. dense."""
    cfg, wl, d0, st = _run_port(tpcc_args(cc_alg="TPU_BATCH",
                                          perc_payment=0.5), 30)
    db = st.db
    n_hist = int(db["HISTORY"].row_cnt)
    assert 0 < n_hist < cfg.insert_table_cap
    paid = db["HISTORY"].columns["H_AMOUNT"][:n_hist].double().sum()
    for tab, col, sign in (("DISTRICT", "D_YTD", 1), ("WAREHOUSE", "W_YTD", 1),
                           ("CUSTOMER", "C_BALANCE", -1)):
        cap = db[tab].capacity
        moved = (db[tab].columns[col][:cap].double().sum()
                 - d0[tab][col][:cap].double().sum()) * sign
        np.testing.assert_allclose(float(moved), float(paid), rtol=1e-5)
    adv = int((db["DISTRICT"].columns["D_NEXT_O_ID"]
               - d0["DISTRICT"]["D_NEXT_O_ID"])[:wl.n_districts].sum())
    assert adv > 0
    assert adv == int(db["ORDER"].row_cnt) == int(db["NEW-ORDER"].row_cnt)
    n_ord = int(db["ORDER"].row_cnt)
    o = {c: db["ORDER"].columns[c][:n_ord].numpy()
         for c in ("O_W_ID", "O_D_ID", "O_ID")}
    nxt = db["DISTRICT"].columns["D_NEXT_O_ID"].numpy()
    for w in range(cfg.num_wh):
        for d in range(10):
            ids = np.sort(o["O_ID"][(o["O_W_ID"] == w) & (o["O_D_ID"] == d)])
            assert (ids == np.arange(3001, nxt[w * 10 + d])).all(), (w, d)
    assert int(db["ORDER-LINE"].row_cnt) >= n_ord * 4


@pytest.mark.parametrize("alg", ["TPU_BATCH", "OCC"])
def test_stock_rule_against_order_lines(alg):
    """Every stock row moved by exactly its order lines: S_YTD and
    S_ORDER_CNT count them, S_REMOTE_CNT their remote supplies, and the
    quantity dropped by their sum modulo the replenishment of 91."""
    cfg, wl, d0, st = _run_port(tpcc_args(
        cc_alg=alg, perc_payment=0.2, tpcc_full_schema=True,
        mpr_neworder=0.5, max_items=50), 20)
    db = st.db
    n_ol = int(db["ORDER-LINE"].row_cnt)
    assert 0 < n_ol < db["ORDER-LINE"].capacity
    ol = {c: db["ORDER-LINE"].columns[c][:n_ol].numpy()
          for c in ("OL_SUPPLY_W_ID", "OL_I_ID", "OL_QUANTITY", "OL_W_ID")}
    row = ol["OL_SUPPLY_W_ID"].astype(np.int64) * cfg.max_items + ol["OL_I_ID"]
    n = wl.n_stock
    qty = np.bincount(row, ol["OL_QUANTITY"], n).astype(np.int64)
    cnt = np.bincount(row, minlength=n)
    rem = np.bincount(row, ol["OL_SUPPLY_W_ID"] != ol["OL_W_ID"], n)
    s = {c: db["STOCK"].columns[c][:n].numpy().astype(np.int64)
         for c in ("S_YTD", "S_ORDER_CNT", "S_REMOTE_CNT", "S_QUANTITY")}
    np.testing.assert_array_equal(s["S_YTD"], qty)
    np.testing.assert_array_equal(s["S_ORDER_CNT"], cnt)
    np.testing.assert_array_equal(s["S_REMOTE_CNT"], rem.astype(np.int64))
    q0 = d0["STOCK"]["S_QUANTITY"][:n].numpy().astype(np.int64)
    assert ((q0 - s["S_QUANTITY"] - qty) % 91 == 0).all()
    assert s["S_QUANTITY"].min() >= 10 and s["S_QUANTITY"].max() <= 101
    assert rem.sum() > 0 and (cnt > 1).any()


def test_mvcc_read_checksum_matches_closed_form():
    """``tests/test_tpcc.py:121``: under MVCC the read checksum equals
    the one recomputed from the immutable tax and discount columns over
    the committed NewOrders the ORDER table records."""
    cfg, wl, d0, st = _run_port(tpcc_args(cc_alg="MVCC", perc_payment=0.4),
                                25, seed=1)
    db = st.db
    n_ord = int(db["ORDER"].row_cnt)
    assert 0 < n_ord < cfg.insert_table_cap
    o_w, o_d, o_c = (db["ORDER"].columns[c][:n_ord].numpy()
                     for c in ("O_W_ID", "O_D_ID", "O_C_ID"))
    dslot = o_w * 10 + o_d
    cslot = dslot * cfg.cust_per_dist + o_c
    lanes = ((d0["WAREHOUSE"]["W_TAX"].numpy()[o_w]
              + d0["DISTRICT"]["D_TAX"].numpy()[dslot]
              + d0["CUSTOMER"]["C_DISCOUNT"].numpy()[cslot])
             * np.float32(1000)).astype(np.uint32)
    assert int(st.stats["read_checksum"]) == int(lanes.sum(dtype=np.uint32))
    assert int(st.stats["total_txn_abort_cnt"]) + int(
        st.stats["defer_cnt"]) > 0


@pytest.mark.parametrize("pool,batch", [(64, 64), (256, 64)])
def test_pool_carries_tpcc_queries(pool, batch):
    """Refill, select and update over a full and a partial pool carry
    every ``TPCCQuery`` field (float32 ``h_amount`` bit for bit, the [n,
    15] item fields) as the reference's pool does."""
    from deneva_tpu.engine.pool import TxnPool as JPool
    from deneva_tpu_torch import convert
    from deneva_tpu_torch.engine.pool import TxnPool
    jwl, twl, _ = both_workloads(max_items_per_txn=15, max_accesses=18)
    rng = np.random.default_rng(pool)
    jpool = JPool(pool, batch, batch, backoff=True)
    tpool = TxnPool(pool, batch, batch, True)
    js = jpool.create(jax.tree.map(jnp.zeros_like, jwl.generate(
        jax.random.PRNGKey(0), pool)))
    ts = tpool.create(twl.empty_query(pool, "cpu"), "cpu")
    for epoch in range(6):
        q = twl.generate(prng.key_from_seed(epoch, "cpu"), batch)
        jq = JQuery(**{f: jnp.asarray(getattr(q, f).numpy()) for f in FIELDS})
        je, te = jnp.int32(epoch), torch.tensor(epoch, dtype=torch.int32)
        js, jadm = jpool.refill(js, jq, je)
        ts, tadm = tpool.refill(ts, q, te)
        assert int(jadm) == int(tadm)
        jslots, jact, jsel = jpool.select(js, je)
        tslots, tact, tsel = tpool.select(ts, te)
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tsel, f).numpy(),
                                          np.asarray(getattr(jsel, f)), f)
        commit = rng.random(batch) < 0.5
        abort = ~commit & (rng.random(batch) < 0.6)
        js = jpool.update(js, jslots, jact, jnp.asarray(commit),
                          jnp.asarray(abort), je, True)
        ts = tpool.update(ts, tslots, tact, torch.from_numpy(commit),
                          torch.from_numpy(abort), te, True)
        for f in convert.POOL_FIELDS:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(ts.queries, f).numpy(),
                np.asarray(getattr(js.queries, f)), f)
