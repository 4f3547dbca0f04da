"""Port parity of the mesh (``device_parts > 1``) on the CPU, exactly.

``deneva_tpu`` runs its ``make_sharded_run`` over the 8 CPU devices that
``conftest.py`` forces; the port runs the same shards one after another
on ``make_mesh(D, devices=[cpu] * D)``.  From the same seeds:

* the spec of the capacity rule, `mc_plan_defer`, on random batches over
  D in {2, 4, 8}, tight and ample ``pair_cap``, zipf 0.9 keys with
  repeated ts, and the reference test's hand case; the plain K18a over
  the D slices equals it, and the plain K18b's blocks hold exactly the
  lanes the reference's blocks deliver to their owner, in order;
* the layout: `to_mc_layout` and `mc_block_geometry` for ``anchor_rows``
  1 and > 1 and for ring tables, and the inverse map;
* whole epochs at D = 8 leaf by leaf against the reference (each
  block's data rows; the port's pad rows untouched; the trash rows not
  compared): YCSB TPU_BATCH through the sharded plan, the replicated
  plan (``mc_plan_capacity=0``), tight capacity (defers > 0), the
  forced-abort sentinel and full rows; OCC, TIMESTAMP, MVCC (no version
  ring at D > 1) and CALVIN on YCSB; TPC-C under TPU_BATCH and NO_WAIT;
  PPS under TPU_BATCH and MAAT (the configs of ``tests/
  test_parallel.py``);
* the port at D = 8 against the port at D = 1: every counter, every
  stacked table's rows mapped back, ring tables as row multisets;
* the config: ``device_parts`` is accepted with the reference's checks,
  and every ``device_parts == 1`` pin raises; the mesh and the driver.

JAX state is built once per case; the reference's compiles dominate the
file's time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.ops import mc_pair_cap as j_pair_cap
from deneva_tpu.ops import mc_plan_defer as j_plan_defer
from deneva_tpu.parallel import make_mesh as j_make_mesh
from deneva_tpu.parallel import make_sharded_run as j_sharded_run
from deneva_tpu.parallel.mesh import a2a_bytes_per_epoch as j_a2a_bytes
from deneva_tpu.storage import table as jtable
from deneva_tpu.storage.catalog import parse_schema as j_parse_schema
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.ops import forward
from deneva_tpu_torch.parallel import (a2a_bytes_per_epoch, make_mesh,
                                       make_sharded_run, use_mesh)
from deneva_tpu_torch.storage import table as ttable
from deneva_tpu_torch.storage.catalog import parse_schema
from deneva_tpu_torch.workloads import get_workload
from deneva_tpu_torch.workloads.mc import McTableView, mc_execute

BIG = 2**31 - 1
CPU8 = ["cpu"] * 8


def ycsb_args(**kw) -> list[str]:
    """``tests/test_parallel.py:18``'s ``cfg_for`` shape."""
    d = dict(epoch_batch=64, conflict_buckets=1024, max_accesses=4,
             req_per_query=4, synth_table_size=4096, zipf_theta=0.6,
             max_txn_in_flight=256)
    d.update(kw)
    return [f"--{k}={v}" for k, v in d.items()]


def tpcc_args(**kw) -> list[str]:
    """``TPCC_MC`` of ``tests/test_parallel.py:110``."""
    d = dict(workload="TPCC", cc_alg="TPU_BATCH", epoch_batch=64,
             conflict_buckets=1024, num_wh=8, cust_per_dist=30,
             max_items=100, max_accesses=18, max_txn_in_flight=256,
             insert_table_cap=1 << 10)
    d.update(kw)
    return [f"--{k}={v}" for k, v in d.items()]


def pps_args(**kw) -> list[str]:
    """``PPS_MC`` of ``tests/test_parallel.py:114``."""
    d = dict(workload="PPS", cc_alg="TPU_BATCH", epoch_batch=64,
             conflict_buckets=1024, pps_parts_cnt=400, pps_products_cnt=80,
             pps_suppliers_cnt=80, pps_parts_per=4, max_accesses=9,
             max_txn_in_flight=256)
    d.update(kw)
    return [f"--{k}={v}" for k, v in d.items()]


# -- the capacity rule ---------------------------------------------------

def _zipf_keys(rng, shape, n, theta=0.9):
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), theta)
    return rng.choice(n, size=shape, p=w / w.sum()).astype(np.int32)


def _batch(seed, b, a, n=4096, theta=0.9):
    rng = np.random.default_rng(seed)
    keys = _zipf_keys(rng, (b, a), n, theta)
    valid = rng.random((b, a)) < 0.9
    valid[rng.random(b) < 0.1] = False          # inactive txns
    ts = rng.integers(1, b // 4, size=b).astype(np.int32)   # repeats
    rank = rng.permutation(b).astype(np.int32) + 1
    w = valid & (rng.random((b, a)) < 0.5)
    return keys, valid, ts, rank, w


def test_pair_cap_matches_reference():
    for b in (64, 100, 256, 4096, 65536):
        for a in (1, 4, 10, 16):
            for d in (1, 2, 3, 4, 8):
                for f in (0.0, 0.25, 1.0, 2.0, 8.0):
                    assert forward.mc_pair_cap(b, a, d, f) \
                        == j_pair_cap(b, a, d, f), (b, a, d, f)
    assert forward.mc_pair_cap(65536, 10, 8, 2.0) == 20480
    assert forward.mc_pair_cap(65536, 10, 4, 2.0) == 81920
    assert forward.mc_pair_cap(65536, 10, 2, 2.0) == 0


SPEC = [(d, cap, seed) for d in (2, 4, 8) for cap in ("tight", "ample")
        for seed in (0, 1)]


@pytest.mark.parametrize("d,cap,seed", SPEC,
                         ids=[f"D{d}-{c}-{s}" for d, c, s in SPEC])
def test_plan_defer_matches_reference(d, cap, seed):
    b, a = 512, 10
    keys, valid, ts, _, _ = _batch(seed, b, a)
    sl = b * a // d
    pair_cap = max(a, sl // (4 * d)) if cap == "tight" else sl
    want = np.asarray(j_plan_defer(jnp.asarray(keys), jnp.asarray(ts),
                                   jnp.asarray(valid), d, pair_cap))
    tk, tv, tts = (torch.from_numpy(keys), torch.from_numpy(valid),
                   torch.from_numpy(ts))
    got = forward.mc_plan_defer(tk, tts, tv, d, pair_cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() == (cap == "tight")
    # the plain K18a over the D slices is the spec
    bd = b // d
    parts = [forward.mc_slice_defer(tk[s * bd:(s + 1) * bd],
                                    tv[s * bd:(s + 1) * bd],
                                    tts[s * bd:(s + 1) * bd], d, pair_cap)
             for s in range(d)]
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).numpy(), want)
    for s, (_, order) in enumerate(parts):
        want_order = np.argsort(ts[s * bd:(s + 1) * bd], kind="stable")
        np.testing.assert_array_equal(order.numpy(), want_order)


def test_plan_defer_hand_case():
    """``tests/test_parallel.py:146-168``: priority is age, not slot."""
    keys = torch.tensor([[0, 2], [4, 6], [8, 10], [12, 14]],
                        dtype=torch.int32)
    valid = torch.ones((4, 2), dtype=torch.bool)
    ts = torch.tensor([9, 1, 2, 8], dtype=torch.int32)
    assert forward.mc_plan_defer(keys, ts, valid, 2, 2).tolist() \
        == [True, False, False, True]
    assert not forward.mc_plan_defer(keys, ts, valid, 2, 4).any()


def _j_blocks(keys, valid, ts, rank, w, dfr, d, pair_cap):
    """The reference's block cut, ``deneva_tpu/workloads/ycsb.py:413-441``
    copied for one source slice (the lines sit inside its shard_map
    body): (bk, br, bw) of shape [D, pair_cap]."""
    bd, a = keys.shape
    big = jnp.int32(BIG)
    ks = jnp.where(valid, keys, big).reshape(-1)
    rs = jnp.broadcast_to(rank[:, None], (bd, a)).reshape(-1)
    tss = jnp.broadcast_to(ts[:, None], (bd, a)).reshape(-1)
    ws, vs = w.reshape(-1), valid.reshape(-1)
    dfr_lane = jnp.broadcast_to(dfr[:, None], (bd, a)).reshape(-1)
    vs2 = vs & ~dfr_lane
    ks2 = jnp.where(vs2, ks, big)
    ws2 = ws & ~dfr_lane
    owner2 = jnp.where(vs2, ks2 % d, d)
    _, _, ck, cr, cw = jax.lax.sort((owner2, tss, ks2, rs, ws2),
                                    num_keys=2, is_stable=True)
    cnt = jnp.bincount(owner2, length=d + 1)
    starts = jnp.cumsum(cnt) - cnt
    return [np.asarray(jnp.stack([jax.lax.dynamic_slice_in_dim(
        x, starts[o], pair_cap) for o in range(d)])) for x in (ck, cr, cw)]


@pytest.mark.parametrize("d", [2, 4, 8])
def test_pack_blocks_hold_the_reference_lanes(d):
    """Each block of the plain K18b holds exactly the lanes the
    reference's block delivers to its owner (its key is the owner's),
    in the same (ts, lane) order; the port fills the rest with
    ``(INT32_MAX, 0, False)`` where the reference leaves other owners'
    lanes."""
    b, a = 256, 10
    keys, valid, ts, rank, w = _batch(7 + d, b, a)
    sl = b * a
    pair_cap = max(a, sl // (2 * d))
    tk = torch.from_numpy(keys)
    tv, tts = torch.from_numpy(valid), torch.from_numpy(ts)
    dfr, order = forward.mc_slice_defer(tk, tv, tts, d, pair_cap)
    assert dfr.any()
    bk, br, bw = forward.mc_pack_blocks(
        tk, tv, tts, torch.from_numpy(rank), torch.from_numpy(w), dfr,
        order, d, pair_cap)
    jk, jr, jw = _j_blocks(jnp.asarray(keys), jnp.asarray(valid),
                           jnp.asarray(ts), jnp.asarray(rank),
                           jnp.asarray(w), jnp.asarray(dfr.numpy()), d,
                           pair_cap)
    for o in range(d):
        mine = (jk[o] % d == o) & (jk[o] != BIG)
        n = int(mine.sum())
        np.testing.assert_array_equal(bk[o, :n].numpy(), jk[o][mine])
        np.testing.assert_array_equal(br[o, :n].numpy(), jr[o][mine])
        np.testing.assert_array_equal(bw[o, :n].numpy(), jw[o][mine])
        assert (bk[o, n:] == BIG).all() and not br[o, n:].any() \
            and not bw[o, n:].any()
    # every surviving valid lane is in some block
    live = valid & ~dfr.numpy()[:, None]
    assert int((bk != BIG).sum()) == int(live.sum())


# -- the layout ----------------------------------------------------------

SCHEMA = "TABLE=T\n\t8,int64_t,A\n\t8,double,B\n"


def _tables(cap, ring):
    jt = jtable.DeviceTable.create(j_parse_schema(SCHEMA).table("T"), cap,
                                   ring=ring)
    tt = ttable.DeviceTable.create(parse_schema(SCHEMA).table("T"), cap,
                                   "cpu", ring=ring)
    if not ring:
        vals = {"A": np.arange(cap, dtype=np.int32) * 3 + 1,
                "B": np.arange(cap, dtype=np.float32) / 7}
        jt = jtable.fill_columns(jt, cap, vals)
        ttable.fill_columns(tt, cap, {k: torch.from_numpy(v)
                                      for k, v in vals.items()})
    return jt, tt


LAYOUTS = [(64, 1, 8, False), (120, 10, 4, False), (3000, 30, 2, False),
           (1024, 1, 8, True), (96, 1, 2, True)]


@pytest.mark.parametrize("cap,r,d,ring", LAYOUTS)
def test_mc_layout_matches_reference(cap, r, d, ring):
    assert ttable.mc_block_geometry(cap, r, d) \
        == jtable.mc_block_geometry(cap, r, d)
    jt, tt = _tables(cap, ring)
    jm = jax.device_get(jtable.to_mc_layout(jt, d, r))
    tm = ttable.to_mc_layout(tt, d, r)
    assert (tm.mc_parts, tm.anchor_rows, tm.ring) == (d, r, ring)
    np.testing.assert_array_equal(tm.row_cnt.numpy(), np.asarray(jm.row_cnt))
    for col in ("A", "B"):
        np.testing.assert_array_equal(tm.columns[col].numpy(),
                                      np.asarray(jm.columns[col]))
    if not ring:
        at = ttable.mc_stacked_rows(tm)
        np.testing.assert_array_equal(tm.columns["A"][at].numpy(),
                                      np.arange(cap) * 3 + 1)
    blk = tm.block(d - 1)
    lb, local, trash = tm.mc_block_rows()
    assert (blk.capacity, local) == (
        (cap // d, cap // d) if ring else (lb - 1, cap // d))
    assert trash == blk.capacity
    blk.columns["A"][0] = -5                 # a view: writes land
    assert int(tm.columns["A"][(d - 1) * lb]) == -5


def test_mc_layout_checks_match_reference():
    for cap, r, d in ((100, 3, 2), (90, 10, 2)):
        for mod in (ttable, jtable):
            with pytest.raises(ValueError):
                mod.mc_block_geometry(cap, r, d)


def test_view_translates_like_the_reference():
    """McTableView's gather, scatter, scatter_add and append against the
    reference's, shard by shard (append: rows kept on the anchor's
    owner, each block's own cursor)."""
    d, r, cap = 4, 10, 120
    jt, tt = _tables(cap, False)
    tm = ttable.to_mc_layout(tt, d, r)
    slots = torch.tensor([0, 9, 10, 55, 119, 120, -1, 77], dtype=torch.int32)
    for me in range(d):
        got = McTableView(tm, me).gather(slots, ("A",))["A"]
        want = [int(tm.columns["A"][ttable.mc_stacked_rows(tm)[s]])
                if 0 <= s < cap and (s // r) % d == me else 0
                for s in slots.tolist()]
        assert got.tolist() == want
    v = McTableView(tm, 1)
    v.scatter(torch.tensor([10, 20]), {"A": torch.tensor([7, 8])})
    v.scatter_add(torch.tensor([10, 10]), {"B": torch.tensor([1.0, 2.0])})
    at = ttable.mc_stacked_rows(tm)
    assert tm.columns["A"][at[10]] == 7 and tm.columns["A"][at[20]] == 61
    one = np.float32(np.float32(10) / np.float32(7))
    assert float(tm.columns["B"][at[10]]) \
        == np.float32(np.float32(one + np.float32(1)) + np.float32(2))
    ring = ttable.to_mc_layout(_tables(64, True)[1], d)
    anchor = torch.tensor([0, 1, 5, 9, 2], dtype=torch.int32)
    mask = torch.tensor([True, True, True, True, False])
    for me in range(d):
        McTableView(ring, me).append(
            {"A": anchor * 100}, mask, anchor=anchor)
    assert ring.row_cnt.tolist() == [1, 3, 0, 0]
    blk = ring.block(1)
    assert blk.columns["A"][:3].tolist() == [100, 500, 900]
    with pytest.raises(ValueError, match="anchor"):
        McTableView(ring, 0).append({"A": anchor}, mask)


# -- whole epochs at D = 8 against the reference ------------------------

def assert_same_mc_state(jstate, tstate) -> None:
    """Leaf by leaf: stacked tables by block (data rows equal; the port's
    pad rows zero; the trash rows, written in an unspecified order by
    the reference, not compared), whole tables on rows [0, capacity),
    every other leaf exactly."""
    ref = convert.flatten_reference(jax.device_get(jstate))
    got = convert.to_numpy_state(tstate)
    assert sorted(ref) == sorted(got)
    for path, want in ref.items():
        have = got[path]
        assert have.dtype == want.dtype and have.shape == want.shape, path
        parts = path.split("/")
        tab = tstate.db.get(parts[1]) if parts[0] == "db" else None
        if not isinstance(tab, ttable.DeviceTable) or parts[2] == "row_cnt":
            np.testing.assert_array_equal(have, want, err_msg=path)
            continue
        if tab.mc_parts == 1:
            cap = tab.capacity
            np.testing.assert_array_equal(have[:cap], want[:cap],
                                          err_msg=path)
            assert not have[cap + 1:].any(), f"{path} padded rows"
            continue
        lb, local, trash = tab.mc_block_rows()
        h = have.reshape(tab.mc_parts, lb, *have.shape[1:])
        w = want.reshape(tab.mc_parts, lb, *want.shape[1:])
        np.testing.assert_array_equal(h[:, :local], w[:, :local],
                                      err_msg=path)
        pad = [i for i in range(local, lb) if i != trash]
        assert not h[:, pad].any(), f"{path} pad rows"


CASES = {
    # tests/test_parallel.py:171-194: pair_cap 512 < 2,048 lanes a slice
    "ycsb-sharded": ycsb_args(epoch_batch=4096, max_txn_in_flight=4096,
                              synth_table_size=8192),
    "ycsb-replicated-plan": ycsb_args(epoch_batch=4096,
                                      max_txn_in_flight=4096,
                                      synth_table_size=8192,
                                      mc_plan_capacity=0),
    # :197-216: tight capacity under hot skew defers
    "ycsb-tight": ycsb_args(epoch_batch=4096, max_txn_in_flight=4096,
                            zipf_theta=0.9, mc_plan_capacity=0.25),
    # :71-95: full pool and the forced-abort sentinel
    "ycsb-abort-mode": ycsb_args(epoch_batch=256, max_txn_in_flight=256,
                                 zipf_theta=0.9, ycsb_abort_mode=True),
    "ycsb-full-row": ycsb_args(epoch_batch=4096, max_txn_in_flight=4096,
                               synth_table_size=8192, sim_full_row=True,
                               tup_size=8, field_per_tuple=2),
    "ycsb-OCC": ycsb_args(cc_alg="OCC"),
    "ycsb-TIMESTAMP": ycsb_args(cc_alg="TIMESTAMP"),
    "ycsb-MVCC": ycsb_args(cc_alg="MVCC", watermark_buckets=64),
    "ycsb-CALVIN": ycsb_args(cc_alg="CALVIN"),
    "tpcc-TPU_BATCH": tpcc_args(),
    "tpcc-NO_WAIT": tpcc_args(cc_alg="NO_WAIT"),
    "pps-TPU_BATCH": pps_args(),
    "pps-MAAT": pps_args(cc_alg="MAAT"),
}
EPOCHS = 6


def _port_run(args, epochs, seed, d=None):
    cfg = Config.from_args(args + ([f"--device_parts={d}"] if d else []))
    eng = Engine(cfg, get_workload(cfg, device="cpu"))
    state = eng.init_state(seed=seed)
    if cfg.device_parts == 1:
        return eng.run(state, epochs), eng
    place, run = make_sharded_run(
        eng, make_mesh(cfg.device_parts, devices=["cpu"] * cfg.device_parts))
    return run(place(state), epochs), eng


def _inject(jwl, twl, cfg, seed, hot):
    """Both YCSB workloads draw their queries from one numpy bank, picked
    by the generator key's low word: the reference's f32 zipf ``pow`` is
    not reproducible bit for bit (ROADMAP watch item 2), and epoch parity
    is not loosened for it.  ``hot`` skews the keys like theta 0.9."""
    from deneva_tpu.workloads.ycsb import YCSBQuery as JQuery
    from deneva_tpu_torch.workloads.ycsb import YCSBQuery
    rng = np.random.default_rng(seed)
    n = max(cfg.epoch_batch, cfg.max_txn_in_flight)
    r, e = cfg.req_per_query, EPOCHS + 2
    u = rng.random((e, n, r)) ** (10 if hot else 3)
    keys = np.minimum(cfg.synth_table_size * u,
                      cfg.synth_table_size - 1).astype(np.int32)
    is_w = rng.random((e, n, r)) < 0.5
    jk, jw = jnp.asarray(keys), jnp.asarray(is_w)
    tk, tw = torch.from_numpy(keys), torch.from_numpy(is_w)

    def j_gen(key, m):
        i = (key[1] % e).astype(jnp.int32)
        return JQuery(keys=jax.lax.dynamic_index_in_dim(jk, i, 0, False)[:m],
                      is_write=jax.lax.dynamic_index_in_dim(jw, i, 0,
                                                            False)[:m])

    def t_gen(key, m):
        i = int(key[1] % e)
        return YCSBQuery(keys=tk[i, :m].clone(), is_write=tw[i, :m].clone())
    jwl.generate = j_gen
    twl.generate = t_gen


@pytest.mark.parametrize("case", list(CASES))
def test_epochs_match_reference_at_d8(case):
    args = CASES[case] + ["--device_parts=8"]
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    if case.startswith("ycsb"):
        _inject(jeng.workload, teng.workload, tcfg, 11,
                hot=case in ("ycsb-tight", "ycsb-abort-mode"))
    js = jeng.init_state(seed=5)
    assert_same_mc_state(js, teng.init_state(seed=5))
    ts = convert.from_reference_state(jax.device_get(js), tcfg, "cpu")
    place, run = j_sharded_run(jeng, j_make_mesh(8))
    js = run(place(js), EPOCHS)
    tplace, trun = make_sharded_run(teng, make_mesh(8, devices=CPU8))
    ts = trun(tplace(ts), EPOCHS)
    assert_same_mc_state(js, ts)
    st = {k: int(v.sum()) for k, v in ts.stats.items()}
    assert st["total_txn_commit_cnt"] > 0
    if case == "ycsb-tight":
        assert st["defer_cnt"] > 0 and st["total_txn_abort_cnt"] == 0
        assert st["total_txn_commit_cnt"] + int(ts.pool.occupied.sum()) \
            == st["admitted_cnt"]
    if case == "ycsb-abort-mode":
        assert st["total_txn_abort_cnt"] > 0
    if case == "ycsb-MVCC":
        assert "MAIN_TABLE.F0.ver" not in ts.db


# -- the port at D = 8 against the port at D = 1 ------------------------

SELF = ["ycsb-sharded", "ycsb-replicated-plan", "ycsb-abort-mode",
        "ycsb-full-row", "ycsb-OCC", "ycsb-TIMESTAMP", "ycsb-CALVIN",
        "tpcc-TPU_BATCH", "tpcc-NO_WAIT", "pps-TPU_BATCH", "pps-MAAT"]


def _rows(tab, col):
    """A table column's rows [0, capacity) in global order, or for a
    stacked ring table its blocks' filled rows."""
    v = tab.columns[col]
    if tab.mc_parts == 1:
        return v[:tab.capacity]
    if not tab.ring:
        return v[ttable.mc_stacked_rows(tab)]
    lb, local, _ = tab.mc_block_rows()
    return v.reshape(tab.mc_parts, lb, *v.shape[1:])[:, :local].reshape(
        -1, *v.shape[1:])


@pytest.mark.parametrize("case", SELF)
def test_d8_equals_d1(case):
    one, _ = _port_run(CASES[case], 8, 3)
    eight, _ = _port_run(CASES[case], 8, 3, d=8)
    for k, v in one.stats.items():
        assert torch.equal(v, eight.stats[k]), k
    assert int(one.stats["total_txn_commit_cnt"]) > 0
    for name, t1 in one.db.items():
        t8 = eight.db[name]
        for col in t1.columns:
            a, b = _rows(t1, col), _rows(t8, col)
            if t1.ring:
                # per-block cursors: the same values, in another order
                np.testing.assert_array_equal(
                    np.sort(a[a != 0].numpy()), np.sort(b[b != 0].numpy()),
                    err_msg=f"{name}/{col}")
            else:
                assert torch.equal(a, b), f"{name}/{col}"
        if t1.ring:
            assert int(t1.row_cnt) == int(t8.row_cnt.sum()), name


def test_tight_capacity_defers_and_conserves_at_every_mesh_size():
    for d in (2, 4, 8):
        st, _ = _port_run(CASES["ycsb-tight"], 4, 4, d=d)
        c = {k: int(v.sum()) for k, v in st.stats.items()}
        assert c["defer_cnt"] > 0 and c["total_txn_abort_cnt"] == 0, d
        assert c["total_txn_commit_cnt"] + int(st.pool.occupied.sum()) \
            == c["admitted_cnt"]


# -- config, mesh, driver -------------------------------------------------

def test_device_parts_is_admitted_like_reference():
    for args in (ycsb_args(device_parts=8),
                 ycsb_args(device_parts=4, mc_plan_capacity=0.5),
                 ycsb_args(device_parts=8, max_accesses=200,
                           mc_plan_capacity=0),
                 tpcc_args(device_parts=8), pps_args(device_parts=8),
                 ycsb_args(device_parts=2, cc_alg="DGCC")):
        mine, ref = Config.from_args(args), JConfig.from_args(args)
        for f in dataclasses.fields(Config):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert Config().mc_plan_capacity == JConfig().mc_plan_capacity == 2.0


PINS = [
    (ycsb_args(part_cnt=2), "do not compose yet"),
    (ycsb_args(max_accesses=200), "max_accesses <= 128"),
    (ycsb_args(synth_table_size=4100), "synth_table_size must divide"),
    (tpcc_args(num_wh=4), "num_wh must divide"),
    (tpcc_args(insert_table_cap=1004), "insert_table_cap must divide"),
    (pps_args(pps_parts_cnt=404), "pps_parts_cnt must divide"),
    (ycsb_args(metrics=True), "metrics bus"),
    (ycsb_args(audit=True, cc_alg="OCC"), "audit observations"),
    (ycsb_args(repair=True, cc_alg="OCC"), "repair sub-rounds"),
    (tpcc_args(tpcc_order_index=True), "tpcc_order_index does not")]


@pytest.mark.parametrize("args,match", PINS, ids=[m for _, m in PINS])
def test_pins_raise_like_reference(args, match):
    args = args + ["--device_parts=8"]
    msgs = []
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match=match) as e:
            cls.from_args(args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("flag,match", [
    ("--elastic=true", "elastic"), ("--ctrl=true", "needs --metrics")],
    ids=["--elastic=true-elastic", "--ctrl=true-ctrl router"])
def test_refused_planes_pin_before_their_roadmap_raise(flag, match):
    """elastic is refused as not ported, and at D > 1 the reference's pin
    raises first, with its message; ctrl is ported, and raises the
    reference's pins with their messages (at D > 1 and D = 1 alike,
    metrics first)."""
    with pytest.raises(ValueError, match=match):
        Config.from_args(ycsb_args(device_parts=2) + [flag])
    if flag == "--elastic=true":
        with pytest.raises(NotImplementedError):
            Config.from_args(ycsb_args() + [flag])
        return
    for args in (ycsb_args(device_parts=2), ycsb_args()):
        msgs = []
        for cls in (Config, JConfig):
            with pytest.raises(ValueError, match=match) as e:
                cls.from_args(args + [flag])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_mesh_and_collectives():
    with pytest.raises(RuntimeError, match="need 8 devices"):
        make_mesh(8)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.one_device
    parts = [torch.tensor(2**32 - 1 - i, dtype=torch.int64) for i in range(4)]
    assert int(mesh.psum(parts)) == (4 * (2**32 - 1) - 6) % 2**32
    blocks = [tuple(torch.arange(8).reshape(4, 2) + 100 * s for _ in range(2))
              for s in range(4)]
    recv = mesh.all_to_all(blocks)
    assert recv[1][0].tolist() == [2, 3, 102, 103, 202, 203, 302, 303]
    cfg = Config.from_args(ycsb_args(device_parts=4))
    eng = Engine(cfg, get_workload(cfg, device="cpu"))
    place, _ = make_sharded_run(eng, make_mesh(4, devices=["cpu", "meta",
                                                          "cpu", "cpu"]))
    with pytest.raises(NotImplementedError, match="item 19b"):
        place(eng.init_state())
    with pytest.raises(ValueError, match="a mesh of 2"):
        make_sharded_run(eng, make_mesh(2, devices=["cpu"] * 2))


def test_a2a_bytes_match_reference():
    for args in (ycsb_args(device_parts=8, epoch_batch=4096,
                           max_txn_in_flight=4096),
                 ycsb_args(device_parts=8),
                 ycsb_args(device_parts=8, epoch_batch=65536,
                           max_txn_in_flight=65536, max_accesses=10,
                           req_per_query=10)):
        t, j = Config.from_args(args), JConfig.from_args(args)
        assert a2a_bytes_per_epoch(t, t.epoch_batch) \
            == j_a2a_bytes(j, j.epoch_batch)
    t = Config.from_args(ycsb_args(device_parts=8, epoch_batch=65536,
                                   max_txn_in_flight=65536,
                                   max_accesses=10, req_per_query=10))
    assert a2a_bytes_per_epoch(t, 65536) == 8 * 8 * 20480 * 9


def test_mesh_paths_refuse_without_a_mesh():
    cfg = Config.from_args(CASES["ycsb-OCC"] + ["--device_parts=8"])
    wl = get_workload(cfg, device="cpu")
    eng = Engine(cfg, wl)
    st = eng.init_state()
    with pytest.raises(RuntimeError, match="use_mesh"):
        mc_execute(cfg, wl, st.db, st.pool.queries,
                   torch.zeros(256, dtype=torch.bool),
                   torch.zeros(256, dtype=torch.int32),
                   torch.zeros(256, dtype=torch.int32), dict(st.stats),
                   chained=False)
    with pytest.raises(RuntimeError, match="use_mesh"):
        eng.run(st, 1)


def test_run_simulation_at_d8_on_the_cpu(capsys):
    from deneva_tpu_torch.engine.driver import run_simulation
    # pair_cap 128 < 512 lanes a slice: the sharded plan
    cfg = Config.from_args(ycsb_args(
        epoch_batch=1024, max_txn_in_flight=1024, device_parts=8,
        warmup_secs=0, done_secs=0.3, prog_timer_secs=0))
    assert forward.mc_pair_cap(1024, 4, 8, cfg.mc_plan_capacity) == 128
    with use_mesh(make_mesh(8, devices=CPU8)):
        st = run_simulation(cfg, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == st.summary_line()
    f = st.summary_fields()
    assert f["total_txn_commit_cnt"] > 0 and f["total_txn_abort_cnt"] == 0
    with pytest.raises(RuntimeError, match="need 8 devices"):
        run_simulation(cfg)
    with use_mesh(make_mesh(8, devices=CPU8)):
        with pytest.raises(ValueError, match="first device"):
            run_simulation(cfg, device="meta")
