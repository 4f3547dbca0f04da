"""Partitioned keyspaces (``part_cnt > 1``) in one process: the port holds
node 0's striped view and is held to ``deneva_tpu`` leaf by leaf.

* the striped YCSB loader and both indexes (the strided `DenseIndex` and
  the `SortedIndex` over the owned keys) at ``part_cnt`` 2 and 4;
* epochs of YCSB forwarding (fingerprint and full row), OCC, MVCC and
  IDX_BTREE, TPC-C at 4 warehouses over 2 partitions, and PPS over 4,
  from the reference's carried state, with the metrics plane's
  per-partition ``conflict_density`` (int32[P]) among the counters;
* the density at ``tests/test_metricsbus.py:150-170``'s shape.

The trash row (ROADMAP.md watch item 37): a key this node does not own
resolves to each table's trash slot.  The reference stores the winners
of such keys and its masked lanes there, in an order it leaves open, and
its gathers of those keys read the row back into ``read_checksum``; no
store of the port writes it, so it keeps its loader value (0).  The
tests hold the two to one exact rule: the reference's YCSB ``execute``
is wrapped so that its trash rows (F0's and the version ring's) are put
back after every call, and the carried state starts with zero trash
rows.  Every pass then reads the same trash value in both packages, and
``read_checksum`` compares exactly on every path, one-pass or not.  The
port's trash and pad rows must stay 0; data rows ``[0, n_local)`` and
every other leaf must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _inject
from test_torch_repair import zipf_bank

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu.workloads import ycsb as jy
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.workloads import get_workload, ycsb

YCSB = ["--synth_table_size=4096", "--req_per_query=4", "--max_accesses=4",
        "--epoch_batch=128", "--max_txn_in_flight=512",
        "--conflict_buckets=4096", "--zipf_theta=0.6", "--read_perc=0.5",
        "--write_perc=0.5", "--seed=5", "--metrics=true"]
TPCC = ["--workload=TPCC", "--num_wh=4", "--part_cnt=2",
        "--cust_per_dist=120", "--max_items=200", "--max_items_per_txn=5",
        "--max_accesses=8", "--epoch_batch=64", "--max_txn_in_flight=256",
        "--metrics=true"]
PPS = ["--workload=PPS", "--part_cnt=4", "--pps_parts_cnt=500",
       "--pps_products_cnt=100", "--pps_suppliers_cnt=100",
       "--pps_parts_per=4", "--max_accesses=16", "--epoch_batch=64",
       "--max_txn_in_flight=256", "--metrics=true"]
PRE, EPOCHS = 2, 3


def restore_trash(jwl) -> None:
    """Wrap the reference YCSB workload's ``execute`` so that it puts back
    the rows at and past ``capacity`` of F0 and of the version ring: its
    trash rows then hold what the port's hold (see the module
    docstring)."""
    orig = jwl.execute

    def execute(db, *args, **kw):
        out = dict(orig(db, *args, **kw))
        tab, old = out[jy.TABLE], db[jy.TABLE]
        cap = tab.capacity
        out[jy.TABLE] = tab._replace(columns={
            c: v.at[cap:].set(old.columns[c][cap:])
            for c, v in tab.columns.items()})
        if jy.VER_TABLE in out:
            ring, h = out[jy.VER_TABLE], out[jy.VER_TABLE].depth
            out[jy.VER_TABLE] = type(ring)(
                wts=ring.wts.at[cap * h:].set(db[jy.VER_TABLE].wts[cap * h:]),
                depth=h)
        return out
    jwl.execute = execute


def zero_trash(js):
    """The reference's host state with every table's rows at and past
    ``capacity`` (and the version ring's) set to 0, as the port keeps
    them."""
    db = dict(js.db)
    for name, tab in js.db.items():
        if hasattr(tab, "columns"):
            cap = tab.capacity
            cols = {}
            for c, v in tab.columns.items():
                v = np.array(v)
                v[cap:] = 0
                cols[c] = v
            db[name] = tab._replace(columns=cols)
        elif hasattr(tab, "wts"):
            cap = js.db[jy.TABLE].capacity
            wts = np.array(tab.wts)
            wts[cap * tab.depth:] = 0
            db[name] = type(tab)(wts=wts, depth=tab.depth)
    return js.__class__(db=db, cc_state=js.cc_state, pool=js.pool,
                        rng=js.rng, epoch=js.epoch, stats=js.stats)


def assert_same(jstate, tstate) -> None:
    """Leaf by leaf: table rows ``[0, capacity)`` (the ring's rows too),
    the port's trash and pad rows 0, every other leaf exact."""
    ref = convert.flatten_reference(jax.device_get(jstate))
    got = convert.to_numpy_state(tstate)
    assert sorted(ref) == sorted(got)
    caps = {n: t.capacity for n, t in tstate.db.items()
            if hasattr(t, "capacity")}
    for path, want in ref.items():
        have = got[path]
        assert have.dtype == want.dtype and have.shape == want.shape, path
        name = path.split("/")[1] if path.startswith("db/") else None
        cap = caps.get(name)
        if path == f"db/{ycsb.VER_TABLE}/wts":
            cap = caps[ycsb.TABLE] * tstate.db[ycsb.VER_TABLE].depth
        if cap is not None and have.ndim >= 1 and have.shape[0] > cap:
            np.testing.assert_array_equal(have[:cap], want[:cap],
                                          err_msg=path)
            assert not have[cap:].any(), f"{path}: trash or pad row written"
        else:
            np.testing.assert_array_equal(have, want, err_msg=path)


def engines(args, bank=True):
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    if tcfg.workload.value == "YCSB":
        restore_trash(jeng.workload)
        if bank:
            keys, is_w = zipf_bank(tcfg.synth_table_size, tcfg.zipf_theta,
                                   n=max(tcfg.epoch_batch,
                                         tcfg.max_txn_in_flight),
                                   r=tcfg.req_per_query,
                                   write_perc=tcfg.write_perc)
            _inject(jeng.workload, teng.workload, keys, is_w)
    return jeng, teng, tcfg


def carried(jeng, tcfg, pre=PRE, step=None):
    """``pre`` reference epochs (``step``, one compiled epoch, default
    ``jit_step``), trash rows zeroed, carried to the port."""
    step = step or jeng.jit_step
    js = jeng.init_state()
    for _ in range(pre):
        js = step(js)
    js = zero_trash(jax.device_get(js))
    return js, convert.from_reference_state(js, tcfg, "cpu")


def run_both(args, epochs=EPOCHS):
    """Epochs in both packages from one carried state, compared after
    each; returns the port's final state."""
    jeng, teng, tcfg = engines(args)
    js, ts = carried(jeng, tcfg)
    for _ in range(epochs):
        js = jeng.jit_step(jax.tree.map(jnp.asarray, js))
        ts = teng.step(ts)
        assert_same(js, ts)
    return ts


def non_owned_lanes(ts, cfg) -> int:
    """Lanes of the pool's queries whose key another partition owns."""
    keys = ts.pool.queries.keys
    return int((keys % cfg.part_cnt != cfg.node_id).sum())


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("index", ["IDX_HASH", "IDX_BTREE"])
def test_striped_loader_and_index_match_reference(parts, index):
    args = ["--synth_table_size=1000", "--epoch_batch=64",
            "--max_txn_in_flight=64", f"--part_cnt={parts}",
            f"--index_struct={index}"]
    jwl = jy.YCSBWorkload(JConfig.from_args(args))
    twl = ycsb.YCSBWorkload(Config.from_args(args), device="cpu")
    assert twl.n_local == jwl.n_local == 1000 // parts
    jdb, tdb = jwl.load(), twl.load(chunk=100)
    want = np.asarray(jdb[jy.TABLE].columns["F0"])
    got = tdb[ycsb.TABLE].columns["F0"].numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    keys = np.arange(-3, 1010, dtype=np.int32)
    np.testing.assert_array_equal(
        twl._local_slots(None, torch.from_numpy(keys)).numpy(),
        np.asarray(jwl._local_slots(None, jnp.asarray(keys))))
    owned = keys[(keys >= 0) & (keys < 1000) & (keys % parts == 0)]
    slots = twl._local_slots(None, torch.from_numpy(owned)).numpy()
    np.testing.assert_array_equal(slots, owned // parts)
    miss = twl._local_slots(None, torch.from_numpy(owned + 1)).numpy()
    assert (miss == twl.n_local).all()


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("alg,extra", [
    ("TPU_BATCH", []), ("TPU_BATCH", ["--sim_full_row=true",
                                      "--tup_size=8",
                                      "--field_per_tuple=2"]),
    ("OCC", []), ("MVCC", ["--watermark_buckets=64"]),
    ("TPU_BATCH", ["--index_struct=IDX_BTREE"])],
    ids=["forward", "forward_full_row", "occ", "mvcc", "btree"])
def test_ycsb_epochs_match_reference(parts, alg, extra):
    args = YCSB + [f"--part_cnt={parts}", f"--cc_alg={alg}"] + extra
    ts = run_both(args)
    st = {k: v for k, v in ts.stats.items()}
    assert int(st["total_txn_commit_cnt"]) > 0
    assert st["conflict_density"].shape == (parts,)
    assert int(st["conflict_density"].sum()) > 0
    assert non_owned_lanes(ts, Config.from_args(args)) > 0


@pytest.mark.parametrize("alg", ["TPU_BATCH", "OCC", "NO_WAIT", "MVCC"])
def test_tpcc_epochs_match_reference(alg):
    ts = run_both(TPCC + [f"--cc_alg={alg}"])
    assert int(ts.stats["total_txn_commit_cnt"]) > 0
    # the remote warehouses' HISTORY / ORDER rows land nowhere here
    assert int(ts.db["WAREHOUSE"].capacity) == 2


@pytest.mark.parametrize("alg", ["TPU_BATCH", "OCC"])
def test_pps_epochs_match_reference(alg):
    ts = run_both(PPS + [f"--cc_alg={alg}"])
    assert int(ts.stats["total_txn_commit_cnt"]) > 0
    assert ts.db["PARTS"].capacity == 125


@pytest.mark.parametrize("theta", [0.0, 0.9])
def test_partition_density_matches_reference(theta):
    """``tests/test_metricsbus.py:150-170``'s engine (OCC, 1,024 rows,
    2,048 buckets, part_cnt 4): the per-partition density after 12
    epochs equals the reference's, partition by partition."""
    args = ["--cc_alg=OCC", "--epoch_batch=64", "--conflict_buckets=2048",
            "--synth_table_size=1024", "--max_txn_in_flight=128",
            "--req_per_query=4", "--max_accesses=4", f"--zipf_theta={theta}",
            "--write_perc=0.9", "--read_perc=0.1", "--part_cnt=4",
            "--metrics=true"]
    jeng, teng, tcfg = engines(args)
    js, ts = carried(jeng, tcfg, pre=1)
    for _ in range(11):
        js = jeng.jit_step(jax.tree.map(jnp.asarray, js))
    ts = teng.run(ts, 11)
    assert_same(js, ts)
    dens = ts.stats["conflict_density"]
    assert dens.shape == (4,) and (dens > 0).all()


def test_divisibility_checks_raise_like_reference():
    bad = ["--synth_table_size=1001", "--part_cnt=2", "--epoch_batch=64",
           "--max_txn_in_flight=64"]
    for mod, cfg in ((jy, JConfig.from_args(bad)),
                     (ycsb, Config.from_args(bad))):
        kw = {} if mod is jy else {"device": "cpu"}
        with pytest.raises(AssertionError, match="divide evenly"):
            mod.YCSBWorkload(cfg, **kw)
    for args, what in ((["--workload=TPCC", "--num_wh=3", "--part_cnt=2",
                         "--max_accesses=18"], "num_wh"),
                       (["--workload=PPS", "--pps_parts_cnt=501",
                         "--part_cnt=4", "--max_accesses=32"],
                        "pps_parts_cnt")):
        for get, cfg in ((j_workload, JConfig.from_args(args)),
                         (lambda c: get_workload(c, device="cpu"),
                          Config.from_args(args))):
            with pytest.raises(ValueError, match=f"{what} must divide"):
                get(cfg)


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("args", [YCSB, TPCC, PPS],
                         ids=["ycsb", "tpcc", "pps"])
def test_striped_scatter_keeps_the_trash_row(args, parts):
    """Every table a workload loads at part_cnt > 1 is striped, and a
    striped table's scatter leaves its trash row as loaded: a lane aimed
    there (a key another partition owns) stores the row's own value back,
    beside a data row it writes.  At part_cnt = 1 no gather reads the
    trash row and the scatter is the plain one, whose trash row takes
    the lanes' values."""
    cfg = Config.from_args(args + [f"--part_cnt={parts}"])
    db = get_workload(cfg, device="cpu").load()
    tabs = {n: t for n, t in db.items() if hasattr(t, "columns")}
    assert tabs
    for name, t in tabs.items():
        assert t.striped == (parts > 1), name
        cap = t.capacity
        for c, col in t.columns.items():
            before = col.clone()
            vals = torch.tensor([7, 9, 11]).reshape(
                (3,) + (1,) * (col.ndim - 1)).expand(
                (3,) + tuple(col.shape[1:])).to(col.dtype)
            t.scatter(torch.tensor([0, cap, cap], dtype=torch.int32),
                      {c: vals})
            assert torch.equal(col[0], vals[0]), (name, c)
            if parts > 1:
                assert torch.equal(col[cap], before[cap]), (name, c)
            else:
                assert any(torch.equal(col[cap], v) for v in vals[1:])
            assert torch.equal(col[cap + 1:], before[cap + 1:]), (name, c)


def test_non_owned_reads_take_the_trash_value():
    """A forwarding epoch at part_cnt 4 against a numpy oracle: each
    committed read of an owned key folds the epoch-start F0 of its slot
    (or its forwarded writer's value), each read of a key another
    partition owns folds the trash row's 0 unless forwarded, and the
    winners of owned keys store f(key, rank) while the trash row stays
    0."""
    args = YCSB + ["--part_cnt=4", "--cc_alg=TPU_BATCH",
                   "--epoch_batch=512"]
    cfg = Config.from_args(args)
    eng = Engine(cfg, get_workload(cfg, device="cpu"))
    keys, is_w = zipf_bank(cfg.synth_table_size, cfg.zipf_theta, n=512,
                           r=4, write_perc=0.5)
    from types import SimpleNamespace
    _inject(SimpleNamespace(), eng.workload, keys, is_w)
    st = eng.run(eng.init_state(), 2)
    f0 = st.db[ycsb.TABLE].columns["F0"].numpy().view(np.uint32).copy()
    pre = int(st.stats["read_checksum"])
    st = eng.step(st)
    q = st.pool.queries
    qk, qw = q.keys.numpy().astype(np.int64), q.is_write.numpy()
    rank = st.pool.seq.numpy().astype(np.int64)
    n = qk.shape[0]
    # serial replay in rank order over the whole keyspace's versions
    fp = lambda k, v: ((k * 2654435761) ^ (v * 0x9E3779B9)) \
        & 0xFFFFFFFF | 1                                    # noqa: E731
    last = {}
    cks = 0
    for t in np.argsort(rank, kind="stable"):
        # a read sees the writers of lower rank, not its own txn's
        for a in range(qk.shape[1]):
            k = int(qk[t, a])
            if qw[t, a]:
                continue
            if k in last:
                cks += fp(k, last[k])
            elif k % 4 == 0:
                cks += int(f0[k // 4])
        for a in range(qk.shape[1]):
            if qw[t, a]:
                last[int(qk[t, a])] = int(rank[t])
    assert (int(st.stats["read_checksum"]) - pre) & 0xFFFFFFFF \
        == cks & 0xFFFFFFFF
    got = st.db[ycsb.TABLE].columns["F0"].numpy().view(np.uint32)
    for k, r in last.items():
        if k % 4 == 0:
            assert got[k // 4] == fp(k, r)
    assert not got[cfg.synth_table_size // 4:].any()
    assert n == 512
