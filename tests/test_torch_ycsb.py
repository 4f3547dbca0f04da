"""Port parity: YCSB's value law and forward-execute (K3 plain version)
against ``deneva_tpu.workloads.ycsb`` on the same numpy-seeded inputs,
and a numpy model of K3's one cooperative launch (``csrc/ycsb.cu``: the
grid-stride gathers and block partials, the grid barrier, the winners'
stores, full rows walked a warp at a time) held to both.

All integer results are exact: table bytes, the uint32 read checksum
and ``write_cnt``.  Two rows are outside the comparison where the
reference leaves their content unspecified:

* ``mono=False`` scatters every loser into the trash row (slot
  ``capacity``), XLA's duplicate order picking the survivor;
* ``mono=True``'s ``.at[-1].set(mode="drop")`` wraps index -1 to the
  LAST PADDED ROW before dropping, so the lanes before the first winner
  leave one of their values there.  The port drops them and leaves
  padded rows untouched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.ops import forward as jf
from deneva_tpu.workloads import ycsb as jy
from deneva_tpu_torch.ops.forward import ForwardPlan
from deneva_tpu_torch.workloads import ycsb as ty


def test_field_fingerprint_matches_reference_near_int32_edges():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 2**31 - 2, 2**31 - 1, -1, -2**31], np.int64)
    keys = np.concatenate([edge, rng.integers(2**31 - 5000, 2**31, 500),
                           rng.integers(0, 2**31, 500)]).astype(np.int32)
    vers = np.concatenate([edge[::-1], rng.integers(2**31 - 5000, 2**31, 500),
                           rng.integers(-2**31, 2**31, 500)]).astype(np.int32)
    want = np.asarray(jy._field_fingerprint(jnp.asarray(keys),
                                            jnp.asarray(vers)))
    got = ty._field_fingerprint(torch.from_numpy(keys),
                                torch.from_numpy(vers)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2**32


@pytest.mark.parametrize("nbytes", [100, 24])
def test_field_bytes_matches_reference(nbytes):
    rng = np.random.default_rng(1)
    keys = np.concatenate([[2**31 - 1, 0], rng.integers(2**31 - 1000, 2**31,
                                                        200)]).astype(np.int32)
    vers = np.concatenate([[2**31 - 1, -1], rng.integers(2**31 - 1000, 2**31,
                                                         200)]).astype(np.int32)
    want = np.asarray(jy._field_bytes(jnp.asarray(keys), jnp.asarray(vers),
                                      nbytes))
    got = ty._field_bytes(torch.from_numpy(keys), torch.from_numpy(vers),
                          nbytes).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _plan_inputs(seed, n=2048, tab=256):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 96, n).astype(np.int32)   # heavy duplication
    keys[rng.random(n) < 0.05] = np.iinfo(np.int32).max
    rank = np.repeat(1 + np.arange(n // 4, dtype=np.int32), 4)
    w = (rng.random(n) < 0.5) & (keys != np.iinfo(np.int32).max)
    jp = jf.forward_plan_flat(jnp.asarray(keys), jnp.asarray(rank),
                              jnp.asarray(w))
    tp = ForwardPlan(**{f: torch.from_numpy(np.array(getattr(jp, f)))
                        for f in ("keys", "rank", "is_read", "is_write",
                                  "fwd", "win")}, perm=None)
    slots = np.where(np.asarray(jp.keys) < tab, np.asarray(jp.keys), tab)
    return jp, tp, slots.astype(np.int32)


@pytest.mark.parametrize("mono", [True, False])
@pytest.mark.parametrize("width", [0, 100])
def test_forward_execute_matches_reference(mono, width):
    tab = 256
    jp, tp, slots = _plan_inputs(7 + width + mono, tab=tab)
    rng = np.random.default_rng(3)
    rows = -(-(tab + 1) // 64) * 64
    if width:
        f0 = rng.integers(0, 256, (rows, width), dtype=np.uint8)
        tf0 = torch.from_numpy(f0.copy())
    else:
        f0 = rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32)
        tf0 = torch.from_numpy(f0.view(np.int32).copy())
    jf0, jcks, jw = jy._forward_execute_f0(jnp.asarray(f0), jp,
                                           jnp.asarray(slots), tab, mono=mono)
    out, cks, wcnt = ty._forward_execute_f0(tf0, tp, torch.from_numpy(slots),
                                            tab, mono=mono)
    got = out.numpy() if width else out.numpy().view(np.uint32)
    want = np.asarray(jf0)
    defined = tab + 1 if mono else tab      # see the module docstring
    np.testing.assert_array_equal(got[:defined], want[:defined])
    np.testing.assert_array_equal(got[tab + 1:], f0[tab + 1:])
    assert int(cks) == int(jcks) and int(wcnt) == int(jw)
    assert got[:tab].tobytes() != f0[:tab].tobytes()      # winners landed


def test_load_and_plan_match_reference():
    from deneva_tpu.config import Config as JConfig
    from deneva_tpu_torch.config import Config
    args = ["--synth_table_size=1000", "--epoch_batch=64",
            "--max_txn_in_flight=64", "--sim_full_row=true",
            "--field_per_tuple=3", "--tup_size=16"]
    jwl = jy.YCSBWorkload(JConfig.from_args(args))
    twl = ty.YCSBWorkload(Config.from_args(args), device="cpu")
    jdb, tdb = jwl.load(), twl.load(chunk=300)
    for col, arr in jdb[jy.TABLE].columns.items():
        np.testing.assert_array_equal(tdb[ty.TABLE].columns[col].numpy(),
                                      np.asarray(arr))
    keys = np.random.default_rng(2).integers(0, 1000, (64, 10)).astype(
        np.int32)
    isw = np.random.default_rng(3).random((64, 10)) < 0.5
    jpl = jwl.plan(jdb, jy.YCSBQuery(jnp.asarray(keys), jnp.asarray(isw)))
    tpl = twl.plan(tdb, ty.YCSBQuery(torch.from_numpy(keys),
                                     torch.from_numpy(isw)))
    for f in ("table_ids", "keys", "is_read", "is_write", "valid", "owner"):
        np.testing.assert_array_equal(tpl[f].numpy(), np.asarray(jpl[f]))
    np.testing.assert_array_equal(
        twl.txn_type_of(ty.YCSBQuery(torch.from_numpy(keys),
                                     torch.from_numpy(isw))).numpy(),
        np.asarray(jwl.txn_type_of(jy.YCSBQuery(jnp.asarray(keys),
                                                jnp.asarray(isw)))))


@pytest.mark.parametrize("base,stride", [(0, 1), (2, 3)])
def test_dense_index_matches_reference(base, stride):
    from deneva_tpu.storage.index import DenseIndex as JIndex
    from deneva_tpu_torch.storage.index import DenseIndex
    keys = np.concatenate([np.arange(-5, 400), [2**31 - 1, -2**31]]).astype(
        np.int32)
    want = JIndex(base, stride, 100, 100).lookup(jnp.asarray(keys))
    got = DenseIndex(base, stride, 100, 100).lookup(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_table_gather_scatter_match_reference():
    from deneva_tpu.storage.table import DeviceTable as JTable
    from deneva_tpu_torch.storage.catalog import parse_schema
    from deneva_tpu_torch.storage.table import DeviceTable
    schema = parse_schema(jy.YCSB_SCHEMA).table(jy.TABLE)
    jt = JTable.create(schema, 100)
    tt = DeviceTable.create(schema, 100, "cpu")
    rng = np.random.default_rng(4)
    slots = rng.permutation(np.arange(-3, 110))[:60].astype(np.int32)
    vals = rng.integers(0, 2**32, 60, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(60) < 0.7
    jt = jt.scatter(jnp.asarray(slots), {"F3": jnp.asarray(vals)},
                    mask=jnp.asarray(mask))
    tt.scatter(torch.from_numpy(slots), {"F3": torch.from_numpy(
        vals.view(np.int32))}, mask=torch.from_numpy(mask))
    got = tt.columns["F3"].numpy().view(np.uint32)
    np.testing.assert_array_equal(got[:100], np.asarray(jt.columns["F3"])[:100])
    rs = rng.integers(-5, 120, 50).astype(np.int32)
    np.testing.assert_array_equal(
        tt.gather(torch.from_numpy(rs), ("F3",))["F3"].numpy()[
            (rs >= 0) & (rs < 100)].view(np.uint32),
        np.asarray(jt.gather(jnp.asarray(rs), ("F3",))["F3"])[
            (rs >= 0) & (rs < 100)])


# -- HOT keys, key_order, txn_write_perc (K4b's options) ---------------------

GEN = ["--epoch_batch=256", "--max_txn_in_flight=256",
       "--synth_table_size=4096", "--req_per_query=10"]


@pytest.mark.parametrize("flags", [
    ["--skew_method=HOT", "--data_perc=16", "--access_perc=0.5"],
    ["--skew_method=HOT", "--data_perc=100", "--access_perc=0.9",
     "--key_order=true"],
    ["--skew_method=HOT", "--data_perc=3000", "--access_perc=0.03",
     "--txn_write_perc=0.25", "--write_perc=0.8", "--read_perc=0.2"],
    ["--zipf_theta=0", "--key_order=true", "--txn_write_perc=0.5"],
    ["--skew_method=HOT", "--data_perc=16", "--access_perc=0.5",
     "--key_order=true", "--txn_write_perc=0.25"]])
@pytest.mark.parametrize("seed", [7, -3])
def test_generate_options_match_reference(flags, seed):
    import jax

    from deneva_tpu.config import Config as JConfig
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.ops import prng
    jwl = jy.YCSBWorkload(JConfig.from_args(GEN + flags))
    twl = ty.YCSBWorkload(Config.from_args(GEN + flags), device="cpu")
    jq = jwl.generate(jax.random.PRNGKey(seed), 2048)
    tq = twl.generate(prng.key_from_seed(seed, "cpu"), 2048)
    np.testing.assert_array_equal(tq.keys.numpy(), np.asarray(jq.keys))
    np.testing.assert_array_equal(tq.is_write.numpy(),
                                  np.asarray(jq.is_write))
    keys = tq.keys.numpy()
    if "--key_order=true" in flags:
        assert (np.diff(keys, axis=1) >= 0).all()
    if "--txn_write_perc=0.25" in flags:
        assert 0.6 < (~tq.is_write.numpy().any(axis=1)).mean() < 0.9


@pytest.mark.parametrize("alg,pool,extra", [
    ("TPU_BATCH", 256, ["--key_order=true", "--txn_write_perc=0.25"]),
    ("MAAT", 1024, []),
    ("OCC", 1024, ["--txn_write_perc=0.5", "--sim_full_row=true"])])
def test_hot_generated_epochs_match_reference(alg, pool, extra):
    """Generated epochs at HOT (beside ``tests/test_engine.py:300``): the
    whole path, the threefry stream and the HOT draws included, is
    bit-exact, so nothing is injected."""
    import jax
    from test_torch_occ import _assert_same

    from deneva_tpu.config import Config as JConfig
    from deneva_tpu.engine.step import Engine as JEngine
    from deneva_tpu.workloads import get_workload as j_workload
    from deneva_tpu_torch import convert
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads import get_workload
    args = ["--epoch_batch=256", f"--max_txn_in_flight={pool}",
            "--synth_table_size=4096", "--conflict_buckets=1024",
            "--skew_method=HOT", "--data_perc=16", "--access_perc=0.5",
            f"--cc_alg={alg}", "--field_per_tuple=10", "--tup_size=100",
            "--seed=11"] + extra
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    js = jeng.init_state()
    ts = convert.from_reference_state(jax.device_get(js), tcfg, "cpu")
    js, ts = jeng.jit_run(js, 5), teng.run(ts, 5)
    _assert_same(js, ts, tcfg.synth_table_size)
    assert int(ts.stats["total_txn_commit_cnt"]) > 0


# -- a numpy model of K3's cooperative launch (csrc/ycsb.cu) ---------------

M32 = 0xFFFFFFFF


def _np_fp(k, v):
    k = k.astype(np.int64) & M32
    v = v.astype(np.int64) & M32
    return (((k * ty.FP_MUL_KEY) & M32) ^ ((v * ty.FP_MUL_VER) & M32)) | 1


def _np_word(fp, u):
    """Bytes 4u .. 4u + 3 of the payload of fingerprint fp (value_law.cuh
    word_law), as four uint8."""
    b = 4 * u[:, None] + np.arange(4)
    coef = (b * ty.FP_MUL_KEY + ty.FP_MUL_VER) & M32
    return ((((fp[:, None] * coef) & M32) >> 13) & 0xFF).astype(np.uint8)


def _warp_walk(listed, words):
    """The (row, word) pairs a warp's steps visit for its listed rows
    (``row_words``): a running (r, u) per warp lane, r * words + u
    advancing 32 a step, no division after the first."""
    q, rem = divmod(32, words)
    lane = np.arange(32)
    r, u = lane // words, lane % words
    total = len(listed) * words
    for t0 in range(0, total, 32):
        act = t0 + lane < total
        yield listed[r[act]], u[act]
        r, u = r + q, u + rem
        wrap = u >= words
        r, u = r + wrap, u - words * wrap


def k3_model(f0, plan, slots, cap, grid, threads=1024):
    """K3 as its one cooperative launch runs it: ``grid`` blocks of
    ``threads`` striding over the lanes (full rows: a warp 32 lanes at a
    time, its reading lanes' rows walked word by word); each block's
    (checksum, write count) pair; the grid barrier, so every gather sees
    the epoch-start table; the winners' stores below ``cap``; block 0's
    wrapping sums.  Asserts each listed row's words are visited once."""
    keys, rank, rd, wr, fwd, win = (np.asarray(getattr(plan, f)) for f in (
        "keys", "rank", "is_read", "is_write", "fwd", "win"))
    n, stride = keys.size, grid * threads
    start = f0.copy()
    parts = np.zeros((grid, 2), np.int64)
    lanes = np.arange(n)
    # warp w of block b takes lanes 32 (w * grid + b) + ..., every stride
    block = (lanes // 32) % (stride // 32) % grid
    np.add.at(parts[:, 1], block, wr)
    row = f0.ndim == 2
    if not row:
        vals = np.where(fwd >= 0, _np_fp(keys, fwd),
                        start[slots].astype(np.int64) & M32)
        np.add.at(parts[:, 0], block[rd], vals[rd])
    else:
        words = f0.shape[1] // 4
        seen = np.zeros((n, words), np.int64)
        for base in range(0, n, 32):
            b = block[base]
            chunk = lanes[base:base + 32]
            for rows, u in _warp_walk(chunk[rd[chunk]], words):
                seen[rows, u] += 1
                got = np.where((fwd[rows] >= 0)[:, None],
                               _np_word(_np_fp(keys[rows], fwd[rows]), u),
                               start[slots[rows][:, None],
                                     4 * u[:, None] + np.arange(4)])
                parts[b, 0] += int(got.astype(np.int64).sum())
        np.testing.assert_array_equal(seen, np.repeat(rd[:, None], words, 1))
    out = start.copy()
    st = win & (slots < cap)
    if not row:
        out[slots[st]] = _np_fp(keys[st], rank[st]).astype(np.uint32)
    else:
        stored = np.zeros((n, words), np.int64)
        for base in range(0, n, 32):
            chunk = lanes[base:base + 32]
            for rows, u in _warp_walk(chunk[st[chunk]], words):
                stored[rows, u] += 1
                out[slots[rows][:, None], 4 * u[:, None] + np.arange(4)] = \
                    _np_word(_np_fp(keys[rows], rank[rows]), u)
        np.testing.assert_array_equal(stored, np.repeat(st[:, None], words,
                                                        1))
    return out, int(parts[:, 0].sum()) & M32, int(parts[:, 1].sum()) & M32


def _k3_case(kind, tab=256):
    """(jax plan, port plan, slots, trash) for a model case: ``mixed`` the
    plan inputs above (heavy duplication, the trash slot for invalid
    lanes); ``hot`` one key on 1,500 of 2,048 lanes, its segment over
    every block of every grid; ``forwarded`` keys whose reads all follow
    their first write; ``part4`` the slots of node 0 at ``part_cnt = 4``
    (keys of the other partitions on the trash slot)."""
    if kind == "mixed":
        jp, tp, slots = _plan_inputs(11, tab=tab)
        return jp, tp, slots, tab
    rng = np.random.default_rng(5)
    n = 2048
    rank = np.repeat(1 + np.arange(n // 4, dtype=np.int32), 4)
    if kind == "hot":
        keys = np.where(rng.random(n) < 0.73, 7,
                        rng.integers(0, tab, n)).astype(np.int32)
        w = rng.random(n) < 0.5
    elif kind == "forwarded":
        rank = 1 + np.arange(n, dtype=np.int32)     # a txn a lane
        keys = rng.integers(0, 40, n).astype(np.int32)
        w = rng.random(n) < 0.3
        _, first = np.unique(keys, return_index=True)
        w[first] = True                     # each key's first lane writes
    else:
        keys = rng.integers(0, 4 * tab, n).astype(np.int32)
        w = rng.random(n) < 0.5
    jp = jf.forward_plan_flat(jnp.asarray(keys), jnp.asarray(rank),
                              jnp.asarray(w))
    tp = ForwardPlan(**{f: torch.from_numpy(np.array(getattr(jp, f)))
                        for f in ("keys", "rank", "is_read", "is_write",
                                  "fwd", "win")}, perm=None)
    pk = np.asarray(jp.keys)
    if kind == "part4":
        slots = np.where(pk % 4 == 0, pk // 4, tab)
    else:
        slots = np.where(pk < tab, pk, tab)
    if kind == "forwarded":
        p_rd, p_fwd = np.asarray(jp.is_read), np.asarray(jp.fwd)
        assert p_rd.any() and (p_fwd[p_rd] >= 0).all()
    return jp, tp, slots.astype(np.int32), tab


@pytest.mark.parametrize("kind", ["mixed", "hot", "forwarded", "part4"])
@pytest.mark.parametrize("width", [0, 100, 24, 8, 4, 200])
@pytest.mark.parametrize("grid", [1, 3, 8])
def test_forward_execute_model_matches_plain_and_reference(kind, width,
                                                           grid):
    jp, tp, slots, tab = _k3_case(kind)
    rng = np.random.default_rng(width + grid)
    rows = -(-(tab + 1) // 64) * 64
    if width:
        f0 = rng.integers(0, 256, (rows, width), dtype=np.uint8)
        tf0 = torch.from_numpy(f0.copy())
    else:
        f0 = rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32)
        tf0 = torch.from_numpy(f0.view(np.int32).copy())
    if kind == "hot":
        assert np.bincount(np.asarray(jp.keys)[np.asarray(jp.keys) < tab]
                           ).max() > 3 * 256
    mono = kind != "part4"      # the striped layout's calls take mono=False
    got, cks, wcnt = k3_model(f0, tp, slots, tab, grid)
    pf0, pcks, pw = ty._forward_execute_f0_plain(
        tf0, tp, torch.from_numpy(slots), tab, mono=mono)
    pf0 = pf0.numpy() if width else pf0.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, pf0)
    assert (cks, wcnt) == (int(pcks), int(pw))
    jf0, jcks, jw = jy._forward_execute_f0(jnp.asarray(f0), jp,
                                           jnp.asarray(slots), tab, mono=mono)
    np.testing.assert_array_equal(got[:tab], np.asarray(jf0)[:tab])
    np.testing.assert_array_equal(got[tab:], f0[tab:])   # trash, padding
    assert (cks, wcnt) == (int(jcks), int(jw))
