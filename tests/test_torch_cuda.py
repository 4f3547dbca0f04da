"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: each kernel alone, and whole epochs of the forwarding, OCC,
NOCC, NO_WAIT, WAIT_DIE, TIMESTAMP, MVCC and MAAT paths, of SIMPLE and
QRY_ONLY, of HOT keys, of the ordered index, of TPC-C (the chained
executor and the sweep backends, with K19, K14a, K14c and K14d alone at
small and at path shapes; with the dynamic ORDER index, K14e merge and
probes alone), of PPS (K20 alone, default and > 2^16 spans), and of
transaction repair and DGCC (K13a, K15a, K15b and K16 alone; repair
epochs under the six sweep backends and TPC-C, DGCC epochs on YCSB and
TPC-C), and of the metrics and audit planes (K13b, K15a at wide
positions, K15c and K17 alone and as ``audit_observe``; armed epochs of
OCC, OCC with ``audit_mutate`` and with repair, CALVIN, MVCC, TIMESTAMP
off and on the cadence, DGCC, and TPC-C), and of the partitioned
keyspace and the router (K3 leaving the trash row alone at
``part_cnt = 4``, K21 alone, routed mixed epochs).  K3's one cooperative
launch and K10's shared tables also on their edge inputs (a hot key over
every block, reads only after writes, ragged lane counts; one slot, no
masked lane, INT32_MIN / INT32_MAX orders, the arena, slots against the
hash, each CTA count and the global regime).  K11b's cluster on K11a's
bits, at every cluster size and in both row regimes, at the largest B
the one-block kernel took and at K11a's largest, its counts against
``chip_smoke.peel_trace``, and ``validate_maat`` against the plain
route; K2's one launch with a hot
key across blocks and at N around a block's run and a staged tile.
K13b's one launch at the edges of its layout (rows within and across a
warp, k up to 2^18, P up to 1,024, in both regimes as the library picks
them, and its layout query and short-scratch refusal) and K4b's for
every option (HOT, key_order, the per-txn gate) at one and four draws a
thread, and zipf theta.  K9b's cluster pinned to each size in both row
regimes (the staged one refused where its rows do not fit), at the
largest B the one-block K9b took and with a short scratch refused; K18a
at one txn, at 32,768 txns over 2 shards and on a scratch of garbage.
Marked ``cuda``; without a CUDA device every test skips.

``tests/conftest.py`` imports JAX; where JAX is not installed, run these
without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every result is compared exactly, zipf keys included: kernel and plain
version both take the zipf power as f64 pow rounded to f32 (the off-by-one
allowance of test_torch_sampling.py is for XLA's f32 pow only).
"""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import (PATH_LAUNCHES, differing_leaf, k11_graphs,
                        k11b_layout_top, k11b_one_block_top, mesh_launches,
                        peel_trace, plain_path)
from deneva_tpu_torch.cc import maat
from deneva_tpu_torch.ops import conflict, forward, prng, scatter
from deneva_tpu_torch.storage.index import SortedIndex
from deneva_tpu_torch.workloads import ycsb

pytestmark = pytest.mark.cuda
BIG = 2**31 - 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _lanes(n, n_keys, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(0, n_keys, (n,), generator=g, dtype=torch.int32)
    k[torch.rand(n, generator=g) < 0.05] = BIG
    r = torch.randint(1, 2**31 - 1, (max(n // 3, 1),), generator=g,
                      dtype=torch.int32).repeat_interleave(3)[:n]
    if r.numel() < n:
        r = torch.cat([r, torch.ones(n - r.numel(), dtype=torch.int32)])
    w = (torch.rand(n, generator=g) < 0.5) & (k != BIG)
    return k.to(dev), r.to(dev), w.to(dev)


def test_split_matches_plain(dev):
    for seed in (0, 1, 2**31 - 1, -7):
        key = prng.key_from_seed(seed, dev)
        for num in (2, 3, 300):
            assert torch.equal(prng.split(key, num),
                               prng.split_plain(key, num))


@pytest.mark.parametrize("theta", [0.0, 0.9])
@pytest.mark.parametrize("n", [1, 999, 6554])
def test_generate_matches_plain(dev, theta, n):
    from deneva_tpu_torch.config import Config
    cfg = Config.from_args(["--epoch_batch=8192", "--max_txn_in_flight=8192",
                            "--synth_table_size=1000003",
                            f"--zipf_theta={theta}"])
    wl = ycsb.YCSBWorkload(cfg, device=dev)
    key = prng.key_from_seed(5, dev)
    q, qp = wl.generate(key, n), wl.generate_plain(key, n)
    assert torch.equal(q.is_write, qp.is_write)
    assert torch.equal(q.keys, qp.keys)


@pytest.mark.parametrize("n,n_keys", [(1, 5), (1000, 7), (4097, 100000),
                                      (70001, 300), (200000, 2**31 - 2)])
def test_sort_and_scans_match_plain(dev, n, n_keys):
    k, r, w = _lanes(n, n_keys, dev, seed=n)
    words = forward.sort_lanes(k, r, w)
    assert torch.equal(words, forward.sort_lanes_plain(k, r, w).values)
    got, want = forward.plan_scans(words), forward.plan_scans_plain(words)
    for f in ("keys", "rank", "is_read", "is_write", "fwd", "win"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("kind,n", [("one_key", 655360),
                                    ("all_sentinel", 4097),
                                    ("one_key", 2049), ("two_keys", 2047),
                                    ("main_path", 655360)])
def test_sort_hot_digits_match_plain(dev, kind, n):
    """K1's one-sweep sort where one digit holds every word of a pass (a
    pass that is a copy), where the sentinel key 0x7FFFFFFF fills the
    array, at N off the 2,048-word tile, and at the main path's N."""
    g = torch.Generator().manual_seed(n)
    r = torch.randint(1, 65537, (n,), generator=g, dtype=torch.int32)
    w = torch.rand(n, generator=g) < 0.5
    if kind == "one_key":
        k = torch.full((n,), 12345, dtype=torch.int32)
    elif kind == "all_sentinel":
        k = torch.full((n,), BIG, dtype=torch.int32)
        w[:] = False
    elif kind == "two_keys":
        k = torch.where(torch.rand(n, generator=g) < 0.5, 7, BIG).to(
            torch.int32)
    else:
        k = torch.randint(0, 1 << 24, (n,), generator=g, dtype=torch.int32)
        r = (1 + torch.arange(n // 10, dtype=torch.int32)).repeat_interleave(
            10)
    k, r, w = k.to(dev), r.to(dev), w.to(dev)
    for _ in range(2):      # the second call reuses freed scratch
        words = forward.sort_lanes(k, r, w)
        assert torch.equal(words, forward.sort_lanes_plain(k, r, w).values)


def _plan_equal(words):
    got, want = forward.plan_scans(words), forward.plan_scans_plain(words)
    for f in ("keys", "rank", "is_read", "is_write", "fwd", "win"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("writes", ["first", "last", "none", "every"])
def test_plan_scans_hot_key_across_blocks(dev, writes):
    """K2 with one key over more than three blocks' runs of lanes, its
    writes only in the first block it touches, only in the last, in none,
    and in every one (the fwd and win decided across runs)."""
    n = 200000
    blocks, run, _ = forward.plan_scans_layout(n)
    assert blocks >= 8
    lo, hi = 3 * run + 77, 6 * run + 500          # past three runs' ends
    g = torch.Generator().manual_seed(len(writes))
    k = torch.sort(torch.randint(0, n // 4, (n,), generator=g,
                                 dtype=torch.int32)).values
    k[:lo] = torch.clamp(k[:lo], max=999)
    k[lo:hi] = 1000
    k[hi:] = torch.clamp(k[hi:], min=1001)
    r = torch.randint(1, n, (n,), generator=g, dtype=torch.int32)
    r[lo:hi] = torch.arange(1, hi - lo + 1, dtype=torch.int32)
    w = torch.rand(n, generator=g) < 0.4
    seg = torch.arange(hi - lo)
    w[lo:hi] = {"first": seg < run // 2, "last": seg >= hi - lo - run // 2,
                "none": torch.zeros(hi - lo, dtype=torch.bool),
                "every": torch.rand(hi - lo, generator=g) < 0.2}[writes]
    words = forward.sort_lanes_plain(k.to(dev), r.to(dev), w.to(dev)).values
    assert bool(((words[lo:hi] >> 32) == 1000).all())
    _plan_equal(words)


@pytest.mark.parametrize("n", ["1", "run-1", "run+1", "tile-1", "tile+1",
                               "655360", "multi-tile"])
def test_plan_scans_sizes_match_plain(dev, n):
    """K2 at N = 1, one less and one more than a block's run and than a
    staged tile of 8,192 lanes, the main path's 655,360, and an N whose
    runs span several tiles."""
    size = {"1": 1, "run-1": 1023, "run+1": 1025, "tile-1": 8191,
            "tile+1": 8193, "655360": 655360,
            "multi-tile": 3 * 8192 * forward.plan_scans_layout(1 << 30)[0]
            }[n]
    blocks, run, _ = forward.plan_scans_layout(size)
    if n in ("1", "run-1", "run+1"):
        assert run == 1024 and blocks == (2 if n == "run+1" else 1)
    if n == "multi-tile":
        assert run > 8192
    k, r, w = _lanes(size, max(2, size // 8), dev, seed=size)
    _plan_equal(forward.sort_lanes_plain(k, r, w).values)


@pytest.mark.parametrize("width", [0, 100, 24])
def test_forward_execute_matches_plain(dev, width):
    cap = 5000
    k, r, w = _lanes(30000, cap, dev, seed=width)
    plan = forward.plan_scans(forward.sort_lanes(k, r, w))
    slots = torch.where(plan.keys < cap, plan.keys,
                        torch.full_like(plan.keys, cap))
    rows = -(-(cap + 1) // 64) * 64
    g = torch.Generator().manual_seed(1)
    if width:
        f0 = torch.randint(0, 256, (rows, width), generator=g,
                           dtype=torch.uint8).to(dev)
    else:
        f0 = torch.randint(-2**31, 2**31 - 1, (rows,), generator=g,
                           dtype=torch.int32).to(dev)
    f0p = f0.clone()
    _, cks, wc = ycsb._forward_execute_f0(f0, plan, slots, cap, mono=True)
    _, cksp, wcp = ycsb._forward_execute_f0_plain(f0p, plan, slots, cap,
                                                  mono=True)
    assert torch.equal(f0, f0p)
    assert int(cks) == int(cksp) and int(wc) == int(wcp)


def test_epochs_through_kernels_match_plain_epochs(dev):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    cfg = Config.from_args(["--epoch_batch=1024", "--max_txn_in_flight=1024",
                            "--synth_table_size=65536", "--zipf_theta=0.9",
                            "--sim_full_row=true", "--field_per_tuple=2"])
    wk = ycsb.YCSBWorkload(cfg, device=dev)
    wp = ycsb.YCSBWorkload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 3)
    for nm, kern in all_kernels().items():
        per_epoch = PATH_LAUNCHES["TPU_BATCH"].get(nm, 0)
        assert kern.launches == before[nm] + 3 * per_epoch, nm
    with plain_path(wp):
        sp = ep.run(sp, 3)
    lk, lp = state_leaves(sk), state_leaves(sp)
    for path, t in lk.items():
        assert torch.equal(t, lp[path]), path


def _access_lanes(b, a, dev, seed):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(-2**31, 2**31 - 1, (b, a), generator=g,
                         dtype=torch.int32)
    hot = torch.rand(b, a, generator=g) < 0.5
    keys[hot] = torch.randint(0, 50, (int(hot.sum()),), generator=g,
                              dtype=torch.int32)
    t = {"table_ids": torch.randint(0, 3, (b, a), generator=g,
                                    dtype=torch.int32),
         "keys": keys,
         "is_read": torch.rand(b, a, generator=g) < 0.6,
         "is_write": torch.rand(b, a, generator=g) < 0.5,
         "valid": torch.rand(b, a, generator=g) < 0.9,
         "active": torch.rand(b, generator=g) < 0.8,
         "order_free": torch.rand(b, a, generator=g) < 0.3}
    return {k: v.to(dev) for k, v in t.items()}


@pytest.mark.parametrize("b,a,k,fams,order_free", [
    (1024, 10, 8192, 2, False), (1024, 10, 8192, 1, True),
    (100, 40, 64, 2, True), (3, 1, 8, 1, False)])
def test_build_incidence_matches_plain(dev, b, a, k, fams, order_free):
    t = _access_lanes(b, a, dev, seed=b + a)
    of = t.pop("order_free") if order_free else None
    t.pop("order_free", None)
    views = conflict.VIEWS if order_free else ("u", "w", "r", "pr")
    args = (t["table_ids"], t["keys"], t["is_read"], t["is_write"],
            t["valid"], t["active"], of, k, fams)
    got, b1 = conflict.hashed_incidence(*args, views)
    want, b1p = conflict.hashed_incidence_plain(*args, views)
    assert torch.equal(b1, b1p)
    for f in range(fams):
        for nm in views:
            assert torch.equal(got[f][nm].view(torch.int16),
                               want[f][nm].view(torch.int16)), (f, nm)


@pytest.mark.parametrize("m,n,k,two", [(1024, 1024, 8192, True),
                                       (1024, 1024, 8192, False),
                                       (2048, 2048, 8192, True),
                                       (1000, 333, 8192, True),
                                       (333, 1000, 8192, False),
                                       (100, 70, 64, True), (5, 5, 64, False),
                                       (300, 4100, 64, True)])
def test_overlap_matches_plain(dev, m, n, k, two):
    g = torch.Generator().manual_seed(m + k)

    def inc(rows):
        x = torch.zeros(rows, k)
        x.scatter_add_(1, torch.randint(0, k, (rows, 10), generator=g),
                       torch.ones(rows, 10))
        return x.to(torch.bfloat16).to(dev)
    ins = [inc(m), inc(n)] + ([inc(m), inc(n)] if two else [])
    got = conflict.overlap(*ins)
    assert torch.equal(got, conflict.overlap_plain(*ins))
    assert 0 < int(got.sum()) < m * n


@pytest.mark.parametrize("kind", ["alias", "dense_row", "count_256",
                                  "empty_rows"])
@pytest.mark.parametrize("m,k,two", [(64, 8, True), (64, 8, False),
                                     (2048, 8192, True), (77, 8192, False)])
def test_overlap_edge_rows_match_plain(dev, kind, m, k, two):
    """K7 on the rows its bitmaps find hard: A aliased to B, a row whose
    every bucket is positive, counts of 256 (the largest K5+K6 writes),
    and rows with no access."""
    g = torch.Generator().manual_seed(m + k + len(kind))

    def inc(rows):
        x = torch.zeros(rows, k)
        x.scatter_add_(1, torch.randint(0, k, (rows, 3), generator=g),
                       torch.ones(rows, 3))
        x[torch.rand(rows, generator=g) < 0.3] = 0
        if kind == "dense_row":
            x[rows // 2] = 1
        if kind == "count_256":
            x[x > 0] = 256
        return x.to(torch.bfloat16).to(dev)
    a, b = inc(m), inc(m + 5)
    a2, b2 = (inc(m), inc(m + 5)) if two else (None, None)
    if kind == "alias":
        b = a
        b2 = a2
    if kind == "empty_rows":
        a[: m // 2] = 0
    got = conflict.overlap(a, b, a2, b2)
    assert torch.equal(got, conflict.overlap_plain(a, b, a2, b2))
    if kind == "dense_row" and not two:
        assert bool(got[m // 2, (b > 0).any(1)].all())


@pytest.mark.parametrize("b", [16, 100, 1024, 2048])
@pytest.mark.parametrize("rounds", [1, 3, 24])
def test_first_fit_matches_plain(dev, b, rounds):
    g = torch.Generator().manual_seed(b * rounds)
    c = torch.rand(b, b, generator=g) < min(0.2, 20.0 / b)
    c = (c | c.T).to(dev)
    rank = torch.randint(0, max(b // 3, 1), (b,), generator=g,
                         dtype=torch.int32).to(dev)
    active = (torch.rand(b, generator=g) < 0.85).to(dev)
    got = conflict.first_fit(c, rank, active, rounds)
    want = conflict.first_fit_plain(c, rank, active, rounds)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _first_fit_size(size):
    """K8's cluster edges: the largest B one CTA holds (as the kernel
    library lays it out) and one either side, the cluster at 2,048 and
    rows from L2 at 4,096."""
    if isinstance(size, int):
        return size
    top = max(b for b in range(128, 4096, 128)
              if conflict.first_fit_layout(b)[:2] == (1, True))
    assert conflict.first_fit_layout(top + 1)[0] > 1
    return top + {"top-1": -1, "top": 0, "top+1": 1}[size]


@pytest.mark.parametrize("size", ["top-1", "top", "top+1", 2048, 4096])
@pytest.mark.parametrize("rounds", [3, 24])
def test_first_fit_cluster_sizes_match_plain(dev, size, rounds):
    b = _first_fit_size(size)
    g = torch.Generator().manual_seed(b + rounds)
    c = torch.rand(b, b, generator=g) < 10.0 / b
    c = (c | c.T).to(dev)
    rank = torch.randint(0, b, (b,), generator=g, dtype=torch.int32).to(dev)
    active = (torch.rand(b, generator=g) < 0.9).to(dev)
    got = conflict.first_fit(c, rank, active, rounds)
    want = conflict.first_fit_plain(c, rank, active, rounds)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_first_fit_refuses_a_short_scratch(dev):
    """K8 refuses a scratch one word short of what its layout reports,
    before any launch."""
    from deneva_tpu_torch import kernels
    for b in (1024, 4096):
        words = conflict.first_fit_layout(b)[2]
        c = torch.zeros(b, b, dtype=torch.bool, device=dev)
        rank = torch.zeros(b, dtype=torch.int32, device=dev)
        act = torch.ones(b, dtype=torch.bool, device=dev)
        bits = torch.empty(words - 1, dtype=torch.int32, device=dev)
        with pytest.raises(RuntimeError, match="dt_first_fit"):
            conflict.K8_FIRST_FIT.launch(
                kernels.ptr(c), kernels.ptr(rank), kernels.ptr(act), b, 24,
                kernels.ptr(bits), words - 1, kernels.ptr(act),
                kernels.ptr(act), kernels.ptr(act), kernels.stream(act))


@pytest.mark.parametrize("b", [1024, 2048, 4096])
@pytest.mark.parametrize("kind", ["chain", "dense", "none_active"])
def test_first_fit_structured_match_plain(dev, b, kind):
    """A chain (one txn settles a round: all 24 rounds run, and 3 leave
    most undecided), every pair in conflict, and no active txn."""
    i = torch.arange(b)
    if kind == "chain":
        c = (i[:, None] - i[None, :]).abs() == 1
    else:
        c = i[:, None] != i[None, :]
    rank = i.to(torch.int32).to(dev)
    active = torch.full((b,), kind != "none_active", dtype=torch.bool,
                        device=dev)
    c = c.to(dev)
    for rounds in (3, 24):
        got = conflict.first_fit(c, rank, active, rounds)
        want = conflict.first_fit_plain(c, rank, active, rounds)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        if kind == "chain":
            assert int(got[2].sum()) > 0
        if kind == "dense":
            assert int(got[0].sum()) == 1 and int(got[2].sum()) == 0
        if kind == "none_active":
            assert not bool(torch.cat(got).any())


@pytest.mark.parametrize("n,n_slots,capacity", [
    (10240, 4000, 1 << 24), (200, 30, 30), (4096, 500, 600), (1, 1, 1),
    (100000, 1000, 1 << 20)])
def test_last_writer_matches_plain(dev, n, n_slots, capacity):
    g = torch.Generator().manual_seed(n)
    slots = torch.randint(0, n_slots, (n,), generator=g, dtype=torch.int32)
    slots[torch.rand(n, generator=g) < 0.05] = capacity
    order = torch.randint(0, 6, (n,), generator=g, dtype=torch.int32)
    order[torch.rand(n, generator=g) < 0.1] = -2**31
    mask = torch.rand(n, generator=g) < 0.7
    s, o, m = slots.to(dev), order.to(dev), mask.to(dev)
    assert torch.equal(scatter.last_writer(s, o, m, capacity),
                       scatter.last_writer_plain(s, o, m, capacity))


def _k10_edge(kind, n, dev):
    """(slots, order, mask, capacity) of a K10 edge case."""
    g = torch.Generator().manual_seed(n)
    cap = 1 << 20
    slots = torch.randint(0, max(n // 4, 1), (n,), generator=g,
                          dtype=torch.int32)
    order = torch.randint(0, 6, (n,), generator=g, dtype=torch.int32)
    mask = torch.rand(n, generator=g) < 0.5
    if kind == "one_slot":
        slots[:] = 3
        mask[:] = True
    elif kind == "no_mask":
        mask[:] = False
    elif kind == "extremes":
        order = torch.where(torch.rand(n, generator=g) < 0.5, -2**31,
                            2**31 - 1).to(torch.int32)
    elif kind == "arena":
        cap = max(n // 8, 1)
        slots = torch.randint(0, cap + 1, (n,), generator=g,
                              dtype=torch.int32)
    if kind == "misaligned":    # views one element in: the lane-wise walk
        return (slots.to(dev)[1:], order.to(dev)[1:], mask.to(dev)[1:],
                cap)
    return slots.to(dev), order.to(dev), mask.to(dev), cap


@pytest.mark.parametrize("kind,n", [
    ("random", 1023), ("random", 1025), ("random", 20480),
    ("random", 30720), ("one_slot", 20480), ("no_mask", 10240),
    ("extremes", 8193), ("arena", 4097), ("arena", 131072), ("random", 1),
    ("misaligned", 20481)])
@pytest.mark.parametrize("ctas", [0, 1, 2, 8, 32, -1])
def test_last_writer_edges_match_plain(dev, kind, n, ctas):
    """K10 at the library's layout, at 1, 2, 8 and 32 CTAs and in the
    global-table regime, on every lane one slot, no masked lane, N off
    the block width, orders at INT32_MIN / INT32_MAX, N >= capacity and
    inputs off the 16-byte alignment of the vector loads."""
    s, o, m, cap = _k10_edge(kind, n, dev)
    want = scatter.last_writer_plain(s, o, m, cap)
    before = scatter.K10_LAST_WRITER.launches
    got = scatter._last_writer(s, o, m, ctas) if ctas else \
        scatter.last_writer(s, o, m, cap)
    assert scatter.K10_LAST_WRITER.launches == before + 1
    assert torch.equal(got, want)


def test_last_writer_spills_exactly(dev):
    """Slots chosen against the hash, every one owned by one CTA of the
    library's layout, past half its table: it splits them over
    sub-rounds and the flags stay exact."""
    n = 30720
    c, t, _ = scatter.last_writer_layout(n, dev)
    pool = np.arange(n * c * 2, dtype=np.int64)
    owner = (pool * 2654435761 & 0xFFFFFFFF) >> (32 - (c.bit_length() - 1))
    s = torch.from_numpy(pool[owner == c - 1][:n].astype(np.int32)).to(dev)
    assert s.numel() == n and n > t // 2
    g = torch.Generator().manual_seed(5)
    o = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                      dtype=torch.int32).to(dev)
    m = torch.ones(n, dtype=torch.bool, device=dev)
    assert torch.equal(scatter.last_writer(s, o, m, 1 << 19),
                       scatter.last_writer_plain(s, o, m, 1 << 19))


def test_last_writer_layout_regimes(dev):
    """Every path's N (up to TPC-C's 30,720 stock lanes) takes the shared
    regime, with no scratch, up to 32,768 lanes; past them (the arena's
    65,536 and 131,072) the global table; a CTA count not a power of two
    is refused."""
    for n in (1, 10240, 20480, 30720, 32768):
        c, t, g = scatter.last_writer_layout(n, dev)
        assert g == 0 and c * t >= 2 * n and t <= 8192
    for n in (32769, 65536, 131072):
        assert scatter.last_writer_layout(n, dev)[2] >= 2 * n
    with pytest.raises(ValueError):
        scatter.last_writer_layout(1000, dev, 3)


def _k3_edge(kind, dev):
    """(plan, slots, cap) of a K3 edge case."""
    cap = 5000
    g = torch.Generator().manual_seed(7)
    if kind == "hot":        # one key on 2/3 of 300,000 lanes
        k, r, w = _lanes(300000, cap, dev, seed=3)
        k = torch.where(torch.rand(300000, generator=g).to(dev) < 0.67,
                        torch.full_like(k, 17), k)
    elif kind == "forwarded":    # every read after its key's first write
        n = 40000
        k = torch.randint(0, 300, (n,), generator=g, dtype=torch.int32)
        r = 1 + torch.arange(n, dtype=torch.int32)
        w = torch.rand(n, generator=g) < 0.3
        first = torch.full((300,), n, dtype=torch.int64).scatter_reduce_(
            0, k.long(), torch.arange(n), "amin")
        w[first[first < n]] = True
        k, r, w = k.to(dev), r.to(dev), w.to(dev)
    else:                    # ragged lane counts
        n = {"one": 1, "warp_off": 33, "block_off": 1025}[kind]
        k, r, w = _lanes(n, cap, dev, seed=n)
    plan = forward.plan_scans(forward.sort_lanes(k, r, w))
    slots = torch.where(plan.keys < cap, plan.keys,
                        torch.full_like(plan.keys, cap))
    if kind == "forwarded":
        rd = plan.is_read
        assert bool(rd.any()) and bool((plan.fwd[rd] >= 0).all())
    return plan, slots, cap


@pytest.mark.parametrize("kind", ["hot", "forwarded", "one", "warp_off",
                                  "block_off"])
@pytest.mark.parametrize("width", [0, 100, 8, 200])
def test_forward_execute_edges_match_plain(dev, kind, width):
    """K3 in one cooperative launch on a hot key whose segment spans
    every block, keys read only after their first write, and lane counts
    off the warp and the block; full rows narrower and wider than a warp
    of words."""
    plan, slots, cap = _k3_edge(kind, dev)
    rows = -(-(cap + 1) // 64) * 64
    g = torch.Generator().manual_seed(width)
    if width:
        f0 = torch.randint(0, 256, (rows, width), generator=g,
                           dtype=torch.uint8).to(dev)
    else:
        f0 = torch.randint(-2**31, 2**31 - 1, (rows,), generator=g,
                           dtype=torch.int32).to(dev)
    f0p = f0.clone()
    _, cks, wc = ycsb._forward_execute_f0(f0, plan, slots, cap, mono=True)
    _, cksp, wcp = ycsb._forward_execute_f0_plain(f0p, plan, slots, cap,
                                                  mono=True)
    assert torch.equal(f0, f0p)
    assert int(cks) == int(cksp) and int(wc) == int(wcp)


def test_forward_execute_refuses_a_short_scratch(dev):
    """The launch checks its scratch: fewer than three int64 words (the
    totals and one block's pair) are refused with an error, not run."""
    from deneva_tpu_torch import kernels
    plan, slots, cap = _k3_edge("block_off", dev)
    f0 = torch.zeros(cap + 64, dtype=torch.int32, device=dev)
    acc = torch.zeros(2, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError):
        ycsb.K3_EXEC.launch(
            kernels.ptr(f0), 0, kernels.ptr(plan.keys),
            kernels.ptr(plan.rank), kernels.ptr(plan.is_read),
            kernels.ptr(plan.is_write), kernels.ptr(plan.fwd),
            kernels.ptr(plan.win), kernels.ptr(slots), plan.keys.numel(),
            cap, kernels.ptr(acc), 2, kernels.stream(f0))


@pytest.mark.parametrize("alg,full", [("OCC", False), ("OCC", True),
                                      ("NOCC", False)])
def test_sweep_epochs_through_kernels_match_plain_epochs(dev, alg, full):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    cfg = Config.from_args([
        f"--cc_alg={alg}", "--epoch_batch=1024", "--max_txn_in_flight=4096",
        "--synth_table_size=65536", "--zipf_theta=0.9",
        "--conflict_buckets=8192", f"--sim_full_row={full}",
        "--field_per_tuple=2"])
    wk = ycsb.YCSBWorkload(cfg, device=dev)
    wp = ycsb.YCSBWorkload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 3)
    for nm, kern in all_kernels().items():
        per_epoch = PATH_LAUNCHES[alg].get(nm, 0)
        assert kern.launches == before[nm] + 3 * per_epoch, nm
    with plain_path(wp):
        sp = ep.run(sp, 3)
    lk, lp = state_leaves(sk), state_leaves(sp)
    cap = cfg.synth_table_size
    for path, t in lk.items():
        if path.startswith("db/") and t.ndim >= 1 and t.shape[0] > cap:
            # the trash row takes losers' writes in an unspecified order
            assert torch.equal(t[:cap], lp[path][:cap]), path
        else:
            assert torch.equal(t, lp[path]), path
    if alg == "OCC":
        assert int(sk.stats["total_txn_abort_cnt"]) > 0


def test_wrappers_refuse_bad_inputs(dev):
    k, r, w = _lanes(100, 10, dev)
    with pytest.raises(TypeError):
        forward.sort_lanes(k.long(), r, w)
    with pytest.raises(ValueError):
        forward.sort_lanes(k, r.cpu(), w)
    with pytest.raises(ValueError):
        forward.plan_scans(torch.zeros(10, 2, dtype=torch.int64,
                                       device=dev)[:, 0])
    inc = torch.zeros(8, 12, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        conflict.overlap(inc, inc)          # K not a multiple of 8
    with pytest.raises(TypeError):
        scatter.last_writer(k.long(), r, w, 10)
    # a size refused on the card surfaces through the launch status
    from deneva_tpu_torch.config import Config
    wl = ycsb.YCSBWorkload(Config.from_args(
        ["--synth_table_size=4096", "--req_per_query=65",
         "--max_accesses=65", "--key_order=true"]), device=dev)
    with pytest.raises(RuntimeError):       # K4b sorts rows of <= 64 keys
        wl.generate(prng.key_from_seed(3, dev), 4)


def _to_batch(b, a, dev, seed, order_free):
    from deneva_tpu_torch.cc import AccessBatch
    t = _access_lanes(b, a, dev, seed)
    g = torch.Generator().manual_seed(seed + 1)
    return AccessBatch(
        table_ids=t["table_ids"], keys=t["keys"], is_read=t["is_read"],
        is_write=t["is_write"], valid=t["valid"],
        ts=torch.randint(1, 1000, (b,), generator=g,
                         dtype=torch.int32).to(dev),
        rank=torch.arange(b, dtype=torch.int32, device=dev),
        active=t["active"],
        order_free=t["order_free"] if order_free else None)


def _to_state(k, h, dev, seed):
    from deneva_tpu_torch.cc.timestamp import MVCCState, TOState
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randint(0, 1000, shape, generator=g,
                             dtype=torch.int32).to(dev)
    if not h:
        return TOState(rts=r(k), wts=r(k))
    return MVCCState(rts=r(k), wts=r(k), his=r(k, h),
                     pos=torch.randint(0, h, (k,), generator=g,
                                       dtype=torch.int32).to(dev),
                     scratch=torch.zeros(k, dtype=torch.int32, device=dev))


def _cfg(k):
    from deneva_tpu_torch.config import Config
    return Config(watermark_buckets=k)


@pytest.mark.parametrize("h,order_free", [(0, False), (4, False), (0, True),
                                          (4, True), (2, False)])
@pytest.mark.parametrize("b,a,k", [(2048, 10, 1 << 20), (300, 40, 64)])
def test_watermark_check_matches_plain(dev, b, a, k, h, order_free):
    from deneva_tpu_torch.cc import timestamp
    batch = _to_batch(b, a, dev, b + h, order_free)
    state = _to_state(k, h, dev, a)
    got = timestamp._watermark_check(_cfg(k), state, batch, h > 0)
    want = timestamp._watermark_check_plain(_cfg(k), state, batch, h > 0)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert 0 < int(got[0].sum()) < b


@pytest.mark.parametrize("h,order_free", [(0, False), (4, False), (4, True),
                                          (3, False)])
@pytest.mark.parametrize("b,a,k", [(2048, 10, 1 << 20), (300, 40, 64)])
def test_commit_watermarks_matches_plain(dev, b, a, k, h, order_free):
    import dataclasses

    from deneva_tpu_torch.cc import timestamp
    batch = _to_batch(b, a, dev, b + 7 * h, order_free)
    state = _to_state(k, h, dev, a + 1)
    commit = batch.active & (torch.rand(b, device=dev) < 0.6)
    ref = dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)})
    want = timestamp._commit_watermarks_plain(_cfg(k), ref, batch, commit)
    got = timestamp._commit_watermarks(_cfg(k), state, batch, commit)
    for f in ("rts", "wts", "his", "pos"):
        if hasattr(want, f):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    if h:
        assert not got.scratch.any()


@pytest.mark.parametrize("width", [0, 100, 24])
def test_version_read_matches_plain(dev, width):
    from deneva_tpu_torch.storage.table import VersionRing
    g = torch.Generator().manual_seed(width)
    cap, h, n, a = 5000, 4, 700, 10
    rows = -(-(cap + 1) // 64) * 64
    ring = VersionRing(torch.randint(0, 400, (rows * h,), generator=g,
                                     dtype=torch.int32).to(dev), h)
    if width:
        f0 = torch.randint(0, 256, (rows, width), generator=g,
                           dtype=torch.uint8).to(dev)
    else:
        f0 = torch.randint(-2**31, 2**31 - 1, (rows,), generator=g,
                           dtype=torch.int32).to(dev)
    keys = torch.randint(0, cap, (n, a), generator=g,
                         dtype=torch.int32).to(dev)
    rmask = (torch.rand(n, a, generator=g) < 0.6).to(dev)
    ver_ts = torch.randint(0, 500, (n,), generator=g, dtype=torch.int32)
    ver_ts[:50] = 2**31 - 1
    ver_ts = ver_ts.to(dev)
    got = ycsb._versioned_read_f0(f0, ring, keys, keys, rmask, ver_ts, cap)
    want = ycsb._versioned_read_f0_plain(f0, ring, keys, keys, rmask,
                                         ver_ts, cap)
    assert int(got) == int(want)


def test_version_push_matches_plain(dev):
    from deneva_tpu_torch.storage.table import VersionRing
    g = torch.Generator().manual_seed(4)
    rows, h, n = 4096, 4, 3000
    base = torch.randint(0, 5, (rows * h,), generator=g, dtype=torch.int32)
    slots = torch.randperm(rows - 1, generator=g)[:n].to(torch.int32)
    wts = torch.randint(1, 10**6, (n,), generator=g, dtype=torch.int32)
    mask = torch.rand(n, generator=g) < 0.7
    got = VersionRing(base.clone().to(dev), h).push(
        slots.to(dev), wts.to(dev), mask.to(dev))
    want = VersionRing(base.clone().to(dev), h).push_plain(
        slots.to(dev), wts.to(dev), mask.to(dev))
    assert torch.equal(got.wts, want.wts)


@pytest.mark.parametrize("alg,flags", [
    ("NO_WAIT", []), ("WAIT_DIE", ["--isolation_level=READ_COMMITTED"]),
    ("NO_WAIT", ["--isolation_level=NOLOCK"]), ("TIMESTAMP", []),
    ("MVCC", []), ("MVCC", ["--sim_full_row=true"]), ("CALVIN", [])])
def test_lock_and_to_epochs_through_kernels_match_plain_epochs(dev, alg,
                                                                flags):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    cfg = Config.from_args([
        f"--cc_alg={alg}", "--epoch_batch=2048", "--max_txn_in_flight=8192",
        "--synth_table_size=65536", "--zipf_theta=0.9",
        "--conflict_buckets=8192", "--watermark_buckets=4096",
        "--field_per_tuple=2"] + flags)
    wk = ycsb.YCSBWorkload(cfg, device=dev)
    wp = ycsb.YCSBWorkload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 4)
    per_path = dict(PATH_LAUNCHES[alg])
    if flags == ["--isolation_level=READ_COMMITTED"]:
        per_path["K7_overlap"] = 2          # write-write and read-write
    if flags == ["--isolation_level=NOLOCK"]:
        per_path = PATH_LAUNCHES["NOCC"]
    for nm, kern in all_kernels().items():
        assert kern.launches == before[nm] + 4 * per_path.get(nm, 0), nm
    with plain_path(wp):
        sp = ep.run(sp, 4)
    lk, lp = state_leaves(sk), state_leaves(sp)
    cap = cfg.synth_table_size
    for path, t in lk.items():
        if path.startswith("db/MAIN_TABLE/") and t.ndim >= 1:
            assert torch.equal(t[:cap], lp[path][:cap]), path
            assert torch.equal(t[cap + 1:], lp[path][cap + 1:]), path
        else:
            assert torch.equal(t, lp[path]), path


# -- slice 4: K9a, K9b, K11a, K11b, K14b, K4b's options ------------------------

def _digraph(b, seed, density, cycles=True):
    """A seeded digraph without self-loops; ``cycles=False`` keeps only
    i -> j for i < j."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(b, b, generator=g) < density
    p.fill_diagonal_(False)
    if not cycles:
        p = torch.triu(p)
    rank = torch.randint(0, max(b // 4, 1), (b,), generator=g,
                         dtype=torch.int32)
    active = torch.rand(b, generator=g) < 0.85
    return p, rank, active


@pytest.mark.parametrize("b", [16, 100, 1024, 2048])
@pytest.mark.parametrize("max_level", [0, 3, 24])
def test_wavefront_levels_matches_plain(dev, b, max_level):
    # p is not symmetric: the kernel ORs in its transpose
    p, rank, active = _digraph(b, b + max_level, min(0.3, 8.0 / b))
    p, rank, active = p.to(dev), rank.to(dev), active.to(dev)
    got = conflict.wavefront(p, rank, active, max_level)
    want = conflict.wavefront_plain(p, rank, active, max_level)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b", [16, 100, 1024, 2048])
@pytest.mark.parametrize("rounds", [0, 1, 3, 24])
@pytest.mark.parametrize("cycles", [False, True])
def test_precedence_levels_matches_plain(dev, b, rounds, cycles):
    p, _, active = _digraph(b, b * 7 + rounds, min(0.2, 3.0 / b), cycles)
    p, active = p.to(dev), active.to(dev)
    got = conflict.precedence_levels(p, active, rounds)
    want = conflict.precedence_levels_plain(p, active, rounds)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _sparse_digraph(b, dev, seed, per=3):
    """``per`` random edges a txn (cycles and self-loops included), made
    on the card; 85% of the txns active."""
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, b, (b * per,), generator=g).to(dev)
    dst = torch.randint(0, b, (b * per,), generator=g).to(dev)
    p = torch.zeros(b, b, dtype=torch.bool, device=dev)
    p[src, dst] = True
    active = (torch.rand(b, generator=g) < 0.85).to(dev)
    return p, active


# K9b's staged regime takes these (B, CTAs) and refuses the rest: the
# rows of a CTA's txns must fit shared memory
K9B_STAGED = {(100, c) for c in (1, 2, 4, 8, 16)} | \
    {(2048, c) for c in (4, 8, 16)}


@pytest.mark.parametrize("b", [100, 2048, 8192])
@pytest.mark.parametrize("regime", [0, 1])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
def test_precedence_levels_every_layout(dev, b, regime, ctas):
    """K9b pinned to each cluster size in each regime: exact where the
    layout fits, refused where the staged rows do not."""
    p, active = _sparse_digraph(b, dev, b + 17 * ctas + regime)
    if regime == 0 and (b, ctas) not in K9B_STAGED:
        with pytest.raises(ValueError):
            conflict.precedence_levels(p, active, 24, ctas, regime)
        return
    assert conflict.precedence_levels_layout(b, ctas, regime) == (
        ctas, regime == 0, 0 if regime == 0 else b * -(-b // 32))
    for rounds in (0, 1, 3, 24):
        got = conflict.precedence_levels(p, active, rounds, ctas, regime)
        want = conflict.precedence_levels_plain(p, active, rounds)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("regime", [-1, 1])
def test_precedence_levels_at_the_parents_largest_b(dev, regime):
    """B = 24,824, the largest B the one-block K9b took ((2 W + 2 B) 4
    bytes of sets in 200 KB), in the layout the library picks (L2, 16
    CTAs) and pinned to L2."""
    b = 24824
    p, active = _sparse_digraph(b, dev, 5, per=2)
    assert conflict.precedence_levels_layout(b, 0, regime)[:2] == (16, False)
    got = conflict.precedence_levels(p, active, 24, 0, regime)
    want = conflict.precedence_levels_plain(p, active, 24)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_precedence_levels_refuses_short_scratch(dev):
    """The L2 regime's rows need B W words of scratch: a shorter one is
    refused before any launch."""
    import ctypes
    from deneva_tpu_torch import kernels
    b = 8192
    p, active = _sparse_digraph(b, dev, 3)
    words = conflict.precedence_levels_layout(b)[2]
    assert words == b * (b // 32)
    bits = torch.empty(words, dtype=torch.int32, device=dev)
    lv = torch.empty(b, dtype=torch.int32, device=dev)
    un = torch.empty(b, dtype=torch.bool, device=dev)
    before = conflict.K9B_PRECEDENCE.launches
    with pytest.raises(RuntimeError, match="dt_precedence_levels"):
        conflict.K9B_PRECEDENCE.launch(
            kernels.ptr(p), kernels.ptr(active), b, 24, 0, -1,
            kernels.ptr(bits), ctypes.c_longlong(words - 1), kernels.ptr(lv),
            kernels.ptr(un), None, kernels.stream(p))
    assert conflict.K9B_PRECEDENCE.launches == before
    with pytest.raises(ValueError):
        conflict.precedence_levels(p, active, 24, 3)


@pytest.mark.parametrize("b", [16, 100, 1024, 2048])
@pytest.mark.parametrize("density", [0.5, 3.0])
@pytest.mark.parametrize("gate_on", [False, True])
def test_maat_closure_and_peel_match_plain(dev, b, density, gate_on):
    p, rank, live = _digraph(b, b + int(density), min(0.5, density / b))
    p, rank, live = p.to(dev), rank.to(dev), live.to(dev)
    gate = torch.zeros(b, dtype=torch.bool, device=dev)
    gate[b // 2] = gate_on
    bits = maat.reach_scratch(b, dev)
    sr, anc = maat.reach_stats(p, live, gate, bits=bits)
    srp, ancp = maat.reach_stats_plain(p, live, gate)
    assert torch.equal(sr, srp) and torch.equal(anc, ancp)
    for rounds in (1, 24):
        got = maat.peel(p, live, sr, rank, rounds, 16, gate, bits=bits)
        want = maat.peel_plain(p, live, sr, rank, rounds, 16, gate)
        assert torch.equal(got, want)


@pytest.mark.parametrize("b", [16, 100, 1024, 2048, 8192])
@pytest.mark.parametrize("graph", ["ring", "dag", "cycles23", "chain",
                                   "sparse_live", "empty_live", "gate_off"])
@pytest.mark.parametrize("counts", [False, True])
def test_maat_reach_structured_matches_plain(dev, b, graph, counts):
    """K11a at each residual group size that fits B against
    ``reach_stats_plain``: one strongly connected ring with chords, a DAG
    deeper than ``sweep_rounds``, disjoint 2- and 3-cycles, a chain of B
    txns, sparse and empty ``live``, the gate off."""
    p, live, gate = (t.to(dev) for t in k11_graphs(b)[graph])
    srp, ancp = maat.reach_stats_plain(p, live, gate, counts)
    for group in (32, 16):
        if group > maat.reach_group(b):
            continue
        levels = torch.full((-(-b // group),), -1, dtype=torch.int32,
                            device=dev)
        stats = torch.full((4,), -2, dtype=torch.int32, device=dev)
        sr, anc = maat.reach_stats(p, live, gate, counts, group=group,
                                   levels=levels, stats=stats)
        assert torch.equal(sr, srp), group
        if counts:
            assert torch.equal(anc, ancp), group
        else:
            assert anc is None
        assert bool((levels >= 0).all()), group
        on = bool(gate.any())
        if graph == "ring" and on:
            # one strongly connected set: no residual search
            assert stats[1:3].tolist() == [b, 0] and not levels.any()
        if graph == "chain" and on:
            # no cycle: every txn a residual source, in index order;
            # group g's first source reaches the chain's end
            assert stats[1:3].tolist() == [0, b]
            first = torch.arange(0, b, group, device=dev)
            assert torch.equal(levels, (b - first).to(torch.int32))


def test_maat_reach_picks_the_largest_set(dev):
    """Two strongly connected sets (a ring of 3/4 of the txns and one of
    the rest): the candidate on the larger one is chosen, and the other
    ring runs as residual sources."""
    b = 1024
    p = torch.zeros(b, b, dtype=torch.bool)
    big = 3 * b // 4
    i = torch.arange(big)
    p[i, (i + 1) % big] = True
    j = torch.arange(big, b)
    p[j, big + (j - big + 1) % (b - big)] = True
    p[big - 1, big] = True               # the big ring reaches the small
    p, live = p.to(dev), torch.ones(b, dtype=torch.bool, device=dev)
    gate = live.clone()
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    sr, anc = maat.reach_stats(p, live, gate, stats=stats)
    srp, ancp = maat.reach_stats_plain(p, live, gate)
    assert torch.equal(sr, srp) and torch.equal(anc, ancp)
    assert stats[1:3].tolist() == [big, b - big]


def test_maat_reach_refuses_a_short_scratch(dev):
    """K11a refuses a scratch one word short of its packed rows, columns
    and candidates, and a group size it has no kernel for, before any
    launch."""
    from deneva_tpu_torch import kernels
    b = 100
    words = -(-b // 32)
    need = 2 * b * words + 2 * maat.REACH_PIVOTS * words \
        + 4 * maat.REACH_PIVOTS
    p = torch.zeros(b, b, dtype=torch.bool, device=dev)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    for length, group in ((need - 1, 32), (need, 8)):
        scratch = torch.empty(length, dtype=torch.int32, device=dev)
        with pytest.raises(RuntimeError, match="dt_maat_reach"):
            maat.K11A_REACH.launch(
                kernels.ptr(p), kernels.ptr(live), kernels.ptr(live), b,
                group, 1, kernels.ptr(scratch), length, kernels.ptr(out),
                None, None, None, kernels.stream(live))


_GRAPHS: dict = {}


def _peel_inputs(dev, b, graph):
    """A structured graph of `k11_graphs` (cached by B) with tied ranks
    and its cycle members as K11a's plain side finds them: (p, live0,
    on_cycle0, rank, gate) on the card."""
    if b not in _GRAPHS:
        _GRAPHS[b] = k11_graphs(b)
    p, live, gate = (t.to(dev) for t in _GRAPHS[b][graph])
    rank = ((torch.arange(b, dtype=torch.int32) * 7919) % max(b // 8, 1)
            ).to(dev)
    oc, _ = maat.reach_stats_plain(p, live, gate, False)
    return p, live, oc, rank, gate


def _peel_counts(args, rounds, peel_rounds):
    tr = peel_trace(*args[:4], rounds, peel_rounds, args[4])
    return [sum(1 for r in tr if r["candidates"]), sum(r["x"] for r in tr),
            sum(r["victims"] for r in tr)]


@pytest.mark.parametrize("b", [16, 100, 1024, 2048, 8192])
@pytest.mark.parametrize("graph", ["ring", "dag", "cycles23", "chain",
                                   "sparse_live", "empty_live", "gate_off"])
@pytest.mark.parametrize("rounds,peel_rounds", [(0, 1), (1, 1), (24, 16),
                                                (24, 0), (1, 16), (0, 16)])
def test_maat_peel_matches_plain(dev, b, graph, rounds, peel_rounds):
    """K11b's cluster against ``peel_plain`` on the bits of K11a's call
    over live0 (the handoff of ``validate_maat``), tied ranks; its counts
    (peel rounds with candidates, sweep exchanges, victims, CTAs)
    against `peel_trace`'s.  B = 8,192 reads the rows from L2."""
    p, live, oc, rank, gate = args = _peel_inputs(dev, b, graph)
    want = maat.peel_plain(p, live, oc, rank, rounds, peel_rounds, gate)
    bits = maat.reach_scratch(b, dev)
    sr, _ = maat.reach_stats(p, live, gate, False, bits=bits)
    assert torch.equal(sr, oc)
    stats = torch.full((4,), -1, dtype=torch.int32, device=dev)
    got = maat._peel(p, live, oc, rank, rounds, peel_rounds, gate,
                     bits=bits, stats=stats)
    assert torch.equal(got, want)
    assert torch.equal(maat.peel(p, live, oc, rank, rounds, peel_rounds,
                                 gate, bits=bits), want)
    if bool(gate.any()):
        assert stats[:3].tolist() == _peel_counts(args, rounds, peel_rounds)
        assert int(stats[3]) == maat.peel_layout(b)[0]
    if b == 8192:
        assert not maat.peel_layout(b)[1]


@pytest.mark.parametrize("b", [1024, 2048, 8192])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("density", [3.0, 40.0])
def test_maat_peel_cluster_sizes_match_plain(dev, b, ctas, density):
    """K11b at each cluster size (shared-memory rows where a CTA's share
    fits, else L2) on random digraphs with tied ranks."""
    p, rank, live = _digraph(b, b + ctas, min(0.5, density / b))
    p, rank, live = p.to(dev), rank.to(dev), live.to(dev)
    bits = maat.reach_scratch(b, dev)
    oc, _ = maat.reach_stats(p, live, live, bits=bits)
    want = maat.peel_plain(p, live, oc, rank, 24, 16, live)
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    got = maat._peel(p, live, oc, rank, 24, 16, live, bits=bits,
                     stats=stats, max_ctas=ctas)
    assert torch.equal(got, want)
    c, shared, _ = maat.peel_layout(b, ctas)
    assert int(stats[3]) == c <= ctas
    assert stats[:3].tolist() == _peel_counts((p, live, oc, rank, live),
                                              24, 16)


def test_maat_peel_layout_regimes(dev):
    """The library's clusters: one CTA where the rows are few, 8 CTAs of
    shared-memory rows at B = 2,048, 16 reading L2 at 8,192; its largest
    B lies past the one-block kernel's and K11a's, and one more is
    refused."""
    assert maat.peel_layout(16)[:2] == (1, True)
    assert maat.peel_layout(2048)[:2] == (8, True)
    assert maat.peel_layout(8192)[:2] == (16, False)
    assert maat.peel_layout(2048)[2] == 2 * 2048 * 64
    top = k11b_layout_top()
    assert top >= k11b_one_block_top()
    assert maat.peel_layout(top)[:2] == (16, False)
    with pytest.raises(ValueError):
        maat.peel_layout(top + 1)


def _packed_bits(p, live0):
    """P's rows, then its columns, over live0 as K11a packs them (int32
    [2 B W]: bit l of word w of row v is P[v][32 w + l]), packed here a
    1,024 rows at a time: K11a itself stops at `reach_group`'s B."""
    b = p.shape[0]
    w = -(-b // 32)
    out = torch.zeros(2, b, w, dtype=torch.int32, device=p.device)
    shift = torch.arange(32, dtype=torch.int64, device=p.device)
    for k, m in enumerate((p, p.T)):
        for r0 in range(0, b, 1024):
            blk = (m[r0:r0 + 1024] & live0[r0:r0 + 1024, None]
                   & live0[None, :]).to(torch.int64)
            blk = torch.nn.functional.pad(blk, (0, 32 * w - b))
            words = (blk.view(-1, w, 32) << shift).sum(-1)
            out[k, r0:r0 + 1024] = (words - ((words >> 31) << 32)).to(
                torch.int32)
    return out.reshape(-1)


def test_maat_peel_test_packer_is_k11as(dev):
    """`_packed_bits` gives the words of K11a's pack over live0."""
    b = 1000
    p, _, live = _digraph(b, 5, 4.0 / b)
    p, live = p.to(dev), live.to(dev)
    bits = maat.reach_scratch(b, dev)
    maat.reach_stats(p, live, live, False, bits=bits)
    w = -(-b // 32)
    assert torch.equal(bits[:2 * b * w], _packed_bits(p, live))


@pytest.mark.parametrize("where", ["k11a_top", "one_block_top"])
def test_maat_peel_large_b_matches_plain(dev, where):
    """K11b at the largest B K11a takes (on K11a's bits, the path's
    largest; 16 CTAs reading the rows from L2, the ranks in shared
    memory) and at the largest the one-block kernel took (43,112: past
    K11a, so the test packs the bits; the ranks read from global memory
    too).  A ring over a third of the txns, random edges, tied ranks;
    on_cycle0 a random part of live0 (the peel takes any such set)."""
    if where == "k11a_top":
        b = 1
        while True:
            try:
                maat.reach_group(b + 1)
            except ValueError:
                break
            b += 1
    else:
        b = k11b_one_block_top()
    g = torch.Generator(device=dev).manual_seed(b)
    p = torch.zeros(b, b, dtype=torch.bool, device=dev)
    src = torch.randint(0, b, (3 * b,), generator=g, device=dev)
    dst = torch.randint(0, b, (3 * b,), generator=g, device=dev)
    p[src, dst] = True
    ring = torch.arange(b // 3, device=dev)
    p[ring, (ring + 1) % (b // 3)] = True
    p.fill_diagonal_(False)
    live = torch.rand(b, generator=g, device=dev) < 0.9
    oc = live & (torch.rand(b, generator=g, device=dev) < 0.7)
    rank = torch.randint(0, b // 8, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    if where == "k11a_top":
        bits = maat.reach_scratch(b, dev)
        maat.reach_stats(p, live, live, False, bits=bits)
    else:
        bits = _packed_bits(p, live)
    assert maat.peel_layout(b)[:2] == (16, False)
    for rounds, peel_rounds in ((6, 3), (0, 1)):
        want = maat.peel_plain(p, live, oc, rank, rounds, peel_rounds, live)
        got = maat.peel(p, live, oc, rank, rounds, peel_rounds, live,
                        bits=bits)
        assert torch.equal(got, want), (rounds, peel_rounds)


def test_maat_peel_refuses_a_short_bits(dev):
    """K11b refuses bits one word short of P's rows and columns, and a
    cluster size it has no layout for, before any launch; its wrapper
    refuses a call on the card without K11a's bits."""
    from deneva_tpu_torch import kernels
    b = 100
    need = maat.peel_layout(b)[2]
    p = torch.zeros(b, b, dtype=torch.bool, device=dev)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    rank = torch.zeros(b, dtype=torch.int32, device=dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    for length, ctas in ((need - 1, 0), (need, 3)):
        bits = torch.empty(length, dtype=torch.int32, device=dev)
        with pytest.raises(RuntimeError, match="dt_maat_peel"):
            maat.K11B_PEEL.launch(
                kernels.ptr(live), kernels.ptr(live), kernels.ptr(rank),
                kernels.ptr(live), b, 24, 16, ctas, kernels.ptr(bits),
                length, kernels.ptr(out), None, kernels.stream(live))
    with pytest.raises(ValueError, match="bits"):
        maat.peel(p, live, live, rank, 24, 16, live, bits=None)


def test_validate_maat_matches_plain_route(dev, monkeypatch):
    """``validate_maat``'s whole verdict on a real MAAT epoch whose level
    gate is set: through the kernels (K11b reading K11a's bits) and
    through the plain versions, on the same inputs."""
    import dataclasses

    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.step import Engine
    cfg = Config.from_args([
        "--epoch_batch=2048", "--max_txn_in_flight=8192",
        "--synth_table_size=65536", "--zipf_theta=0.9",
        "--conflict_buckets=8192", "--cc_alg=MAAT"])
    wl = ycsb.YCSBWorkload(cfg, device=dev)
    eng = Engine(cfg, wl)
    calls, gates = [], []

    def grab(*a, **k):
        calls.append(a)
        return maat.validate_maat(*a, **k)
    eng.backend = dataclasses.replace(eng.backend, validate=grab)
    eng.run(eng.init_state(), 4)
    real = maat.reach_stats

    def counted(p, live, gate, *a, **k):
        gates.append(bool(gate.any()))
        return real(p, live, gate, *a, **k)
    monkeypatch.setattr(maat, "reach_stats", counted)
    for a in calls:
        vk, _ = maat.validate_maat(*a)
        with plain_path(wl):
            vp, _ = maat.validate_maat(*a)
        for f in ("commit", "abort", "defer", "order", "level"):
            assert torch.equal(getattr(vk, f), getattr(vp, f)), f
    assert any(gates)


@pytest.mark.parametrize("n,span,m", [(0, 10, 100), (1, 3, 50),
                                      (1000, 300, 10000),
                                      (1 << 20, 1 << 21, 655360)])
def test_sorted_lookup_matches_plain(dev, n, span, m):
    g = torch.Generator().manual_seed(n)
    keys = torch.randint(0, span, (n,), generator=g, dtype=torch.int32)
    slots = torch.randperm(n, generator=g).to(torch.int32)
    idx = SortedIndex.build(keys.to(dev), slots.to(dev), miss_slot=n)
    q = torch.randint(-2, span + 2, (m,), generator=g,
                      dtype=torch.int32).to(dev)
    assert torch.equal(idx.lookup(q), idx.lookup_plain(q))
    q2 = q[: m - m % 10].reshape(-1, 10)
    assert torch.equal(idx.lookup(q2), idx.lookup_plain(q2))


@pytest.mark.parametrize("flags", [
    ["--skew_method=HOT", "--data_perc=100", "--access_perc=0.9"],
    ["--skew_method=HOT", "--data_perc=70000", "--access_perc=0.5",
     "--key_order=true", "--txn_write_perc=0.25"],
    ["--zipf_theta=0.9", "--key_order=true"],
    ["--zipf_theta=0.0", "--txn_write_perc=0.5"]])
@pytest.mark.parametrize("n", [1, 6554])
def test_generate_options_match_plain(dev, flags, n):
    from deneva_tpu_torch.config import Config
    cfg = Config.from_args(["--epoch_batch=8192", "--max_txn_in_flight=8192",
                            "--synth_table_size=1000003"] + flags)
    wl = ycsb.YCSBWorkload(cfg, device=dev)
    key = prng.key_from_seed(9, dev)
    q, qp = wl.generate(key, n), wl.generate_plain(key, n)
    assert torch.equal(q.is_write, qp.is_write)
    assert torch.equal(q.keys, qp.keys)


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("order", [False, True])
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("n,req", [(1, 1), (1, 10), (7, 10), (333, 1),
                                   (101, 10), (13, 64), (2048, 10),
                                   (32768, 10), (65536, 10)])
def test_generate_every_option_matches_plain(dev, hot, order, gate, n, req):
    """K4b's one launch for every option (HOT x key_order x the per-txn
    gate), at one txn, ragged n x req, rows of 1, 10 and 64 keys, a sweep
    epoch's 2,048 x 10 and 32,768 x 10 (one draw a thread) and the main
    path's 65,536 x 10 (four): keys and write flags bit for bit."""
    from deneva_tpu_torch.config import Config
    flags = ["--epoch_batch=65536", "--max_txn_in_flight=65536",
             "--synth_table_size=16777216", f"--req_per_query={req}",
             f"--max_accesses={req}", f"--key_order={order}"]
    if hot:
        flags += ["--skew_method=HOT", "--data_perc=100", "--access_perc=0.9"]
    if gate:
        flags += ["--txn_write_perc=0.25"]
    wl = ycsb.YCSBWorkload(Config.from_args(flags), device=dev)
    key = prng.key_from_seed(n + req, dev)
    q, qp = wl.generate(key, n), wl.generate_plain(key, n)
    assert torch.equal(q.is_write, qp.is_write)
    assert torch.equal(q.keys, qp.keys)


@pytest.mark.parametrize("theta", [0.0, 0.3, 0.6, 0.7, 0.8, 0.9, 0.99])
def test_generate_zipf_thetas_match_plain(dev, theta):
    from deneva_tpu_torch.config import Config
    wl = ycsb.YCSBWorkload(Config.from_args(
        ["--epoch_batch=65536", "--max_txn_in_flight=65536",
         "--synth_table_size=16777216", f"--zipf_theta={theta}"]),
        device=dev)
    key = prng.key_from_seed(int(theta * 100), dev)
    q, qp = wl.generate(key, 65536), wl.generate_plain(key, 65536)
    assert torch.equal(q.is_write, qp.is_write)
    assert torch.equal(q.keys, qp.keys)


def test_generate_refuses_sorted_rows_of_65(dev):
    from deneva_tpu_torch.config import Config
    wl = ycsb.YCSBWorkload(Config.from_args(
        ["--synth_table_size=4096", "--req_per_query=65",
         "--max_accesses=65", "--key_order=true"]), device=dev)
    with pytest.raises(RuntimeError):
        wl.generate(prng.key_from_seed(3, dev), 4)
    # unsorted rows of 65 keys are drawn
    wl = ycsb.YCSBWorkload(Config.from_args(
        ["--synth_table_size=4096", "--req_per_query=65",
         "--max_accesses=65"]), device=dev)
    key = prng.key_from_seed(3, dev)
    assert torch.equal(wl.generate(key, 4).keys,
                       wl.generate_plain(key, 4).keys)


@pytest.mark.parametrize("path,flags", [
    ("MAAT", ["--cc_alg=MAAT"]),
    ("MAAT", ["--cc_alg=MAAT", "--skew_method=HOT", "--data_perc=100",
              "--access_perc=0.9", "--sim_full_row=true"]),
    ("MODES", ["--cc_alg=TPU_BATCH", "--mode=SIMPLE"]),
    ("MODES", ["--cc_alg=CALVIN", "--mode=QRY_ONLY"]),
    ("BTREE", ["--cc_alg=TPU_BATCH", "--index_struct=IDX_BTREE",
               "--key_order=true", "--txn_write_perc=0.5"])])
def test_slice4_epochs_through_kernels_match_plain_epochs(dev, path, flags):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    pool = 2048 if path == "BTREE" else 8192
    cfg = Config.from_args([
        "--epoch_batch=2048", f"--max_txn_in_flight={pool}",
        "--synth_table_size=65536", "--zipf_theta=0.9",
        "--conflict_buckets=8192", "--field_per_tuple=2"] + flags)
    wk = ycsb.YCSBWorkload(cfg, device=dev)
    wp = ycsb.YCSBWorkload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 4)
    for nm, kern in all_kernels().items():
        want = 4 * PATH_LAUNCHES[path].get(nm, 0)
        assert kern.launches == before[nm] + want, nm
    with plain_path(wp):
        sp = ep.run(sp, 4)
    lk, lp = state_leaves(sk), state_leaves(sp)
    cap = cfg.synth_table_size
    for path_, t in lk.items():
        if path_.startswith("db/MAIN_TABLE/") and t.ndim >= 1:
            assert torch.equal(t[:cap], lp[path_][:cap]), path_
            assert torch.equal(t[cap + 1:], lp[path_][cap + 1:]), path_
        else:
            assert torch.equal(t, lp[path_]), path_


# -- TPC-C: K19, K14a, K14c, K14d and the chained executor ------------------

TPCC_SMALL = ["--workload=TPCC", "--num_wh=2", "--cust_per_dist=120",
              "--max_items=200", "--max_items_per_txn=5", "--max_accesses=8",
              "--epoch_batch=64", "--conflict_buckets=1024",
              "--max_txn_in_flight=256", "--insert_table_cap=16384"]
# the tpcc_scaling point at 64 warehouses (paper_base, max_accesses=32)
TPCC_PATH = ["--workload=TPCC", "--num_wh=64", "--max_accesses=32",
             "--epoch_batch=2048", "--conflict_buckets=8192",
             "--max_txn_in_flight=10000"]


def _tpcc(dev, args):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.workloads.tpcc import TPCCWorkload
    cfg = Config.from_args(args)
    return cfg, TPCCWorkload(cfg, device=dev)


@pytest.mark.parametrize("args,n", [
    (TPCC_SMALL, 1), (TPCC_SMALL, 777),
    (TPCC_SMALL + ["--tpcc_by_last_index=false", "--mpr_neworder=1"], 500),
    (TPCC_SMALL + ["--max_items_per_txn=15", "--max_accesses=18",
                   "--num_wh=1"], 300),
    (TPCC_PATH, 2048)])
def test_tpcc_generate_matches_plain(dev, args, n):
    from deneva_tpu_torch.workloads.tpcc import TPCCQuery
    _, wl = _tpcc(dev, args)
    for seed in (1, 2):
        key = prng.key_from_seed(seed, dev)
        q, qp = wl.generate(key, n), wl.generate_plain(key, n)
        for f in TPCCQuery.__dataclass_fields__:
            assert torch.equal(getattr(q, f), getattr(qp, f)), f


@pytest.mark.parametrize("n_keys,m", [(0, 10), (100, 1000), (640000, 655360)])
def test_hash_lookup_matches_plain(dev, n_keys, m):
    from deneva_tpu_torch.storage.index import HashIndex
    g = torch.Generator().manual_seed(n_keys)
    keys = torch.randperm(4 * max(n_keys, 1), generator=g)[:n_keys]
    slots = torch.randint(0, 2**30, (n_keys,), generator=g)
    idx = HashIndex.build(keys.numpy(), slots.numpy(), miss_slot=-3,
                          device=dev)
    q = torch.randint(-1, 4 * max(n_keys, 1) + 5, (m,), generator=g,
                      dtype=torch.int32).to(dev)
    assert torch.equal(idx.lookup(q), idx.lookup_plain(q))
    short = HashIndex(keys=idx.keys, slots=idx.slots, cap=idx.cap,
                      max_probe=1, miss_slot=-3)
    assert torch.equal(short.lookup(q), short.lookup_plain(q))


def _table_pair(dev, cap, ring=False):
    from deneva_tpu_torch.storage.catalog import parse_schema
    from deneva_tpu_torch.storage.table import DeviceTable
    sch = parse_schema("TABLE=T\n\t8,double,F\n\t8,int64_t,I\n"
                       "\t8,double,G\n").table("T")
    a = DeviceTable.create(sch, cap, dev, ring=ring)
    g = torch.Generator().manual_seed(cap)
    for c in a.columns.values():
        c[:cap] = (torch.rand(cap, generator=g) * 1000).to(c.dtype).to(dev)
    return a, copy.deepcopy(a)


@pytest.mark.parametrize("n,cap,cols", [
    (1, 4, "FIG"), (2048, 4, "F"), (2048, 640, "FIG"), (8192, 64, "FG"),
    (30720, 6400000, "I"), (5000, 3, "I"), (20000, 16, "FIG"),
    (16385, 5, "F")])
def test_scatter_add_matches_plain(dev, n, cap, cols):
    a, b = _table_pair(dev, cap)
    g = torch.Generator().manual_seed(n)
    slots = torch.randint(-2, cap + 3, (n,), generator=g,
                          dtype=torch.int32).to(dev)
    mask = (torch.rand(n, generator=g) < 0.8).to(dev)
    vals = {c: (torch.rand(n, generator=g) * 4999 + 1).to(
        a.columns[c].dtype).to(dev) for c in cols}
    a.scatter_add(slots, vals, mask=mask)
    b.scatter_add_plain(slots, vals, mask=mask)
    for c in a.columns:
        assert torch.equal(a.columns[c][:cap], b.columns[c][:cap]), c
        assert torch.equal(a.columns[c][cap + 1:], b.columns[c][cap + 1:])


def _same_tables(a, b, cap):
    for c in a.columns:
        x, y = a.columns[c], b.columns[c]
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x[:cap], y[:cap]), c
        assert torch.equal(x[cap + 1:], y[cap + 1:]), c


@pytest.mark.parametrize("kind", ["one_slot", "wh4", "wh64", "cap_21_bits",
                                  "chunks", "chunks_12_cols"])
def test_scatter_add_ordered_cases_match_plain(dev, kind):
    """K14c's ordered path against plain, floats as bits: all 2,048 lanes
    on one slot, the 4- and 64-warehouse Payment shapes of the customer
    table, a capacity of 1,920,000 (21 bits), and more lanes than one
    block holds (3 columns: chunks of 4,096; 12 columns: of 2,048)."""
    from deneva_tpu_torch.storage.catalog import parse_schema
    from deneva_tpu_torch.storage.table import DeviceTable
    n, cap, k = {"one_slot": (2048, 64, 3), "wh4": (2048, 120000, 3),
                 "wh64": (2048, 1920000, 3), "cap_21_bits": (4096, 1920000, 1),
                 "chunks": (10000, 640, 3),
                 "chunks_12_cols": (5000, 64, 12)}[kind]
    cols = [f"C{j}" for j in range(k)]
    sch = parse_schema("TABLE=T\n" + "".join(
        f"\t8,{'int64_t' if j == 2 else 'double'},{c}\n"
        for j, c in enumerate(cols))).table("T")
    g = np.random.default_rng(n + k)
    a = DeviceTable.create(sch, cap, dev)
    for c in a.columns.values():
        c[:cap] = torch.from_numpy(g.uniform(0, 3e5, cap)).to(
            c.dtype).to(dev)
    b = copy.deepcopy(a)
    if kind == "one_slot":
        slots = np.full(n, 37, np.int32)
        mask = np.ones(n, bool)
    elif kind in ("wh4", "wh64"):
        wh = 4 if kind == "wh4" else 64
        w, d = g.integers(0, wh, n), g.integers(0, 10, n)
        slots = ((w * 10 + d) * 3000 + g.integers(0, 3000, n)).astype(
            np.int32)
        mask = g.random(n) < 0.43
    else:
        slots = g.integers(-3, cap + 3, n).astype(np.int32)
        mask = g.random(n) < 0.8
    vals = {c: torch.from_numpy(g.uniform(1, 5000, n)).to(
        a.columns[c].dtype).to(dev) for c in cols}
    slots, mask = torch.from_numpy(slots).to(dev), torch.from_numpy(mask).to(dev)
    a.scatter_add(slots, vals, mask=mask)
    b.scatter_add_plain(slots, vals, mask=mask)
    _same_tables(a, b, cap)


@pytest.mark.parametrize("wh", [4, 64])
@pytest.mark.parametrize("wh_update", [True, False])
def test_scatter_add_many_matches_plain(dev, wh, wh_update):
    """Payment's three tables in one K14c launch against the three plain
    calls and against three one-table launches, floats as bits."""
    from deneva_tpu_torch.storage import table
    from deneva_tpu_torch.storage.catalog import parse_schema
    from deneva_tpu_torch.storage.table import DeviceTable
    sch = parse_schema("TABLE=WAREHOUSE\n\t8,double,W_YTD\n"
                       "TABLE=DISTRICT\n\t8,double,D_YTD\n"
                       "\t8,int64_t,D_NEXT_O_ID\n"
                       "TABLE=CUSTOMER\n\t8,double,C_BALANCE\n"
                       "\t8,double,C_YTD_PAYMENT\n\t8,int64_t,"
                       "C_PAYMENT_CNT\n")
    n = 2048
    g = np.random.default_rng(wh)
    caps = {"WAREHOUSE": wh, "DISTRICT": wh * 10, "CUSTOMER": wh * 30000}
    tabs = {}
    for nm, cap in caps.items():
        t = DeviceTable.create(sch.table(nm), cap, dev)
        for c in t.columns.values():
            c[:cap] = torch.from_numpy(g.uniform(0, 3e5, cap)).to(
                c.dtype).to(dev)
        tabs[nm] = t
    w, d = g.integers(0, wh, n), g.integers(0, 10, n)
    c = g.integers(0, 3000, n)
    mask = torch.from_numpy(g.random(n) < 0.43).to(dev)
    amt = torch.from_numpy(g.uniform(1, 5000, n).astype(np.float32)).to(dev)
    amt = torch.where(mask, amt, 0.0)

    def adds(ts):
        out = [(ts["DISTRICT"], torch.from_numpy(
                    (w * 10 + d).astype(np.int32)).to(dev), {"D_YTD": amt}),
               (ts["CUSTOMER"], torch.from_numpy(
                   ((w * 10 + d) * 3000 + c).astype(np.int32)).to(dev),
                {"C_BALANCE": -amt, "C_YTD_PAYMENT": amt,
                 "C_PAYMENT_CNT": mask.to(torch.int32)})]
        if wh_update:
            out.insert(0, (ts["WAREHOUSE"], torch.from_numpy(
                w.astype(np.int32)).to(dev), {"W_YTD": amt}))
        return out
    many = {nm: copy.deepcopy(t) for nm, t in tabs.items()}
    ones = {nm: copy.deepcopy(t) for nm, t in tabs.items()}
    plain = {nm: copy.deepcopy(t) for nm, t in tabs.items()}
    k14c = table.K14C_SCATTER_ADD
    before = k14c.launches
    table.scatter_add_many(adds(many), mask)
    assert k14c.launches == before + 1
    for t, sl, up in adds(ones):
        t.scatter_add(sl, up, mask=mask)
    table.scatter_add_many_plain(adds(plain), mask)
    for nm, cap in caps.items():
        _same_tables(many[nm], plain[nm], cap)
        _same_tables(many[nm], ones[nm], cap)
    with pytest.raises(ValueError):
        table.scatter_add_many(adds(many) + adds(many)[:1], mask)


@pytest.mark.parametrize("ring,cap,n,start", [
    (True, 1000, 700, 600), (False, 1000, 700, 600),
    (True, 1966080, 30720, 1966080 - 5000), (True, 1024, 900, 2**31 - 100)])
def test_append_matches_plain(dev, ring, cap, n, start):
    a, b = _table_pair(dev, cap, ring=ring)
    a.row_cnt.fill_(start)
    b.row_cnt.fill_(start)
    g = torch.Generator().manual_seed(n)
    mask = (torch.rand(n, generator=g) < 0.7).to(dev)
    rows = {c: torch.randint(0, 99, (n,), generator=g).to(
        a.columns[c].dtype).to(dev) for c in a.columns}
    _, sa = a.append(rows, mask)
    _, sb = b.append_plain(rows, mask)
    assert torch.equal(sa, sb) and torch.equal(a.row_cnt, b.row_cnt)
    for c in a.columns:
        assert torch.equal(a.columns[c][:cap], b.columns[c][:cap]), c


def _wide_table_pair(dev, cap, ring, k):
    """Two empty tables of ``k`` int32 columns."""
    from deneva_tpu_torch.storage.catalog import parse_schema
    from deneva_tpu_torch.storage.table import DeviceTable
    sch = parse_schema("TABLE=T\n" + "".join(
        f"\t8,int64_t,C{j}\n" for j in range(k))).table("T")
    a = DeviceTable.create(sch, cap, dev, ring=ring)
    return a, copy.deepcopy(a)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2048, 2049, 30720,
                               1 << 20])
@pytest.mark.parametrize("where", ["ring_end", "int32_wrap", "fills_up"])
def test_append_tiles_match_plain(dev, n, where):
    """K14d in one tile and in many (2,048 lanes a tile): across a ring's
    end, across the int32 wrap of a ring's cursor, and on a plain table
    that fills up inside the call.  Slots, cursor and every row, pad and
    trash rows included; ten columns, so three rounds of loads."""
    ring = where != "fills_up"
    # a power-of-two ring of at least n rows: the slots run on across the
    # int32 wrap, and no call writes a slot twice
    cap = max(1024, 1 << (n - 1).bit_length()) if ring else n // 2 + 3
    start = {"ring_end": cap - n // 3, "int32_wrap": 2**31 - 1 - n // 3,
             "fills_up": cap // 3}[where]
    a, b = _wide_table_pair(dev, cap, ring, 10)
    a.row_cnt.fill_(start)
    b.row_cnt.fill_(start)
    g = torch.Generator().manual_seed(n + len(where))
    mask = (torch.rand(n, generator=g) < 0.7).to(dev)
    rows = {c: torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                             dtype=torch.int32).to(dev) for c in a.columns}
    _, sa = a.append(rows, mask)
    _, sb = b.append_plain(rows, mask)
    assert torch.equal(sa, sb) and torch.equal(a.row_cnt, b.row_cnt)
    for c in a.columns:
        assert torch.equal(a.columns[c], b.columns[c]), c


def test_append_refuses_a_short_scratch(dev):
    """K14d refuses a multi-tile call whose scratch holds fewer than a
    count a tile and the cursor, and one with none."""
    from deneva_tpu_torch import kernels
    from deneva_tpu_torch.storage import table as tmod
    a, _ = _wide_table_pair(dev, 1 << 14, True, 1)
    n = 3 * tmod.APPEND_TILE
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    col = next(iter(a.columns.values()))
    val = torch.zeros(n, dtype=col.dtype, device=dev)
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    short = torch.empty(3, dtype=torch.int32, device=dev)
    for scratch, length in ((short, 3), (None, 0)):
        with pytest.raises(RuntimeError, match="dt_append"):
            tmod.K14D_APPEND.launch(
                kernels.ptr(mask), n, kernels.ptr(a.row_cnt), a.capacity, 1,
                1, tmod._ptr_array([col]), tmod._ptr_array([val]),
                None if scratch is None else kernels.ptr(scratch), length,
                kernels.ptr(slots), kernels.stream(mask))


@pytest.mark.parametrize("n,k", [(5000, 1), (5000, 16), (30720, 4)])
def test_append_unaligned_mask_matches_plain(dev, n, k):
    """K14d's count kernel on a mask that does not start on 16 bytes (its
    byte loads), at one column and at the most it takes (16)."""
    a, b = _wide_table_pair(dev, 1 << 16, True, k)
    g = torch.Generator().manual_seed(n + k)
    mask = (torch.rand(n + 1, generator=g) < 0.5).to(dev)[1:]
    rows = {c: torch.randint(0, 1000, (n,), generator=g,
                             dtype=torch.int32).to(dev) for c in a.columns}
    for _ in range(3):            # the cursor carries across calls
        _, sa = a.append(rows, mask)
        _, sb = b.append_plain(rows, mask)
        assert torch.equal(sa, sb) and torch.equal(a.row_cnt, b.row_cnt)
    for c in a.columns:
        assert torch.equal(a.columns[c], b.columns[c]), c


@pytest.mark.parametrize("b", [1, 255, 256, 257, 2048, 16383, 16384,
                               16385, 65536])
def test_audit_rank_matches_plain(dev, b):
    """K17's counting rank against its plain version (a stable argsort
    and a scatter): ties, negative orders, committed txns at INT32_MAX;
    from aligned tensors (16-byte loads) and from tensors one element in
    (scalar loads); up to the audit's largest batch (16,384) and past
    it."""
    from deneva_tpu_torch.cc import base
    g = torch.Generator().manual_seed(b)
    committed = (torch.rand(b + 1, generator=g) < 0.7).to(dev)
    order = torch.randint(-b, b + 1, (b + 1,), generator=g,
                          dtype=torch.int32)
    order[torch.rand(b + 1, generator=g) < 0.05] = BIG
    order[torch.rand(b + 1, generator=g) < 0.02] = -2**31
    order = order.to(dev)
    for lo in (0, 1):
        c, o = committed[lo:lo + b], order[lo:lo + b]
        assert torch.equal(base.audit_rank(c, o),
                           base.audit_rank_plain(c, o)), lo


def test_audit_rank_due_gate(dev):
    """Off the cadence the rank returns at once; the next rank on the
    stream is exact."""
    from deneva_tpu_torch.cc import base
    g = torch.Generator().manual_seed(0)
    committed = (torch.rand(9000, generator=g) < 0.5).to(dev)
    order = torch.randint(0, 50, (9000,), generator=g,
                          dtype=torch.int32).to(dev)
    want = base.audit_rank_plain(committed, order)
    for due in (True, False, True):
        d = torch.tensor(due, device=dev)
        got = base.audit_rank(committed, order, due=d)
        torch.cuda.synchronize()
        if due:
            assert torch.equal(got, want)


@pytest.mark.parametrize("path,flags", [
    ("TPCC_CHAINED", ["--cc_alg=TPU_BATCH", "--num_wh=1"]),
    ("TPCC_CHAINED", ["--cc_alg=CALVIN", "--tpcc_full_schema=true",
                      "--insert_table_cap=256"]),
    ("TPCC_SWEEP", ["--cc_alg=NO_WAIT"]),
    ("TPCC_SWEEP", ["--cc_alg=OCC", "--escrow_sweep=false"]),
    ("TPCC_TO", ["--cc_alg=MVCC"]),
    ("TPCC_MAAT", ["--cc_alg=MAAT"]),
    ("TPCC_CHAINED_IDX", ["--cc_alg=TPU_BATCH", "--num_wh=1",
                          "--tpcc_order_index=true"]),
    ("TPCC_SWEEP_IDX", ["--cc_alg=OCC", "--tpcc_order_index=true",
                        "--insert_table_cap=256"])])
def test_tpcc_epochs_through_kernels_match_plain_epochs(dev, path, flags):
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    cfg, wk = _tpcc(dev, TPCC_SMALL + flags)
    _, wp = _tpcc(dev, TPCC_SMALL + flags)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 4)
    for nm, kern in all_kernels().items():
        want = 4 * PATH_LAUNCHES[path].get(nm, 0)
        assert kern.launches == before[nm] + want, nm
    with plain_path(wp):
        sp = ep.run(sp, 4)
    _same_leaves(sk, sp)


def _same_leaves(sk, sp):
    """Every leaf; a table's rows [0, capacity) and its padded rows (the
    trash row takes masked writes in an unspecified order), an index's
    arrays whole."""
    from deneva_tpu_torch.convert import state_leaves
    lk, lp = state_leaves(sk), state_leaves(sp)
    for p, t in lk.items():
        tab = sk.db.get(p.split("/")[1]) if p.startswith("db/") else None
        if hasattr(tab, "capacity") and t.ndim >= 1:
            cap = tab.capacity
            assert torch.equal(t[:cap], lp[p][:cap]), p
            assert torch.equal(t[cap + 1:], lp[p][cap + 1:]), p
        else:
            assert torch.equal(t, lp[p]), p


def _index(dev, cap, live, seed):
    """A DynamicSortedIndex of capacity ``cap`` holding ``live`` entries
    with duplicate keys."""
    from deneva_tpu_torch.storage.index import DynamicSortedIndex
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, 4 * max(live, 1), (live,), generator=g,
                         dtype=torch.int32)
    slots = torch.randint(0, 2**30, (live,), generator=g, dtype=torch.int32)
    return DynamicSortedIndex.build(keys.numpy(), slots.numpy(),
                                    miss_slot=cap, cap=cap, device=dev)


@pytest.mark.parametrize("cap,live,m,p", [
    (1, 0, 1, 1.0), (64, 10, 0, 0.5), (64, 10, 7, 0.0), (1000, 300, 255, 0.6),
    (5000, 4000, 2048, 0.5), (300, 200, 900, 0.9), (4096, 4000, 513, 0.7),
    (1 << 20, 1 << 19, 2048, 0.5)])
def test_index_merge_matches_plain(dev, cap, live, m, p):
    idx = _index(dev, cap, live, seed=cap + m)
    g = torch.Generator().manual_seed(m)
    nk = torch.randint(0, 4 * max(live, 1), (m,), generator=g,
                       dtype=torch.int32).to(dev)
    ns = torch.randint(0, 2**30, (m,), generator=g, dtype=torch.int32).to(dev)
    mask = (torch.rand(m, generator=g) < p).to(dev)
    before = [t.clone() for t in (idx.keys, idx.slots, idx.cnt)]
    got, want = idx.insert(nk, ns, mask), idx.insert_plain(nk, ns, mask)
    for f in ("keys", "slots", "cnt"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # the live index is read, never written
    assert all(torch.equal(a, b) for a, b in zip(
        before, (idx.keys, idx.slots, idx.cnt)))
    assert bool(got.overflowed()) == (live + int(mask.sum()) > cap)


@pytest.mark.parametrize("n,live,m,width", [
    (0, 0, 10, 4), (64, 10, 100, 3), (1 << 20, 1 << 19, 4096, 64),
    (1000, 1000, 777, 0)])
def test_sorted_probes_match_plain(dev, n, live, m, width):
    from deneva_tpu_torch.storage.index import SortedIndex
    view = _index(dev, max(n, 1), min(live, max(n, 1)), seed=n)._view()
    if n == 0:
        view = SortedIndex(keys=view.keys[:0], slots=view.slots[:0], n=0,
                           miss_slot=-5)
    g = torch.Generator().manual_seed(m)
    q = torch.randint(-2, 4 * max(live, 1) + 3, (m,), generator=g,
                      dtype=torch.int32).to(dev)
    hi = q + torch.randint(0, 9, (m,), generator=g,
                           dtype=torch.int32).to(dev)
    assert torch.equal(view.lookup_count(q), view.lookup_count_plain(q))
    for a, b in zip(view.range_slots(q, width),
                    view.range_slots_plain(q, width)):
        assert torch.equal(a, b)
    for a, b in zip(view.range_between(q, hi, width),
                    view.range_between_plain(q, hi, width)):
        assert torch.equal(a, b)


PPS_SMALL = ["--workload=PPS", "--pps_parts_cnt=500", "--pps_products_cnt=100",
             "--pps_suppliers_cnt=100", "--pps_parts_per=4",
             "--max_accesses=16", "--epoch_batch=64",
             "--conflict_buckets=1024", "--max_txn_in_flight=256"]
MIX8 = [f"--perc_{t}=0.125" for t in (
    "getparts", "getproducts", "getsuppliers", "getpartbyproduct",
    "getpartbysupplier", "orderproduct", "updateproductpart", "updatepart")]


@pytest.mark.parametrize("args,n", [
    (["--workload=PPS", "--max_accesses=32"], 1),
    (["--workload=PPS", "--max_accesses=32"], 1024),
    (PPS_SMALL + MIX8, 777),
    (["--workload=PPS", "--max_accesses=32", "--pps_parts_cnt=100003",
      "--pps_products_cnt=65537", "--pps_suppliers_cnt=3"], 5000)])
def test_pps_generate_matches_plain(dev, args, n):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.workloads.pps import PPSQuery, PPSWorkload
    wl = PPSWorkload(Config.from_args(args), device=dev)
    for seed in (1, 2):
        key = prng.key_from_seed(seed, dev)
        q, qp = wl.generate(key, n), wl.generate_plain(key, n)
        for f in PPSQuery.__dataclass_fields__:
            assert torch.equal(getattr(q, f), getattr(qp, f)), f


@pytest.mark.parametrize("path,flags", [
    ("PPS_CHAINED", ["--cc_alg=TPU_BATCH"]),
    ("PPS_CHAINED", ["--cc_alg=CALVIN", "--escrow_order_free=false"] + MIX8),
    ("PPS_SWEEP", ["--cc_alg=OCC"] + MIX8),
    ("PPS_SWEEP", ["--cc_alg=NO_WAIT"]),
    ("PPS_TO", ["--cc_alg=MVCC"] + MIX8),
    ("PPS_MAAT", ["--cc_alg=MAAT"]),
    ("PPS_NOCC", ["--cc_alg=NOCC"] + MIX8)])
def test_pps_epochs_through_kernels_match_plain_epochs(dev, path, flags):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    from deneva_tpu_torch.workloads.pps import PPSWorkload
    cfg = Config.from_args(PPS_SMALL + flags)
    wk, wp = PPSWorkload(cfg, device=dev), PPSWorkload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 4)
    for nm, kern in all_kernels().items():
        want = 4 * PATH_LAUNCHES[path].get(nm, 0)
        assert kern.launches == before[nm] + want, nm
    with plain_path(wp):
        sp = ep.run(sp, 4)
    _same_leaves(sk, sp)
    assert int(sk.stats["total_txn_commit_cnt"]) > 0


# -- transaction repair and DGCC: K13a, K15a, K15b, K16 ---------------------

def _rand_batch(b, a, n_keys, dev, seed, order_free=False):
    from deneva_tpu_torch.cc import AccessBatch
    g = torch.Generator().manual_seed(seed)
    arr = dict(table_ids=torch.randint(0, 2, (b, a), generator=g,
                                       dtype=torch.int32),
               keys=torch.randint(0, n_keys, (b, a), generator=g,
                                  dtype=torch.int32),
               is_read=torch.rand(b, a, generator=g) < 0.6,
               is_write=torch.rand(b, a, generator=g) < 0.5,
               valid=torch.rand(b, a, generator=g) < 0.9,
               ts=(torch.randperm(b, generator=g) + 1).to(torch.int32),
               rank=torch.randperm(b, generator=g).to(torch.int32),
               active=torch.rand(b, generator=g) < 0.9)
    arr["order_free"] = (torch.rand(b, a, generator=g) < 0.2) \
        if order_free else None
    return AccessBatch(**{k: None if v is None else v.to(dev)
                          for k, v in arr.items()})


@pytest.mark.parametrize("b,a,k,exact,order_free", [
    (2048, 10, 8192, True, False), (2048, 10, 8192, False, True),
    (100, 7, 64, True, True), (64, 8, 1024, True, False)])
@pytest.mark.parametrize("committed_kind", ["random", "empty", "full"])
def test_repair_frontier_matches_plain(dev, b, a, k, exact, order_free,
                                       committed_kind):
    from deneva_tpu_torch.cc import base, build_incidence
    batch = _rand_batch(b, a, 4 * b, dev, b + k, order_free)
    inc = build_incidence(batch, k, exact, order_free=batch.order_free,
                          views=("w",))
    g = torch.Generator().manual_seed(k)
    committed = {"random": torch.rand(b, generator=g) < 0.3,
                 "empty": torch.zeros(b, dtype=torch.bool),
                 "full": torch.ones(b, dtype=torch.bool)}[committed_kind]
    losers = torch.rand(b, generator=g) < 0.5
    committed, losers = committed.to(dev), losers.to(dev)
    got = base.committed_write_frontier(None, batch, inc, committed, losers)
    want = base.committed_write_frontier_plain(None, batch, inc, committed,
                                               losers)
    assert torch.equal(got, want)
    assert bool(got.any()) == (committed_kind != "empty")


@pytest.mark.parametrize("b,a,n_keys,order_free", [
    (2048, 10, 1 << 24, False), (2048, 10, 200, True), (16, 4, 5, False),
    (4096, 16, 3000, False), (300, 3, 1, True)])
def test_lane_sort_and_census_match_plain(dev, b, a, n_keys, order_free):
    from deneva_tpu_torch.cc import depgraph, dgcc
    batch = _rand_batch(b, a, n_keys, dev, b + a, order_free)
    lanes = dgcc.lanes(batch)
    got = depgraph.lane_sort(*lanes, b)
    want = depgraph.lane_sort_plain(*lanes)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for x, y in zip(depgraph.census(*got), depgraph.census_plain(*want)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,a,n_keys,levels", [
    (2048, 10, 1 << 24, 32), (2048, 10, 64, 32), (2048, 10, 8, 4),
    (16, 4, 3, 1), (4096, 16, 500, 256), (200, 6, 2, 32)])
def test_dgcc_relax_matches_plain(dev, b, a, n_keys, levels, monkeypatch):
    from types import SimpleNamespace

    from deneva_tpu_torch.cc import depgraph, dgcc
    batch = _rand_batch(b, a, n_keys, dev, b + levels)
    sk, sp, sid = depgraph.lane_sort_plain(*dgcc.lanes(batch))
    head, *_ = depgraph.census_plain(sk, sp, sid)
    sw, live = (sp & 1) == 1, sk != depgraph.LANE_PAD
    for x, y in zip(dgcc.relax(head, sid, sw, live, b, levels),
                    dgcc.relax_plain(head, sid, sw, live, b, levels)):
        assert torch.equal(x, y)
    cfg = SimpleNamespace(dgcc_levels=levels)
    out = dgcc.dgcc_levels(cfg, batch)
    monkeypatch.setattr(depgraph, "lane_sort",
                        lambda k, p, t, n: depgraph.lane_sort_plain(k, p, t))
    monkeypatch.setattr(depgraph, "census", depgraph.census_plain)
    monkeypatch.setattr(dgcc, "relax", dgcc.relax_plain)
    outp = dgcc.dgcc_levels(cfg, batch)
    for x, y in zip(out, outp):
        assert torch.equal(x, y)


def _relax_case(kind, dev):
    """(head, sid, sw, live, b, levels) of one structured K16 input."""
    from dataclasses import replace

    from deneva_tpu_torch.cc import AccessBatch, depgraph, dgcc
    levels = 32
    if kind == "chain":
        # txn 1 reads txn 0's write (wave 1); txn i >= 2 writes key i - 1
        # after txn i - 1 and key i before txn i + 1: a chain of blind
        # writes that carries wave 1 one txn a round, so the 2 * levels +
        # 4 budget cuts it (changed at exit)
        b, levels = 2048, 4
        i = torch.arange(b, dtype=torch.int32, device=dev)
        keys = torch.stack([(i - 1).clamp(min=0), i], 1)
        isw = torch.ones(b, 2, dtype=torch.bool, device=dev)
        isw[1, 0] = False
        valid = torch.ones_like(isw)
        valid[0, 1] = False
        batch = AccessBatch(
            table_ids=torch.zeros_like(keys), keys=keys, is_read=~isw,
            is_write=isw, valid=valid, ts=i + 1, rank=i,
            active=torch.ones(b, dtype=torch.bool, device=dev))
    else:
        b, a, n_keys = {"no_live": (2048, 10, 500),
                        "all_live": (2048, 10, 3000),
                        "hot_key": (2048, 10, 1),
                        "b_11616": (11616, 2, 17424),
                        "b_19368": (19368, 2, 29052),
                        "b_25600": (25600, 2, 40000),
                        "n_2e20": (25600, 20, 1 << 20)}[kind]
        batch = _rand_batch(b, a, n_keys, dev, b + a)
        if kind == "no_live":
            batch = replace(batch, active=torch.zeros_like(batch.active))
        if kind == "all_live":
            ones = torch.ones_like(batch.valid)
            batch = replace(batch, valid=ones, is_read=ones, is_write=ones,
                            active=torch.ones_like(batch.active))
    sk, sp, sid = depgraph.lane_sort(*dgcc.lanes(batch), b)
    head, *_ = depgraph.census(sk, sp, sid)
    return head, sid, (sp & 1) == 1, sk != depgraph.LANE_PAD, b, levels


@pytest.mark.parametrize("kind", ["no_live", "all_live", "hot_key", "chain",
                                  "b_11616", "b_19368", "b_25600",
                                  "n_2e20"])
@pytest.mark.parametrize("ctas", [0, 1, 2, 4, 8])
def test_dgcc_relax_clusters_match_plain(dev, kind, ctas):
    """K16 on structured inputs in the cluster the library picks (ctas =
    0, the path's launch) and capped at 1, 2, 4 and 8 CTAs; b = 11,616
    and 19,368 sit where the levels of 4 and 2 CTAs leave less room than
    the kernel's static shared memory needs."""
    from deneva_tpu_torch.cc import dgcc
    head, sid, sw, live, b, levels = _relax_case(kind, dev)
    got = (dgcc.relax(head, sid, sw, live, b, levels) if ctas == 0 else
           dgcc._relax(head, sid, sw, live, b, levels, ctas))
    want = dgcc.relax_plain(head, sid, sw, live, b, levels)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    n_live = int(live.sum())
    assert (n_live == 0) == (kind == "no_live")
    if kind == "all_live":
        assert n_live == live.numel()
    if kind == "chain":
        assert bool(got[1]) and int(got[2]) == 2 * levels + 4
    if kind == "n_2e20":
        assert live.numel() > 1 << 19


def _pad_lanes(head, sid, sw, live, n):
    """The lanes padded to n in all with dead lanes, which continue the
    dead lanes' segment (LANE_PAD sorts last) or start it."""
    k = n - live.numel()
    dev = live.device
    h = torch.zeros(k, dtype=torch.bool, device=dev)
    h[0] = live[-1]
    return (torch.cat([head, h]),
            torch.cat([sid, torch.zeros(k, dtype=torch.int32, device=dev)]),
            torch.cat([sw, torch.zeros(k, dtype=torch.bool, device=dev)]),
            torch.cat([live, torch.zeros(k, dtype=torch.bool, device=dev)]))


@pytest.mark.parametrize("edge", ["ctas", "lanes"])
def test_dgcc_relax_layout_edges_match_plain(dev, edge):
    """K16 either side of the library's two choices: the largest b whose
    levels a cluster of 4 holds and the next b (2 CTAs), and, at b =
    2,048, the most lanes whose words fit in shared memory beside the
    levels and one lane more (words in scratch)."""
    from deneva_tpu_torch.cc import dgcc
    if edge == "ctas":
        top = max(b for b in range(8, 25601, 8)
                  if dgcc.relax_layout(4096, b)[0] == 4)
        top = max(b for b in range(top, top + 8)
                  if dgcc.relax_layout(4096, b)[0] == 4)
        assert dgcc.relax_layout(4096, top + 1)[0] == 2
        cases = [(top, 2, None), (top + 1, 2, None)]
    else:
        ns = [n for n in range(4096, 1 << 21, 4096)
              if dgcc.relax_layout(n, 2048)[1]]
        top = max(n for n in range(ns[-1], ns[-1] + 4096)
                  if dgcc.relax_layout(n, 2048)[1])
        assert dgcc.relax_layout(top, 2048)[0] == 4
        assert not dgcc.relax_layout(top + 1, 2048)[1]
        cases = [(2048, 10, top), (2048, 10, top + 1)]
    from deneva_tpu_torch.cc import depgraph
    for b, a, n in cases:
        batch = _rand_batch(b, a, 3 * b // 2, dev, b + a)
        sk, sp, sid = depgraph.lane_sort(*dgcc.lanes(batch), b)
        head, *_ = depgraph.census(sk, sp, sid)
        args = (head, sid, (sp & 1) == 1, sk != depgraph.LANE_PAD)
        if n is not None:
            args = _pad_lanes(*args, n)
        got = dgcc.relax(*args, b, 32)
        want = dgcc.relax_plain(*args, b, 32)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_dgcc_relax_refuses_a_short_scratch(dev):
    """K16 refuses a scratch one word short of what its layout reports,
    before any launch."""
    from deneva_tpu_torch import kernels
    from deneva_tpu_torch.cc import dgcc
    n, b = 1 << 20, 25600
    ctas, shared, words = dgcc.relax_layout(n, b)
    assert not shared and words > 0
    z = torch.zeros(n, dtype=torch.bool, device=dev)
    sid = torch.zeros(n, dtype=torch.int32, device=dev)
    meta = torch.empty(words - 1, dtype=torch.int32, device=dev)
    out = torch.empty(b, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="dt_dgcc_relax"):
        dgcc.K16_RELAX.launch(
            kernels.ptr(z), kernels.ptr(sid), kernels.ptr(z), kernels.ptr(z),
            n, b, 32, 68, 0, kernels.ptr(meta), words - 1, kernels.ptr(out),
            kernels.ptr(z), kernels.ptr(sid), kernels.stream(z))


REPAIR_YCSB = ["--epoch_batch=2048", "--max_txn_in_flight=8192",
               "--synth_table_size=65536", "--zipf_theta=0.9",
               "--read_perc=0.1", "--write_perc=0.9",
               "--conflict_buckets=8192", "--field_per_tuple=2",
               "--watermark_buckets=4096"]


@pytest.mark.parametrize("path,flags", [
    (f"{alg}+R{r}", [f"--cc_alg={alg}", "--repair=true",
                     f"--repair_rounds={r}"])
    for alg, r in (("OCC", 2), ("OCC", 0), ("NO_WAIT", 1), ("WAIT_DIE", 2),
                   ("TIMESTAMP", 2), ("MVCC", 2), ("MAAT", 2))] + [
    ("DGCC", ["--cc_alg=DGCC"]),
    ("DGCC", ["--cc_alg=DGCC", "--zipf_theta=0.99", "--sim_full_row=true"])])
def test_repair_and_dgcc_epochs_through_kernels_match_plain(dev, path,
                                                            flags):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    cfg = Config.from_args(REPAIR_YCSB + flags)
    wk = ycsb.YCSBWorkload(cfg, device=dev)
    wp = ycsb.YCSBWorkload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 4)
    for nm, kern in all_kernels().items():
        want = 4 * PATH_LAUNCHES[path].get(nm, 0)
        assert kern.launches == before[nm] + want, nm
    with plain_path(wp):
        sp = ep.run(sp, 4)
    _same_leaves(sk, sp)
    st = {k: int(v.sum()) for k, v in sk.stats.items()}
    if path.startswith("DGCC"):
        assert st["total_txn_abort_cnt"] == 0 and st["dgcc_wave_max"] > 1
    elif path.endswith("R0"):
        assert st["rep_salvaged_cnt"] == 0
    else:
        assert st["total_txn_abort_cnt"] == st["rep_fallback_cnt"]


@pytest.mark.parametrize("path,flags", [
    ("TPCC_SWEEP+R2", ["--cc_alg=OCC", "--escrow_sweep=false",
                       "--repair=true", "--repair_rounds=2"]),
    ("TPCC_TO+R2", ["--cc_alg=TIMESTAMP", "--escrow_sweep=false",
                    "--repair=true", "--repair_rounds=2"]),
    ("TPCC_SWEEP_IDX+R1", ["--cc_alg=NO_WAIT", "--escrow_sweep=false",
                           "--repair=true", "--repair_rounds=1",
                           "--tpcc_order_index=true"]),
    ("TPCC_DGCC", ["--cc_alg=DGCC"])])
def test_tpcc_repair_and_dgcc_epochs_through_kernels_match_plain(dev, path,
                                                                 flags):
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    cfg, wk = _tpcc(dev, TPCC_SMALL + flags)
    _, wp = _tpcc(dev, TPCC_SMALL + flags)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 4)
    for nm, kern in all_kernels().items():
        want = 4 * PATH_LAUNCHES[path].get(nm, 0)
        assert kern.launches == before[nm] + want, nm
    with plain_path(wp):
        sp = ep.run(sp, 4)
    _same_leaves(sk, sp)


# -- the metrics and audit planes (K13b, K15a wide, K15c, K17) -----------------

@pytest.mark.parametrize("b,a,k,p,n_keys", [
    (2048, 10, 8192, 1, 1 << 24), (2048, 16, 8192, 2, 300),
    (65536, 10, 8192, 1, 1 << 24), (64, 4, 1024, 2, 5), (33, 3, 64, 3, 7)])
@pytest.mark.parametrize("from_incidence", [False, True])
def test_conflict_density_matches_plain(dev, b, a, k, p, n_keys,
                                        from_incidence):
    from types import SimpleNamespace

    from deneva_tpu_torch.cc import base
    batch = _rand_batch(b, a, n_keys, dev, b + k + p)
    g = torch.Generator().manual_seed(p)
    owner = torch.randint(0, p + 1, (b, a), generator=g,
                          dtype=torch.int32).to(dev)
    cfg = SimpleNamespace(part_cnt=p, conflict_buckets=k)
    got = base.conflict_density(cfg, batch, owner, from_incidence)
    want = base.conflict_density_plain(cfg, batch, owner, from_incidence)
    assert torch.equal(got, want) and int(got.sum()) > 0


@pytest.mark.parametrize("b,a,k,p,n_keys", [
    (511, 1, 8, 1, 50), (513, 1, 1 << 18, 4, 1 << 24), (31, 16, 8192, 1024,
                                                        300),
    (33, 16, 8, 3, 40), (700, 33, 512, 4, 2000), (65, 33, 1 << 18, 1024,
                                                  1 << 20),
    (4096, 10, 1024, 2, 5000), (2048, 10, 1 << 18, 4, 1 << 26),
    (2048, 10, 8192, 4, 1 << 24), (65536, 10, 8192, 1, 1 << 24),
    (65536, 10, 1 << 18, 4, 1 << 24), (3000, 40, 8192, 2, 1 << 20)])
def test_conflict_density_edges_match_plain(dev, b, a, k, p, n_keys):
    """K13b's one launch at the edges of its layout: B x A one less and one
    more than a block's 512 lanes (A = 1), rows that fill a warp (16) or
    cross it (33, 40), k from 8 to the router's 2^18, P up to 1,024, with
    a hot key in every row, in the regime the library picks (dense at k =
    8, 512 and 1,024 and on the main path's batch; direct at 2^18 and on a
    2,048-txn epoch; `test_conflict_density_layout_regimes`), both
    arms."""
    from types import SimpleNamespace

    from deneva_tpu_torch.cc import base
    batch = _rand_batch(b, a, n_keys, dev, b + a + k)
    batch.keys[:, 0] = 7                # a bucket every block touches
    g = torch.Generator().manual_seed(p + a)
    owner = torch.randint(-1, p + 1, (b, a), generator=g,
                          dtype=torch.int32).to(dev)
    cfg = SimpleNamespace(part_cnt=p, conflict_buckets=k)
    for arm in (False, True):
        got = base.conflict_density(cfg, batch, owner, arm)
        want = base.conflict_density_plain(cfg, batch, owner, arm)
        assert torch.equal(got, want) and int(got.sum()) > 0


def test_conflict_density_layout_regimes(dev):
    """The library's regime by shape: dense where a block's lanes are many
    against k <= 8,192 (the main path's batch, small k), direct on a
    2,048-txn epoch at 8,192 buckets and at the router's 2^18; the
    scratch is 8 k words at k <= 8,192 and k above, and a shorter one is
    refused before any launch."""
    import ctypes
    from types import SimpleNamespace

    from deneva_tpu_torch import kernels
    from deneva_tpu_torch.cc import base
    for (b, a, k), dense in (((65536, 10, 8192), True), ((511, 1, 8), True),
                             ((4096, 10, 1024), True),
                             ((2048, 10, 8192), False),
                             ((2048, 10, 1 << 18), False),
                             ((65536, 10, 1 << 18), False)):
        words, got, grid = base.conflict_density_layout(b, a, k)
        assert got == dense, (b, a, k)
        assert words == (8 * k if k <= 8192 else k) and grid >= 1
    with pytest.raises(ValueError):
        base.conflict_density_layout(1 << 16, 1 << 15, 8192)
    batch = _rand_batch(64, 4, 50, dev, 3)
    owner = torch.zeros(64, 4, dtype=torch.int32, device=dev)
    words = base.conflict_density_layout(64, 4, 64)[0]
    hist = torch.empty(words, dtype=torch.int64, device=dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    fn = kernels.library().dt_conflict_density
    fn.argtypes = base.K13B_DENSITY.argtypes
    fn.restype = ctypes.c_int
    args = [kernels.ptr(t) for t in (batch.table_ids, batch.keys,
                                     batch.valid, batch.is_read,
                                     batch.is_write, batch.active, owner)]
    assert fn(*args, 64, 4, 64, 1, 0, kernels.ptr(hist), words - 1,
              kernels.ptr(out), kernels.stream(owner)) != 0
    cfg = SimpleNamespace(part_cnt=1, conflict_buckets=64)
    assert torch.equal(base.conflict_density(cfg, batch, owner),
                       base.conflict_density_plain(cfg, batch, owner))


def test_conflict_density_no_valid_lane_and_no_row(dev):
    from types import SimpleNamespace

    from deneva_tpu_torch.cc import base
    cfg = SimpleNamespace(part_cnt=4, conflict_buckets=64)
    batch = _rand_batch(100, 10, 30, dev, 5)
    batch.valid[:] = False
    owner = torch.zeros(100, 10, dtype=torch.int32, device=dev)
    assert base.conflict_density(cfg, batch, owner, True).tolist() == [0] * 4
    empty = _rand_batch(0, 10, 30, dev, 6)
    owner = torch.zeros(0, 10, dtype=torch.int32, device=dev)
    assert base.conflict_density(cfg, empty, owner).tolist() == [0] * 4


def _audit_lanes(b, a, n_keys, levels, dev, seed, order_vis=False):
    """A random batch's doubled audit lanes (plain build) with committed
    txns on ``levels`` bands."""
    from deneva_tpu_torch.cc import base
    batch = _rand_batch(b, a, n_keys, dev, seed, order_free=True)
    g = torch.Generator().manual_seed(seed)
    committed = (torch.rand(b, generator=g) < 0.7).to(dev) & batch.active
    lvl = torch.where(committed, torch.randint(
        0, levels, (b,), generator=g, dtype=torch.int32).to(dev), 0)
    order = torch.randint(0, b, (b,), generator=g,
                          dtype=torch.int32).to(dev)
    return batch, committed, order, lvl, base.audit_lanes_plain(
        batch, committed, order, lvl, order_vis)


@pytest.mark.parametrize("b,a,n_keys,levels", [
    (2048, 10, 1 << 24, 1), (2048, 10, 300, 32), (16384, 4, 5000, 32),
    (16384, 2, 100, 256), (7, 3, 2, 4)])
def test_lane_sort_wide_positions_match_plain(dev, b, a, n_keys, levels):
    from deneva_tpu_torch.cc import depgraph
    *_, lanes = _audit_lanes(b, a, n_keys, levels, dev, b + levels)
    bound = 2 * levels * (b + 2)
    got = depgraph.lane_sort(*lanes, b, pos_bound=bound)
    for x, y in zip(got, depgraph.lane_sort_plain(*lanes)):
        assert torch.equal(x, y)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    depgraph.lane_sort(*lanes, b, pos_bound=bound, due=off)   # returns


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("b,a,n_keys", [(2048, 10, 1 << 24), (2048, 10, 3),
                                        (16384, 4, 5000), (5, 1, 1)])
def test_lane_sort_due_gate(dev, wide, b, a, n_keys):
    """K15a packed and wide behind the audit's ``due`` flag: on, the sort
    is exact; off, every launch returns at once, and the next sort on
    the same stream is exact."""
    from deneva_tpu_torch.cc import depgraph
    *_, lanes = _audit_lanes(b, a, n_keys, 4, dev, b + a + wide)
    # a position bound of 2^30 takes 30 bits: past the packed word's 32
    bound = 1 << 30 if wide else 2 * 4 * (b + 2)
    on = torch.ones((), dtype=torch.bool, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    want = depgraph.lane_sort_plain(*lanes)
    for due in (on, off, on):
        got = depgraph.lane_sort(*lanes, b, pos_bound=bound, due=due)
        torch.cuda.synchronize()
        if bool(due):
            for x, y in zip(got, want):
                assert torch.equal(x, y)


@pytest.mark.parametrize("b,a,n_keys,levels,cap,order_vis", [
    (2048, 10, 1 << 24, 1, 4096, False), (2048, 10, 64, 1, 4096, True),
    (2048, 16, 500, 32, 4096, False), (512, 8, 40, 4, 64, False),
    (16384, 4, 3000, 1, 4096, True), (9, 2, 2, 2, 64, False)])
def test_audit_scans_and_compaction_match_plain(dev, b, a, n_keys, levels,
                                                cap, order_vis):
    from deneva_tpu_torch.cc import depgraph
    _, _, _, lvl, lanes = _audit_lanes(b, a, n_keys, levels, dev, b + cap,
                                       order_vis)
    srt = depgraph.lane_sort_plain(*lanes)
    got = depgraph.audit_scans(*srt, 1 << 16)
    want = depgraph.audit_scans_plain(*srt, 1 << 16)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for due in (None, True, False):
        d = None if due is None else torch.tensor(due, device=dev)
        got = depgraph.compact_edges(*want[:3], lvl, cap, d)
        exp = depgraph.compact_edges_plain(*want[:3], lvl, cap, d)
        for x, y in zip(got, exp):
            assert torch.equal(x, y)
    assert int(got[2]) == 0 and int(exp[2]) == 0     # the last: due False


@pytest.mark.parametrize("b,a,n_keys,levels,mvcc,order_vis", [
    (2048, 10, 1 << 24, 1, False, False), (2048, 10, 200, 1, True, False),
    (2048, 16, 100, 4, False, False), (2048, 10, 50, 1, False, True),
    (16384, 4, 2000, 32, True, False), (9, 2, 3, 2, True, True)])
def test_audit_observe_matches_plain(dev, b, a, n_keys, levels, mvcc,
                                     order_vis, monkeypatch):
    import dataclasses
    from types import SimpleNamespace

    from deneva_tpu_torch.cc import base, depgraph
    cfg = SimpleNamespace(audit_buckets=1 << 16, audit_edges_max=4096,
                          audit_cadence=4, mvcc_his_len=4,
                          cc_alg="MVCC" if mvcc else "OCC")
    batch, committed, order, lvl, _ = _audit_lanes(b, a, n_keys, levels, dev,
                                                   b + levels, order_vis)
    st_k = base.audit_init(cfg, dev)
    st_p = copy.deepcopy(st_k)
    outs = []
    for e in range(6):
        ep = torch.tensor(e, dtype=torch.int32, device=dev)
        bt = dataclasses.replace(batch, ts=batch.ts + 3 * e)
        ok = base.audit_observe(cfg, bt, committed, order, lvl, order_vis,
                                st_k, ep, levels)
        with monkeypatch.context() as m:
            for mod, nm in ((base, "audit_lanes"), (base, "audit_stamps"),
                            (depgraph, "audit_scans"),
                            (depgraph, "compact_edges")):
                m.setattr(mod, nm, getattr(mod, nm + "_plain"))
            m.setattr(depgraph, "lane_sort",
                      lambda k, p, t, n, **kw: depgraph.lane_sort_plain(
                          k, p, t))
            op = base.audit_observe(cfg, bt, committed, order, lvl,
                                    order_vis, st_p, ep, levels)
        st_k, st_p = ok[0], op[0]
        for f in st_k:
            assert torch.equal(st_k[f], st_p[f]), (e, f)
        for x, y in zip(ok[1:], op[1:]):
            assert torch.equal(x, y), e
        outs.append(int(ok[3]))
    assert outs[0] > 0 and outs[1] == 0 and outs[4] > 0


AUDIT_YCSB = REPAIR_YCSB + ["--audit=true", "--metrics=true"]


@pytest.mark.parametrize("path,flags", [
    ("OCC+A", ["--cc_alg=OCC", "--audit_cadence=1"]),
    ("OCC+A", ["--cc_alg=OCC", "--audit_cadence=2"]),
    ("OCC+A+M", ["--cc_alg=OCC", "--audit_cadence=1",
                 "--audit_mutate=occ-read-skip:1:2"]),
    ("CALVIN+A", ["--cc_alg=CALVIN", "--audit_cadence=1",
                  "--max_txn_in_flight=2048"]),
    ("MVCC+A", ["--cc_alg=MVCC", "--audit_cadence=1"]),
    ("DGCC+A", ["--cc_alg=DGCC", "--audit_cadence=1"]),
    ("OCC+R2+A", ["--cc_alg=OCC", "--audit_cadence=1", "--repair=true"]),
    ("TIMESTAMP+A", ["--cc_alg=TIMESTAMP", "--audit_cadence=3"])])
def test_audited_epochs_through_kernels_match_plain(dev, path, flags):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    cfg = Config.from_args(AUDIT_YCSB + flags)
    wk = ycsb.YCSBWorkload(cfg, device=dev)
    wp = ycsb.YCSBWorkload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = ek.run(sk, 4)
    for nm, kern in all_kernels().items():
        want = 4 * PATH_LAUNCHES[path].get(nm, 0)
        assert kern.launches == before[nm] + want, nm
    with plain_path(wp):
        sp = ep.run(sp, 4)
    _same_leaves(sk, sp)
    st = {k: int(v.sum()) for k, v in sk.stats.items()}
    assert st["conflict_density"] > 0
    if path in ("CALVIN+A", "DGCC+A", "MVCC+A"):
        assert st["audit_edge_cnt"] > 0


@pytest.mark.parametrize("path,flags", [
    ("TPCC_CHAINED+A", ["--cc_alg=TPU_BATCH"]),
    ("TPCC_DGCC+A", ["--cc_alg=DGCC"]),
    ("TPCC_SWEEP+A", ["--cc_alg=OCC", "--escrow_sweep=false"])])
def test_tpcc_audited_epochs_through_kernels_match_plain(dev, path, flags):
    from deneva_tpu_torch.engine.step import Engine
    args = TPCC_SMALL + flags + ["--audit=true", "--metrics=true",
                                 "--audit_cadence=1"]
    cfg, wk = _tpcc(dev, args)
    _, wp = _tpcc(dev, args)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    sk = ek.run(sk, 4)
    with plain_path(wp):
        sp = ep.run(sp, 4)
    _same_leaves(sk, sp)
    assert int(sk.stats["audit_edge_cnt"]) > 0


# -- slice 9: the mesh's K18a / K18b and mesh epochs ----------------------

def _mc_slice(bd, a, d, n_keys, dev, seed, kind):
    """One source slice: keys (skewed like zipf 0.9), valid lanes,
    ts, rank, write lanes.  ``kind`` picks the edge: ``one_owner`` (every
    key owned by shard 1), ``rep_ts`` (ts repeat across txns),
    ``invalid`` (a third of the lanes and a tenth of the txns invalid)."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(bd, a, generator=g, dtype=torch.float64)
    keys = (n_keys * u ** 4).to(torch.int32).clamp_max(n_keys - 1)
    if kind == "one_owner":
        keys = keys // d * d + 1
    drop = 0.33 if kind == "invalid" else 0.05
    valid = torch.rand(bd, a, generator=g) >= drop
    if kind == "invalid":
        valid[torch.rand(bd, generator=g) < 0.1] = False
    hi = max(bd // 8, 2) if kind == "rep_ts" else 2**31 - 1
    ts = torch.randint(1, hi, (bd,), generator=g, dtype=torch.int32)
    rank = (torch.randperm(bd, generator=g) + 1).to(torch.int32)
    w = valid & (torch.rand(bd, a, generator=g) < 0.5)
    return [x.to(dev) for x in (keys, valid, ts, rank, w)]


MC_CASES = [
    (8192, 10, 8, 20480, "zipf"),      # the main path: B = 65,536, D = 8
    (1, 10, 8, 128, "zipf"),           # one txn
    (32768, 10, 2, 163840, "zipf"),    # the main path's batch at D = 2
    (16384, 10, 4, 81920, "zipf"),     # the main path at D = 4
    (512, 4, 8, 128, "zipf"),          # test_parallel's tight capacity
    (1000, 10, 8, 10, "one_owner"),    # pair_cap = one txn's lanes
    (777, 7, 3, 14, "rep_ts"),
    (300, 16, 2, 64, "invalid"),
    (40000, 3, 8, 6000, "rep_ts")]


@pytest.mark.parametrize("bd,a,d,cap,kind", MC_CASES)
def test_mc_defer_and_pack_match_plain(dev, bd, a, d, cap, kind):
    k, v, ts, r, w = _mc_slice(bd, a, d, 1 << 20, dev, bd + a + d, kind)
    dfr, order = forward.mc_slice_defer(k, v, ts, d, cap)
    dfr_p, order_p = forward.mc_slice_defer_plain(k, v, ts, d, cap)
    assert torch.equal(dfr, dfr_p) and torch.equal(order, order_p)
    if kind == "one_owner":
        assert int((~dfr).sum()) >= 1 and bool(dfr.any())
    got = forward.mc_pack_blocks(k, v, ts, r, w, dfr, order, d, cap)
    want = forward.mc_pack_blocks_plain(k, v, ts, r, w, dfr, d, cap)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    # the spec over D slices of whole txns is the kernel slice by slice
    keys = torch.cat([k] * d)
    valid = torch.cat([v] * d)
    tss = torch.cat([ts] * d)
    assert torch.equal(forward.mc_plan_defer(keys, tss, valid, d, cap),
                       forward.mc_plan_defer_plain(keys, tss, valid, d, cap))


def test_mc_kernels_refuse_what_they_do_not_take(dev):
    k, v, ts, r, w = _mc_slice(64, 4, 8, 1000, dev, 0, "zipf")
    with pytest.raises(ValueError, match="2 to 8 shards"):
        forward.mc_slice_defer(k, v, ts, 9, 64)
    with pytest.raises(ValueError, match="one txn's"):
        forward.mc_slice_defer(k, v, ts, 8, 3)
    with pytest.raises(TypeError):
        forward.mc_slice_defer(k.to(torch.int64), v, ts, 8, 64)


def test_mc_defer_refuses_short_scratch_and_wide_txns(dev):
    """K18a's scratch comes from its layout (nothing in it zeroed); a
    shorter one is refused before the launch, and so is a txn of more
    than 255 lanes (its owner counts are bytes)."""
    import ctypes
    from deneva_tpu_torch import kernels
    k, v, ts, r, w = _mc_slice(4096, 10, 8, 1000, dev, 1, "zipf")
    grid, tiles, words = forward.mc_defer_layout(4096, 10, 8)
    assert tiles == 4 and grid == 4
    dfr = torch.empty(4096, dtype=torch.bool, device=dev)
    order = torch.empty(4096, dtype=torch.int32, device=dev)
    scratch = torch.full((words,), -1, dtype=torch.int32, device=dev)
    before = forward.K18A_DEFER.launches
    with pytest.raises(RuntimeError, match="dt_mc_defer"):
        forward.K18A_DEFER.launch(
            kernels.ptr(k), kernels.ptr(v), kernels.ptr(ts), 4096, 10, 8, 64,
            kernels.ptr(dfr), kernels.ptr(order), kernels.ptr(scratch),
            ctypes.c_longlong(words - 1), None, kernels.stream(k))
    assert forward.K18A_DEFER.launches == before
    # scratch full of garbage gives the same answer as a fresh one
    forward.K18A_DEFER.launch(
        kernels.ptr(k), kernels.ptr(v), kernels.ptr(ts), 4096, 10, 8, 64,
        kernels.ptr(dfr), kernels.ptr(order), kernels.ptr(scratch), words,
        None, kernels.stream(k))
    want = forward.mc_slice_defer_plain(k, v, ts, 8, 64)
    assert torch.equal(dfr, want[0]) and torch.equal(order, want[1])
    with pytest.raises(ValueError):
        forward.mc_defer_layout(16, 256, 8)


MESH_YCSB = ["--epoch_batch=4096", "--max_txn_in_flight=4096",
             "--synth_table_size=8192", "--req_per_query=4",
             "--max_accesses=4", "--conflict_buckets=1024"]


@pytest.mark.parametrize("path,d,flags", [
    ("MESH", 8, ["--zipf_theta=0.6"]),
    ("MESH", 8, ["--zipf_theta=0.9", "--mc_plan_capacity=0.25",
                 "--synth_table_size=4096"]),
    ("MESH", 4, ["--zipf_theta=0.9"]),
    ("MESH_REPL", 8, ["--zipf_theta=0.9", "--mc_plan_capacity=0"]),
    ("MESH_REPL", 2, ["--zipf_theta=0.9", "--sim_full_row=true",
                      "--tup_size=8", "--field_per_tuple=2"])])
def test_mesh_epochs_through_kernels_match_plain(dev, path, d, flags):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    from deneva_tpu_torch.parallel import make_mesh, make_sharded_run
    cfg = Config.from_args(MESH_YCSB + flags + [f"--device_parts={d}"])
    wk = ycsb.YCSBWorkload(cfg, device=dev)
    wp = ycsb.YCSBWorkload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    mesh = make_mesh(d, devices=[dev] * d)
    place, run_k = make_sharded_run(ek, mesh)
    _, run_p = make_sharded_run(ep, mesh)
    sk = place(ek.init_state())
    sp = copy.deepcopy(sk)
    before = {nm: kern.launches for nm, kern in all_kernels().items()}
    sk = run_k(sk, 4)
    want = mesh_launches(path, d)
    for nm, kern in all_kernels().items():
        assert kern.launches == before[nm] + 4 * want.get(nm, 0), nm
    with plain_path(wp):
        sp = run_p(sp, 4)
    assert differing_leaf(sk, sp) is None
    st = {k: int(x.sum()) for k, x in sk.stats.items()}
    assert st["total_txn_abort_cnt"] == 0
    if "--mc_plan_capacity=0.25" in flags:
        assert st["defer_cnt"] > 0


@pytest.mark.parametrize("args,alg", [
    (TPCC_SMALL, "TPU_BATCH"), (TPCC_SMALL, "NO_WAIT"),
    (["--workload=PPS", "--pps_parts_cnt=400", "--pps_products_cnt=80",
      "--pps_suppliers_cnt=80", "--pps_parts_per=4", "--max_accesses=9",
      "--epoch_batch=64", "--conflict_buckets=1024",
      "--max_txn_in_flight=256"], "MAAT")])
def test_generic_mesh_epochs_through_kernels_match_plain(dev, args, alg):
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.parallel import make_mesh, make_sharded_run
    from deneva_tpu_torch.workloads import get_workload
    cfg = Config.from_args(args + [f"--cc_alg={alg}", "--device_parts=2"])
    wk, wp = get_workload(cfg, device=dev), get_workload(cfg, device=dev)
    ek, ep = Engine(cfg, wk), Engine(cfg, wp)
    mesh = make_mesh(2, devices=[dev] * 2)
    place, run_k = make_sharded_run(ek, mesh)
    _, run_p = make_sharded_run(ep, mesh)
    sk = place(ek.init_state())
    sp = copy.deepcopy(sk)
    sk = run_k(sk, 4)
    with plain_path(wp):
        sp = run_p(sp, 4)
    assert differing_leaf(sk, sp) is None
    assert int(sk.stats["total_txn_commit_cnt"]) > 0


# -- slice 11: partitioned keyspaces and the contention router ---------------

def _k21_batch(dev, b, a, n_keys, seed):
    from deneva_tpu_torch.cc.base import AccessBatch
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, n_keys, (b, a), generator=g, dtype=torch.int32)
    is_w = torch.rand(b, a, generator=g) < 0.4
    is_r = ~is_w | (torch.rand(b, a, generator=g) < 0.2)
    valid = torch.rand(b, a, generator=g) < 0.9
    active = torch.rand(b, generator=g) < 0.85
    ts = torch.arange(1, b + 1, dtype=torch.int32)
    return AccessBatch(table_ids=torch.zeros_like(keys).to(dev),
                       keys=keys.to(dev), is_read=is_r.to(dev),
                       is_write=is_w.to(dev), valid=valid.to(dev),
                       ts=ts.to(dev), rank=(ts - 1).to(dev),
                       active=active.to(dev))


@pytest.mark.parametrize("b,a,k,groups", [
    (2048, 10, 8192, 3), (2048, 10, 8192, 4), (2048, 16, 64, 4),
    (333, 7, 1024, 3)])
def test_cross_group_defer_matches_plain(dev, b, a, k, groups):
    from deneva_tpu_torch.cc import router
    from deneva_tpu_torch.cc.base import build_incidence
    bt = _k21_batch(dev, b, a, 1 << 20, seed=b + k)
    inc = build_incidence(bt, k, True, views=("u", "w"))
    owner = bt.keys % 4
    for assign in ([0, 1, 2, 2], [2, 1, 0, 1], [0, 1, 2, 3][:groups]
                   + [0] * (4 - groups)):
        kn = router.knobs_from_decision(None, assign, [0] * 4, 1, 1, dev)
        grp = router.txn_backend(kn, owner)
        before = router.K21_DEFER.launches
        out = router.cross_group_defer(inc, bt, grp, groups)
        assert router.K21_DEFER.launches == before + 1
        assert torch.equal(out, router.cross_group_defer_plain(
            inc, bt, grp, groups))


def test_forward_execute_leaves_the_trash_row_at_part_cnt_4(dev):
    """K3 at part_cnt = 4: the winners of keys another partition owns
    carry the trash slot, and the kernel writes nothing there (the plain
    version neither); every data row equals the plain version's."""
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.ops import forward
    for full in (False, True):
        cfg = Config.from_args(["--synth_table_size=65536", "--part_cnt=4",
                                "--epoch_batch=4096",
                                "--max_txn_in_flight=4096",
                                f"--sim_full_row={full}", "--tup_size=8",
                                "--field_per_tuple=1"])
        wl = ycsb.YCSBWorkload(cfg, device=dev)
        tab = wl.load()[ycsb.TABLE]
        f0 = tab.columns["F0"]
        f0p = f0.clone()
        k, r, w = _lanes(40960, 65536, dev, seed=4)
        words = forward.sort_lanes(k, r, w)
        plan = forward.plan_scans(words)
        slots = wl._local_slots(None, plan.keys)
        trash = tab.capacity
        assert bool((plan.win & (slots == trash)).any())
        _, cks, wc = ycsb._forward_execute_f0(f0, plan, slots, trash)
        _, cksp, wcp = ycsb._forward_execute_f0_plain(f0p, plan, slots,
                                                      trash)
        assert torch.equal(f0, f0p)
        assert int(cks) == int(cksp) and int(wc) == int(wcp)
        assert not f0[trash:].any()


def test_routed_mixed_epochs_through_kernels_match_plain(dev):
    """Routed epochs of the mixed branch (and of ctrl_dgcc's four groups)
    at part_cnt = 4: kernel epochs equal plain epochs on every leaf, and
    K21 launches once an epoch."""
    from deneva_tpu_torch.cc import router
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.kernels import all_kernels
    base = ["--synth_table_size=65536", "--part_cnt=4", "--req_per_query=10",
            "--max_accesses=16", "--epoch_batch=512",
            "--max_txn_in_flight=2048", "--conflict_buckets=65536",
            "--zipf_theta=0.6", "--cc_alg=OCC", "--metrics=true",
            "--ctrl=true", "--escrow_order_free=false", "--repair=true",
            "--audit=true", "--audit_cadence=1"]
    for extra, assign, path in (
            ([], [0, 1, 2, 2], "ROUTED_MIXED"),
            (["--ctrl_dgcc=true"], [0, 1, 2, 3], "ROUTED_MIXED_DGCC")):
        cfg = Config.from_args(base + extra)
        wk = ycsb.YCSBWorkload(cfg, device=dev)
        wp = ycsb.YCSBWorkload(cfg, device=dev)
        ek, ep = Engine(cfg, wk), Engine(cfg, wp)
        kn = router.knobs_from_decision(cfg, assign, [0, 2, 0, 0], 1, 2, dev)
        sk = ek.init_state()
        sp = copy.deepcopy(sk)
        before = {nm: kern.launches for nm, kern in all_kernels().items()}
        sk = ek.run_ctrl(sk, kn, 3)
        for nm, kern in all_kernels().items():
            want = 3 * PATH_LAUNCHES[path].get(nm, 0)
            assert kern.launches == before[nm] + want, nm
        with plain_path(wp):
            sp = ep.run_ctrl(sp, kn, 3)
        assert differing_leaf(sk, sp) is None
        assert int(sk.stats["total_txn_commit_cnt"]) > 0
        assert int(sk.stats["defer_cnt"]) > 0
