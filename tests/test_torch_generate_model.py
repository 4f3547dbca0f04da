"""K4b's one launch as numpy models on the CPU, against the plain version.

``csrc/ycsb.cu`` ``generate_kernel`` draws YCSB's queries in one launch
of the occupancy grid for every option.  The models follow its rules:

* The thread map: a thread draws 4 consecutive elements where the
  draws at 4 a thread fill at least half the resident threads, else 1.
  A chunk is a multiple of 4 whole rows.  At 4 draws it holds at most a
  block's 1,024 draws, fewer where that would leave blocks of the
  occupancy grid without a chunk, but at least a warp's 128 (or 4 rows);
  block c takes chunks c, c + grid, ...; thread t draws the 4
  consecutive elements from 4t (then 4t + 1,024, ...) and stores them as
  one 16-byte key vector and one 4-byte flag word where all 4 lie in the
  chunk, element by element in the chunk's ragged tail.  At 1 draw a
  chunk holds a block's 256 draws (or 4 rows) and has a block of its
  own.  Every element is written exactly once, and every vector store
  starts on a flat index that is a multiple of 4.
* The per-txn write gate is hashed once a row (counter: the row), and a
  draw finds its row by one division a thread and a running (row, pos).
* HOT's remainders by a runtime span are multiply-highs by a magic
  number the host computes (``sampling.magic_mod``): exact for every
  uint32 x and span in [1, 2^32).
* key_order places each key at its rank inside its row (keys below it,
  or equal and earlier), which is ``torch.sort``'s order of values.
"""

import numpy as np
import pytest
import torch

from deneva_tpu_torch.config import Config
from deneva_tpu_torch.ops import prng
from deneva_tpu_torch.ops.sampling import HotSet, magic_mod, randint_consts
from deneva_tpu_torch.workloads.ycsb import YCSBWorkload

THREADS = 256               # the kernel's kGenThreads


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain generator runs many small torch ops: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draws_a_thread(n, req, fit):
    """``launch_generate``'s choice: 4 draws a thread where the draws at 4
    a thread fill at least half of the 4-draw variant's resident threads
    (``fit`` blocks of 256), else 1."""
    return 4 if n * req >= 2 * fit * THREADS else 1


def chunk_layout(n, req, fit, per):
    """(rows a chunk, chunks, grid) as ``launch_chunks`` sizes them at
    ``per`` draws a thread."""
    full = max(1, THREADS * per // (4 * req))
    if per == 1:
        rows = 4 * full
        chunks = -(-n // rows)
        return rows, chunks, max(1, chunks)
    rows = 4 * min(full, max(-(-n // (4 * fit)), -(-(8 * per) // req)))
    chunks = -(-n // rows)
    return rows, chunks, max(1, min(fit, chunks))


def thread_map(n, req, fit, per=None):
    """The stores of one launch (at the host's draws a thread unless
    ``per`` is given): (times each element is written, flat starts of the
    vector stores, the rows each element's gate is read from)."""
    per = per or draws_a_thread(n, req, fit)
    span = THREADS * per
    rows_c, chunks, grid = chunk_layout(n, req, fit, per)
    writes = np.zeros(n * req, dtype=np.int64)
    vec_starts, gate_row = [], np.full(n * req, -1, dtype=np.int64)
    for blk in range(grid):
        for c in range(blk, chunks, grid):
            r0 = c * rows_c
            rows = min(rows_c, n - r0)
            ne, base = rows * req, r0 * req
            for e0 in (e for t in range(THREADS)
                       for e in range(per * t, ne, span)):
                # one division a thread, then a running (row, pos)
                row, pos = e0 // req, e0 % req
                for u in range(per):
                    if e0 + u < ne:
                        gate_row[base + e0 + u] = r0 + row
                    pos += 1
                    if pos == req:
                        pos, row = 0, row + 1
                if per == 4 and e0 + per <= ne:
                    vec_starts.append(base + e0)
                    writes[base + e0: base + e0 + per] += 1
                else:
                    writes[base + e0: base + min(ne, e0 + per)] += 1
    return writes, np.array(vec_starts, dtype=np.int64), gate_row


@pytest.mark.parametrize("n,req,fit", [
    (1, 1, 660), (1, 10, 660), (3, 10, 660), (7, 64, 4), (13, 65, 4),
    (2048, 10, 660), (65536, 10, 660), (1001, 7, 3), (5, 300, 2),
    (4099, 1, 5), (11, 33, 660)])
def test_thread_map_writes_every_element_once(n, req, fit):
    _check_map(n, req, fit, draws_a_thread(n, req, fit))


def _check_map(n, req, fit, per):
    writes, starts, gate_row = thread_map(n, req, fit, per)
    assert (writes == 1).all()
    assert (starts % 4 == 0).all()
    assert (gate_row == np.arange(n * req) // req).all()
    span = THREADS * per
    rows_c, chunks, grid = chunk_layout(n, req, fit, per)
    assert rows_c % 4 == 0 and (rows_c * req <= span or rows_c == 4)
    if req <= 64:
        # key_order's rows fit a block's shared keys
        assert rows_c * req <= span
    # chunks are full, or a warp's draws, or fill at least half the grid
    full = 4 * max(1, span // (4 * req))
    assert rows_c in (full, min(full, 4 * -(-(8 * per) // req))) or \
        2 * chunks >= fit
    if per == 1:
        # a block a chunk
        assert rows_c == full and grid == max(1, chunks)


@pytest.mark.parametrize("per", [1, 4])
@pytest.mark.parametrize("n,req,fit", [
    (1, 1, 660), (3, 10, 660), (7, 64, 4), (13, 65, 4), (2048, 10, 660),
    (1001, 7, 3), (5, 300, 2), (11, 33, 660)])
def test_thread_map_at_either_draw_count(n, req, fit, per):
    """Both variants' maps, whichever the host picks at these sizes."""
    _check_map(n, req, fit, per)


def test_draws_a_thread_on_the_paths():
    """4 draws a thread on the main path's 65,536 x 10, 1 on a sweep
    epoch's 2,048 x 10 (fit: 660 blocks, 5 of 256 threads on 132 SMs);
    the switch at half the resident threads, 337,920 draws."""
    assert draws_a_thread(65536, 10, 660) == 4
    assert draws_a_thread(2048, 10, 660) == 1
    assert draws_a_thread(32768, 10, 660) == 1
    assert draws_a_thread(33792, 10, 660) == 4


def _gen_cfg(*flags):
    return Config.from_args(["--synth_table_size=1000003",
                             "--epoch_batch=512", "--max_txn_in_flight=512"]
                            + list(flags))


@pytest.mark.parametrize("flags", [
    ["--txn_write_perc=0.25"],
    ["--skew_method=HOT", "--data_perc=100", "--access_perc=0.9",
     "--txn_write_perc=0.5", "--req_per_query=7", "--max_accesses=7"]])
def test_row_gate_hashed_once_a_row_matches_plain(flags):
    cfg = _gen_cfg(*flags)
    wl = YCSBWorkload(cfg, device="cpu")
    key = prng.key_from_seed(4, "cpu")
    n, req = 333, wl.n_req
    plain = wl.generate_plain(key, n)
    _, k2, k3 = prng.split_plain(key, 3)
    w = prng.bernoulli(k2, cfg.write_perc, (n, req)).reshape(-1).numpy()
    gate = prng.bernoulli(k3, cfg.txn_write_perc, (n,)).numpy()
    _, _, gate_row = thread_map(n, req, 660)
    got = w & gate[gate_row]
    assert np.array_equal(got.reshape(n, req), plain.is_write.numpy())


def fastmod(x, magic, d):
    """``dt_fastmod``: the top word of ((magic * x) mod 2^64) * d, in
    uint64 pieces (numpy wraps the first product as the kernel does)."""
    x = np.asarray(x, dtype=np.uint64)
    low = np.uint64(magic) * x
    hi, lo = low >> np.uint64(32), low & np.uint64(0xFFFFFFFF)
    d = np.uint64(d)
    return (hi * d + ((lo * d) >> np.uint64(32))) >> np.uint64(32)


# every span the experiments' HOT cells give K4b: (hot_max, rows)
HOT_CELLS = [(100, 1 << 24), (100, 1 << 26), (70000, 1000003),
             (100, 1000003), (16, 4096), (100, 4096)]


def _spans():
    spans = {1, 2, 3, 7, 1 << 16, (1 << 16) + 1, (1 << 31) - 1, 1 << 30}
    for hot, rows in HOT_CELLS:
        spans |= {hot, rows - hot}
    rng = np.random.default_rng(0)
    spans |= set(int(s) for s in rng.integers(1, 1 << 31, 64))
    return sorted(spans)


@pytest.mark.parametrize("d", _spans())
def test_magic_modulo_is_exact(d):
    rng = np.random.default_rng(d)
    top = (1 << 32) - 1
    mults = np.unique(np.concatenate([
        np.arange(0, min(top // d, 4096) + 1),
        rng.integers(0, top // d + 1, 512)]))
    x = np.concatenate([
        np.array([0, d - 1, top, top - 1, d, d + 1, top - top % d]),
        mults * d, np.minimum(mults * d + d - 1, top),
        rng.integers(0, 1 << 32, 4096)]).astype(np.int64).astype(np.uint64)
    x = x[x <= top]
    want = x % np.uint64(d)
    assert np.array_equal(fastmod(x, magic_mod(d), d), want)


@pytest.mark.parametrize("hot,rows", HOT_CELLS)
def test_hot_keys_by_magic_match_plain(hot, rows):
    """HOT's keys as the kernel folds them (the range picked first, one
    randint from its keys, remainders by magic) equal the plain
    ``HotSet.sample`` bit for bit."""
    key = prng.key_from_seed(hot + rows, "cpu")
    shape = (4096,)
    plain = HotSet(rows, hot, 0.9).sample(key, shape).numpy()
    h1, h2, h3 = prng.split_plain(key, 3)
    is_hot = prng.bernoulli(h1, 0.9, shape).numpy()
    out = np.empty(shape, dtype=np.int64)
    for sel, k, lo, hi in ((is_hot, h2, 0, hot), (~is_hot, h3, hot, rows)):
        ka, kb = prng.split_plain(k, 2)
        higher = prng.random_bits(ka, shape).numpy().astype(np.uint64)
        lower = prng.random_bits(kb, shape).numpy().astype(np.uint64)
        span, mult, magic = randint_consts(lo, hi)
        t = (fastmod(higher, magic, span) * np.uint64(mult)
             + fastmod(lower, magic, span)) & np.uint64(0xFFFFFFFF)
        out[sel] = (lo + fastmod(t, magic, span))[sel].astype(np.int64)
    assert np.array_equal(out, plain)


def rank_place(keys):
    """key_order in the launch: each key to its rank inside its row."""
    n, req = keys.shape
    out = np.empty_like(keys)
    for r in range(n):
        row = keys[r]
        for pos, x in enumerate(row):
            below = int((row < x).sum() + (row[:pos] == x).sum())
            out[r, below] = x
    return out


@pytest.mark.parametrize("req", [1, 2, 10, 33, 64])
def test_row_sort_by_rank_matches_torch_sort(req):
    rng = np.random.default_rng(req)
    n = -(-4 * THREADS // req)     # a block's largest chunk
    # duplicates inside rows, the extremes of int32
    keys = rng.integers(0, max(2, req // 2), (n, req)).astype(np.int32)
    keys[0, 0] = np.iinfo(np.int32).max
    keys[-1, -1] = 0
    want = torch.sort(torch.from_numpy(keys), dim=1).values.numpy()
    assert np.array_equal(rank_place(keys), want)
