"""Port parity of the ordered index (``index_struct=IDX_BTREE``):
`SortedIndex` against ``deneva_tpu.storage.index.SortedIndex`` on the
CPU, exactly, and YCSB epochs on it; and of TPC-C's `HashIndex`.

* ``lookup`` (the plain version of K14b): hits, misses, duplicate keys
  (the first entry wins) and the empty index, beside
  ``tests/test_storage.py:113,121,144``; the reference's arrays carried
  into the port by ``convert.index_from_reference`` probe the same.
* Epochs under IDX_BTREE equal the reference's leaf by leaf, and equal
  the port's own IDX_HASH epochs (same key -> slot map), beside
  ``tests/test_engine.py:324``.
* `HashIndex.build` gives the reference's arrays (``keys``, ``slots``,
  ``cap``, ``max_probe``) on dense, irregular and clustered key sets;
  ``lookup`` (the plain version of K14a) equals the reference's on hits,
  misses, and keys whose probe runs longer than ``max_probe``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_occ import _assert_same

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.storage.index import HashIndex as JHash
from deneva_tpu.storage.index import SortedIndex as JSorted
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.storage.index import DenseIndex, HashIndex, SortedIndex
from deneva_tpu_torch.workloads import get_workload


def _both(keys, slots, miss, q):
    keys = np.asarray(keys, np.int32)
    slots = np.asarray(slots, np.int32)
    q = np.asarray(q, np.int32)
    ref = JSorted.build(keys, slots, miss_slot=miss)
    want = np.asarray(ref.lookup(jnp.asarray(q)))
    mine = SortedIndex.build(keys, slots, miss_slot=miss)
    got = mine.lookup(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    carried = convert.index_from_reference(jax.device_get(ref), "cpu")
    np.testing.assert_array_equal(
        carried.lookup(torch.from_numpy(q)).numpy(), want)
    return got


def test_sorted_lookup_hits_and_misses():
    got = _both([40, 10, 30, 20], [4, 1, 3, 2], 99, [10, 20, 30, 40, 25, 5,
                                                    50])
    np.testing.assert_array_equal(got, [1, 2, 3, 4, 99, 99, 99])


def test_sorted_lookup_duplicates_take_the_first_entry():
    got = _both([7, 7, 7, 9], [0, 1, 2, 3], -1, [7, 9, 8])
    np.testing.assert_array_equal(got, [0, 3, -1])


def test_sorted_lookup_empty_index_misses():
    got = _both([], [], 99, [[1, 2], [3, -4]])
    np.testing.assert_array_equal(got, [[99, 99], [99, 99]])


@pytest.mark.parametrize("n,span", [(1, 3), (50, 20), (5000, 100000),
                                    (4096, 4096)])
def test_sorted_lookup_random_matches_reference(n, span):
    rng = np.random.default_rng(n)
    keys = rng.integers(-span, span, n)
    slots = rng.permutation(n)
    q = rng.integers(-span - 3, span + 3, (64, 10))
    q[0, :3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, keys[0]]
    _both(keys, slots, n, q)


def test_dense_index_carried_from_reference():
    jwl = j_workload(JConfig.from_args(["--synth_table_size=1000"]))
    idx = convert.index_from_reference(jwl.index, "cpu")
    assert isinstance(idx, DenseIndex) and idx.miss_slot == 1000


def _epochs(args, epochs=5):
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    js = jeng.init_state()
    ts = convert.from_reference_state(jax.device_get(js), tcfg, "cpu")
    js, ts = jeng.jit_run(js, epochs), teng.run(ts, epochs)
    _assert_same(js, ts, tcfg.synth_table_size)
    return teng, ts


@pytest.mark.parametrize("alg,pool", [("TPU_BATCH", 256), ("OCC", 1024),
                                      ("MAAT", 1024)])
def test_btree_epochs_match_reference_and_hash(alg, pool):
    base = ["--epoch_batch=256", f"--max_txn_in_flight={pool}",
            "--synth_table_size=4096", "--conflict_buckets=1024",
            "--zipf_theta=0", f"--cc_alg={alg}", "--seed=4"]
    teng, tb = _epochs(base + ["--index_struct=IDX_BTREE"])
    assert isinstance(teng.workload.index, SortedIndex)
    ref_idx = j_workload(JConfig.from_args(
        base + ["--index_struct=IDX_BTREE"])).index
    np.testing.assert_array_equal(teng.workload.index.keys.numpy(),
                                  np.asarray(ref_idx.keys))
    np.testing.assert_array_equal(teng.workload.index.slots.numpy(),
                                  np.asarray(ref_idx.slots))
    _, th = _epochs(base + ["--index_struct=IDX_HASH"])
    for k in ("total_txn_commit_cnt", "total_txn_abort_cnt",
              "read_checksum", "write_cnt"):
        assert int(tb.stats[k]) == int(th.stats[k]), k
    assert torch.equal(tb.db["MAIN_TABLE"].columns["F0"],
                       th.db["MAIN_TABLE"].columns["F0"])


def _hash_sets():
    rng = np.random.default_rng(21)
    dense = np.arange(5000, dtype=np.int32)
    irregular = rng.choice(2**31 - 1, 3000, replace=False).astype(np.int32)
    # keys whose home buckets collide: multiples of a large power of two
    # share low bits before the avalanche, and a burst of neighbours
    clustered = np.unique(np.concatenate([
        np.arange(0, 1 << 20, 1 << 12),
        np.arange(77777, 77777 + 700)])).astype(np.int32)
    return {"dense": dense, "irregular": irregular, "clustered": clustered}


@pytest.mark.parametrize("kind", ["dense", "irregular", "clustered"])
def test_hash_index_build_and_lookup_match_reference(kind):
    keys = _hash_sets()[kind]
    rng = np.random.default_rng(len(keys))
    slots = rng.integers(0, 2**30, len(keys)).astype(np.int32)
    ref = jax.device_get(JHash.build(keys, slots, miss_slot=-7))
    mine = HashIndex.build(keys, slots, miss_slot=-7)
    np.testing.assert_array_equal(mine.keys.numpy(), np.asarray(ref.keys))
    np.testing.assert_array_equal(mine.slots.numpy(), np.asarray(ref.slots))
    assert (mine.cap, mine.max_probe, mine.miss_slot) == (
        ref.cap, ref.max_probe, ref.miss_slot)
    absent = rng.integers(0, 2**31 - 1, 4000).astype(np.int32)
    absent = absent[~np.isin(absent, keys)]
    q = np.concatenate([keys, absent, keys[::-3]])
    want = np.asarray(ref.lookup(jnp.asarray(q)))
    got = mine.lookup(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:len(keys)] == slots).all()
    assert (got[len(keys):len(keys) + len(absent)] == -7).all()


def test_hash_lookup_stops_at_max_probe():
    """A probe that meets neither its key nor an empty cell within
    ``max_probe`` cells misses, in both packages: here key 3 sits five
    cells past its home, beyond a depth of 2."""
    from deneva_tpu.storage.index import _hash_np
    cap = 8
    tab_k = np.full(cap, -1, np.int32)
    tab_s = np.zeros(cap, np.int32)
    home = int(_hash_np(np.array([3], np.int32), cap)[0])
    fill = [k for k in range(100, 400) if
            int(_hash_np(np.array([k], np.int32), cap)[0]) == home][:4]
    for j, k in enumerate(fill + [3]):
        tab_k[(home + j) % cap] = k
        tab_s[(home + j) % cap] = 50 + j
    q = np.array([3] + fill + [999], np.int32)
    for depth in (2, 8):
        ref = JHash(keys=jnp.asarray(tab_k), slots=jnp.asarray(tab_s),
                    cap=cap, max_probe=depth, miss_slot=-1)
        mine = HashIndex(keys=torch.from_numpy(tab_k),
                         slots=torch.from_numpy(tab_s), cap=cap,
                         max_probe=depth, miss_slot=-1)
        want = np.asarray(ref.lookup(jnp.asarray(q)))
        np.testing.assert_array_equal(
            mine.lookup(torch.from_numpy(q)).numpy(), want)
        assert (want[0] == -1) == (depth == 2)
