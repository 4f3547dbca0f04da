"""Port parity of the ordered index (``index_struct=IDX_BTREE``):
`SortedIndex` against ``deneva_tpu.storage.index.SortedIndex`` on the
CPU, exactly, and YCSB epochs on it.

* ``lookup`` (the plain version of K14b): hits, misses, duplicate keys
  (the first entry wins) and the empty index, beside
  ``tests/test_storage.py:113,121,144``; the reference's arrays carried
  into the port by ``convert.index_from_reference`` probe the same.
* Epochs under IDX_BTREE equal the reference's leaf by leaf, and equal
  the port's own IDX_HASH epochs (same key -> slot map), beside
  ``tests/test_engine.py:324``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_occ import _assert_same

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.storage.index import SortedIndex as JSorted
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.storage.index import DenseIndex, SortedIndex
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
