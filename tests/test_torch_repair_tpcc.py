"""Port parity of whole TPC-C repair epochs: ``deneva_tpu_torch`` against
``deneva_tpu`` from the same carried state, leaf by leaf (every table's
rows ``[0, capacity)`` and ``row_cnt``, the pool, cc state, rng and every
counter).

TPC-C at ``tests/test_repair.py``'s ``tpcc_cfg`` shape (2 warehouses,
120 customers per district, 4,096 items, 5 items per txn, ``epoch_batch
=64`` over a pool of 256, escrow off) under OCC, NO_WAIT, TIMESTAMP and
MAAT with ``repair_rounds=2``, and OCC with the dynamic ORDER index (one
more K14e merge per executed round).  TPC-C's generation is exact, so
the queries are generated.  Every run checks that aborts equal
``rep_fallback_cnt`` (`run_both` of test_torch_repair_epochs.py).
"""

import pytest
from test_torch_order_index import assert_same_state_with_index
from test_torch_repair_epochs import run_both
from test_torch_tpcc import tpcc_args
from test_torch_tpcc_epochs import assert_same_state

TPCC_REPAIR = dict(max_items=4096, escrow_sweep=False, repair=True,
                   repair_rounds=2)


@pytest.mark.parametrize("alg", ["OCC", "NO_WAIT", "TIMESTAMP", "MAAT"])
def test_tpcc_repair_epochs_match_reference(alg):
    st = run_both(tpcc_args(cc_alg=alg, **TPCC_REPAIR),
                  check=assert_same_state)
    assert st["total_txn_commit_cnt"] > 0
    if alg != "TIMESTAMP":
        # T/O's losers here wait (defer) rather than abort
        assert st["rep_salvaged_cnt"] > 0, st


def test_tpcc_repair_epochs_with_order_index_match_reference():
    st = run_both(tpcc_args(cc_alg="OCC", tpcc_order_index=True,
                            **TPCC_REPAIR),
                  check=assert_same_state_with_index)
    assert st["rep_salvaged_cnt"] > 0
