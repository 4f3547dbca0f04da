"""Port parity of ``mode=SIMPLE`` and ``mode=QRY_ONLY``: ``deneva_tpu_torch``
against ``deneva_tpu`` on the CPU, exactly.

Under both modes the reference never forwards, validates through the
backend (CALVIN and TPU_BATCH through `validate_calvin`'s wavefront
levels, K9a) and executes nothing; counters, the pool update and the
defer budget run as under NORMAL (``deneva_tpu/engine/step.py:245-365``).
Whole epochs through `run_epochs` of test_torch_timestamp.py: two
reference epochs, then five in each package from the carried state,
every leaf compared; the table must equal the carried one and the write
and checksum counters must not move.
"""

import numpy as np
import pytest
from test_torch_timestamp import BASE, run_epochs

from deneva_tpu_torch.workloads.ycsb import TABLE

CASES = [(alg, mode) for mode in ("SIMPLE", "QRY_ONLY")
         for alg in ("TPU_BATCH", "CALVIN", "OCC")]


@pytest.mark.parametrize("alg,mode", CASES + [("MAAT", "SIMPLE"),
                                              ("NOCC", "QRY_ONLY")])
def test_mode_epochs_match_reference_and_leave_the_table(alg, mode):
    ts, _, mid = run_epochs(BASE + [f"--cc_alg={alg}", f"--mode={mode}"])
    cap = ts.db[TABLE].capacity
    np.testing.assert_array_equal(
        ts.db[TABLE].columns["F0"][:cap].numpy().view(np.uint32),
        np.asarray(mid.db[TABLE].columns["F0"])[:cap])
    for k in ("write_cnt", "read_checksum"):
        assert int(ts.stats[k]) == int(np.asarray(mid.stats[k])), k
    assert int(ts.stats["total_txn_commit_cnt"]) > int(
        np.asarray(mid.stats["total_txn_commit_cnt"]))


@pytest.mark.parametrize("subrounds", [1, 8])
def test_calvin_levels_defer_under_qry_only(subrounds):
    """The level budget defers the chains deeper than it; nothing
    aborts."""
    ts, _, _ = run_epochs(BASE + ["--cc_alg=TPU_BATCH", "--mode=QRY_ONLY",
                                  f"--exec_subrounds={subrounds}"])
    assert int(ts.stats["total_txn_abort_cnt"]) == 0
    assert int(ts.stats["defer_cnt"]) > 0
