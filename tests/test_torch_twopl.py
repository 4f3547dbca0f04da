"""Port parity of NO_WAIT and WAIT_DIE: ``deneva_tpu_torch`` against
``deneva_tpu`` on the CPU, exactly, at all four isolation levels.

Unit cases mirror the reference's (``tests/test_cc.py:108-135`` for 2PL,
``:443-494`` for the isolation levels) with the same scripted batches
through both packages (`Both`, from test_torch_timestamp.py).  Whole
epochs use `run_epochs` of test_torch_timestamp.py: two reference epochs,
then five in each package from the carried state, leaf by leaf.

Through the engine WAIT_DIE's ts never differs from its rank: a slot's
ts is its admission seq and WAIT_DIE keeps it across restarts, so an
epoch loser is always younger than the winner that blocked it and dies.
The wait branch shows in the unit cases, and in whole epochs started
from a carried state whose ts run against the seq order (both packages
start from that same state).
"""

import dataclasses

import numpy as np
import pytest
from test_torch_timestamp import BASE, Both, run_epochs

from deneva_tpu_torch.cc import get_backend, twopl

LEVELS = ["SERIALIZABLE", "READ_COMMITTED", "READ_UNCOMMITTED", "NOLOCK"]


def _capture_waits(monkeypatch, teng):
    """Count WAIT_DIE waits in the port's epochs: deferred txns that a
    committed earlier txn blocked (sweep leftovers have no such
    blocker)."""
    seen = {"waits": 0}
    be = teng.backend

    def capture(cfg, state, batch, inc):
        v, st = be.validate(cfg, state, batch, inc)
        e = twopl._lock_edges(cfg, batch, inc)
        if e is not None:
            blocked = (e & v.commit[None, :]).any(dim=1)
            seen["waits"] += int((v.defer & blocked).sum())
        return v, st
    monkeypatch.setattr(teng, "backend",
                        dataclasses.replace(be, validate=capture))
    return seen


@pytest.mark.parametrize("alg", ["NO_WAIT", "WAIT_DIE"])
@pytest.mark.parametrize("level", LEVELS)
def test_lock_epochs_match_reference(alg, level):
    ts, _, _ = run_epochs(BASE + [f"--cc_alg={alg}",
                                  f"--isolation_level={level}"])
    st = {k: int(v.sum()) for k, v in ts.stats.items()}
    assert st["total_txn_commit_cnt"] > 0
    if level == "NOLOCK":
        assert st["total_txn_abort_cnt"] == 0 and st["defer_cnt"] == 0
    else:
        # aborts, and restarted txns that later committed
        assert st["total_txn_abort_cnt"] > 0
        assert int(ts.stats["retry_hist"][1:].sum()) > 0


@pytest.mark.parametrize("alg,level", [("NO_WAIT", "SERIALIZABLE"),
                                       ("WAIT_DIE", "READ_COMMITTED"),
                                       ("WAIT_DIE", "NOLOCK")])
def test_lock_epochs_with_forced_aborts_match_reference(alg, level):
    ts, _, _ = run_epochs(BASE + [f"--cc_alg={alg}",
                                  f"--isolation_level={level}",
                                  "--ycsb_abort_mode=true"])
    assert int(ts.stats["total_txn_abort_cnt"]) > 0


def _reverse_ts(js):
    """Give the occupied slots their ts in reverse seq order."""
    pool = js.pool
    occ = np.asarray(pool.occupied)
    ts = np.array(pool.ts)
    order = np.argsort(np.asarray(pool.seq)[occ], kind="stable")
    vals = np.sort(ts[occ])[::-1]
    new = ts[occ]
    new[order] = vals
    ts[occ] = new
    return dataclasses.replace(js, pool=dataclasses.replace(pool, ts=ts))


@pytest.mark.parametrize("level", ["SERIALIZABLE", "READ_UNCOMMITTED"])
def test_wait_die_waits_match_reference(monkeypatch, level):
    box = {}

    def hook(teng):
        box["seen"] = _capture_waits(monkeypatch, teng)
    ts, _, _ = run_epochs(BASE + ["--cc_alg=WAIT_DIE",
                                  f"--isolation_level={level}"],
                          perturb=_reverse_ts, hook=hook)
    assert box["seen"]["waits"] > 0
    assert int(ts.stats["total_txn_abort_cnt"]) > 0


# -- unit cases (tests/test_cc.py:108-135, :443-494) -------------------------

def test_no_wait_conflict_aborts_later():
    v = Both("NO_WAIT").run([[(5, "w")], [(5, "r")], [(7, "r")]])
    assert v["commit"][0] and v["abort"][1] and v["commit"][2]


def test_no_wait_read_read_no_conflict():
    assert Both("NO_WAIT").run([[(5, "r")], [(5, "r")]])["commit"][:2].all()


def test_no_wait_rank_decides():
    v = Both("NO_WAIT").run([[(5, "w")], [(5, "w")]], rank=[9, 2])
    assert v["abort"][0] and v["commit"][1]


def test_wait_die_older_waits_younger_dies():
    v = Both("WAIT_DIE").run([[(5, "w")], [(5, "w")], [(5, "w")]],
                             ts=[50, 10, 90], rank=[0, 1, 2])
    assert v["commit"][0] and v["defer"][1] and v["abort"][2]


def test_wait_die_equal_ts_dies():
    # "older than every owner" is strict: an equal ts dies
    v = Both("WAIT_DIE").run([[(5, "w")], [(5, "w")]], ts=[7, 7])
    assert v["commit"][0] and v["abort"][1]


def test_isolation_serializable_reader_blocks_writer():
    v = Both("NO_WAIT").run([[(5, "r")], [(5, "w")]])
    assert v["commit"][0] and v["abort"][1]


@pytest.mark.parametrize("level", ["READ_COMMITTED", "READ_UNCOMMITTED"])
def test_isolation_relaxed_reader_does_not_block_writer(level):
    v = Both("NO_WAIT", isolation_level=level).run([[(5, "r")], [(5, "w")]])
    assert v["commit"][:2].all()


def test_isolation_read_committed_reader_behind_writer_conflicts():
    v = Both("NO_WAIT", isolation_level="READ_COMMITTED").run(
        [[(5, "w")], [(5, "r")]])
    assert v["commit"][0] and v["abort"][1]


def test_isolation_read_uncommitted_only_ww_conflicts():
    v = Both("NO_WAIT", isolation_level="READ_UNCOMMITTED").run(
        [[(5, "w")], [(5, "r")], [(5, "w")]])
    assert v["commit"][0] and v["commit"][1] and v["abort"][2]


def test_isolation_nolock_commits_everything():
    v = Both("NO_WAIT", isolation_level="NOLOCK").run(
        [[(5, "w")], [(5, "w")], [(5, "rw")]])
    assert v["commit"][:3].all()


def test_isolation_wait_die_relaxed_wait_rule_still_applies():
    v = Both("WAIT_DIE", isolation_level="READ_UNCOMMITTED").run(
        [[(5, "w")], [(5, "w")]], ts=[2, 1])
    assert v["commit"][0] and v["defer"][1]


@pytest.mark.parametrize("alg", ["NO_WAIT", "WAIT_DIE"])
def test_isolation_monotone_commit_counts(alg):
    txns = [[(k % 3, "w" if i % 2 else "r")] for i, k in enumerate(range(8))]
    counts = [int(Both(alg, isolation_level=lvl).run(txns)["commit"].sum())
              for lvl in LEVELS]
    assert counts == sorted(counts)


@pytest.mark.parametrize("level", LEVELS)
def test_random_batches_match_reference(level):
    """Seeded random batches with rank and ts orders that disagree."""
    rng = np.random.default_rng(len(level))
    for alg in ("NO_WAIT", "WAIT_DIE"):
        be = Both(alg, isolation_level=level, conflict_buckets=64)
        for _ in range(3):
            txns = [[(int(rng.integers(0, 12)),
                      ("r", "w", "rw")[rng.integers(0, 3)])
                     for _ in range(rng.integers(1, 5))] for _ in range(16)]
            be.run(txns, ts=rng.permutation(16) + 1,
                   rank=rng.permutation(16))


def test_lock_views_follow_the_isolation_level():
    from deneva_tpu_torch.config import Config
    be = get_backend("NO_WAIT")
    got = {lvl: be.views(Config(isolation_level=lvl)) for lvl in LEVELS}
    assert got == {"SERIALIZABLE": ("uo", "w"),
                   "READ_COMMITTED": ("wo", "w", "pro"),
                   "READ_UNCOMMITTED": ("wo", "w"), "NOLOCK": ()}
    assert get_backend("WAIT_DIE").fresh_ts_on_restart is False
