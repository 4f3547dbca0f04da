"""Port parity of MAAT, the level sweeps and CALVIN's validation:
``deneva_tpu_torch`` against ``deneva_tpu`` on the CPU, exactly.

* The reference's MAAT unit cases (``tests/test_cc.py:323-382``) through
  both packages: verdicts and ``order`` equal, and the reference's own
  assertions on the port's verdict.
* ``wavefront_levels`` and ``precedence_levels`` (K9a, K9b) on seeded
  random digraphs with and without cycles, at 1, 3 and 24 rounds, beside
  the reference's case of ``tests/test_ops.py:173``.
* ``validate_calvin`` on chains deeper than ``exec_subrounds``.
* The closure and peel (K11a, K11b) through `validate_maat` on scripted
  cycles, and whole MAAT epochs leaf by leaf: two reference epochs, then
  five in each package from the carried state (`run_epochs` of
  test_torch_timestamp.py: 4096 rows, a partial pool of 256, B = 64,
  256 buckets, theta-0.9 queries from one numpy bank), with the closure
  branch taken in some epochs and the fast branch in others.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_timestamp import BASE, Both, run_epochs

from deneva_tpu.ops import precedence_levels as j_precedence_levels
from deneva_tpu.ops import wavefront_levels as j_wavefront_levels
from deneva_tpu_torch.cc import maat
from deneva_tpu_torch.ops import conflict


def _verdict(v):
    return v["commit"], v["abort"], v["defer"]


# -- the reference's MAAT unit cases (tests/test_cc.py:323-382) --------------

def test_maat_reader_writer_any_rank_commit():
    v = Both("MAAT").run([[(5, "w")], [(5, "r")]])
    c, a, d = _verdict(v)
    assert c[:2].all()
    assert v["order"][1] < v["order"][0]


def test_maat_write_skew_cycle_aborts():
    v = Both("MAAT").run([[(1, "r"), (2, "w")], [(2, "r"), (1, "w")]])
    c, a, d = _verdict(v)
    assert a[:2].any() and not c[:2].all()


def test_maat_blind_ww_both_commit():
    v = Both("MAAT").run([[(5, "w")], [(5, "w")], [(5, "r")]])
    assert v["commit"][:3].all()


def test_maat_hot_key_rmw_clique_commits_winner():
    m = 12
    v = Both("MAAT").run([[(7, "rw")] for _ in range(m)])
    c, a, d = _verdict(v)
    assert c[0] and c.sum() == 1
    assert a.sum() == m - 1 and d.sum() == 0


def test_maat_deep_acyclic_chain_commits_wholesale():
    n = 16
    txns = [[(0, "r")]] + [[(i, "r"), (i - 1, "w")] for i in range(1, n)]
    v = Both("MAAT", sweep_rounds=4).run(txns)
    c, a, d = _verdict(v)
    assert a.sum() == 0 and d.sum() == 0 and c.all()


def test_maat_cycle_peels_youngest_rest_commit():
    txns = [[(10, "r"), (11, "w")], [(11, "r"), (12, "w")],
            [(12, "r"), (10, "w")]]
    v = Both("MAAT").run(txns)
    c, a, d = _verdict(v)
    assert a.sum() == 1 and a[2]
    assert c[0] and c[1] and d.sum() == 0


@pytest.mark.parametrize("peel_rounds,rank", [
    (16, None), (1, None), (0, None), (16, [3, 0, 2, 1, 3, 0])])
def test_maat_overlapping_cycles_peel_like_reference(peel_rounds, rank):
    """Two 3-cycles sharing a txn, and a chain hanging off them: the
    peel's rounds, its youngest-member rule under tied ranks and its
    leftovers (deferred by the second closure) match the reference."""
    txns = [[(1, "r"), (2, "w")], [(2, "r"), (3, "w")],
            [(3, "r"), (1, "w"), (4, "w")], [(4, "r"), (5, "w")],
            [(5, "r"), (3, "w")], [(3, "r"), (9, "w")]]
    v = Both("MAAT", maat_peel_rounds=peel_rounds).run(txns, rank=rank)
    c, a, d = _verdict(v)
    assert (c | a | d)[:6].all()
    if peel_rounds == 0:
        assert d[:5].any() and not a.any()


# -- K9: the level sweeps ----------------------------------------------------

def test_precedence_levels_cycle_detection():
    """``tests/test_ops.py:173`` through both packages."""
    b = 8
    p = np.zeros((b, b), bool)
    p[0, 1] = p[1, 2] = True
    p[3, 4] = p[4, 3] = True
    p[4, 5] = True
    active = np.ones(b, bool)
    lv, un = conflict.precedence_levels(torch.from_numpy(p),
                                        torch.from_numpy(active), 16)
    jlv, jun = j_precedence_levels(jnp.asarray(p), jnp.asarray(active), 16)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(un.numpy(), np.asarray(jun))
    assert un[[3, 4, 5]].all() and not un[[0, 1, 2, 6, 7]].any()


def _digraph(b, seed, density, cycles):
    rng = np.random.default_rng(seed)
    p = rng.random((b, b)) < density
    np.fill_diagonal(p, False)
    if not cycles:
        p = np.triu(p)
    return p, rng.random(b) < 0.8, rng.integers(0, 6, b).astype(np.int32)


@pytest.mark.parametrize("rounds", [1, 3, 24])
@pytest.mark.parametrize("cycles", [False, True])
@pytest.mark.parametrize("b,density", [(16, 0.2), (64, 0.05), (200, 0.01)])
def test_level_sweeps_match_reference(rounds, cycles, b, density):
    p, active, rank = _digraph(b, b + rounds, density, cycles)
    lv, un = conflict.precedence_levels(torch.from_numpy(p),
                                        torch.from_numpy(active), rounds)
    jlv, jun = j_precedence_levels(jnp.asarray(p), jnp.asarray(active),
                                   rounds)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(un.numpy(), np.asarray(jun))
    e = conflict.earlier_edges(torch.from_numpy(p | p.T),
                               torch.from_numpy(rank),
                               torch.from_numpy(active))
    lv, over = conflict.wavefront_levels(e, rounds)
    jlv, jover = j_wavefront_levels(jnp.asarray(e.numpy()), rounds)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))
    # K9a's function: the earlier edges of p | p.T built inside it
    lv, over = conflict.wavefront(torch.from_numpy(p), torch.from_numpy(rank),
                                  torch.from_numpy(active), rounds)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))


# -- CALVIN's validation -------------------------------------------------------

@pytest.mark.parametrize("alg", ["CALVIN", "TPU_BATCH"])
@pytest.mark.parametrize("subrounds", [1, 2, 4])
def test_validate_calvin_defers_chains_past_subrounds(alg, subrounds):
    # a 6-deep RMW chain on key 5, a 2-deep read-then-write on key 9, and
    # a loner: levels 0..5, 0..1 and 0; the deep tail defers
    txns = [[(5, "rw")] for _ in range(6)] + [[(9, "r")], [(9, "w")],
                                              [(3, "r")]]
    v = Both(alg, exec_subrounds=subrounds).run(txns)
    c, a, d = _verdict(v)
    assert not a.any()
    assert c[:6].sum() == subrounds and d[:6].sum() == 6 - subrounds
    assert v["level"][:subrounds].tolist() == list(range(subrounds))
    assert c[8]


# -- whole epochs --------------------------------------------------------------

def _count_branches(monkeypatch):
    """Per K11a call (two per epoch): whether the gate was set."""
    seen = []
    real = maat.reach_stats

    def counted(p, live, gate, *args, **kwargs):
        seen.append(bool(gate.any()))
        return real(p, live, gate, *args, **kwargs)
    monkeypatch.setattr(maat, "reach_stats", counted)
    return seen


@pytest.mark.parametrize("write_perc,full,abort_mode", [
    (0.1, False, False), (0.5, False, False), (0.1, True, False),
    (0.5, False, True)])
def test_maat_epochs_match_reference(monkeypatch, write_perc, full,
                                     abort_mode):
    seen = _count_branches(monkeypatch)
    ts, _, _ = run_epochs(BASE + ["--cc_alg=MAAT", f"--sim_full_row={full}",
                                  f"--ycsb_abort_mode={abort_mode}"],
                          write_perc=write_perc)
    closure = seen[::2]                 # two reach_stats calls per epoch
    assert len(closure) == 5
    if write_perc == 0.1:
        assert any(closure) and not all(closure)
    else:
        assert all(closure)
    assert int(ts.stats["total_txn_commit_cnt"]) > 0
    assert int(ts.stats["total_txn_abort_cnt"]) > 0


def test_maat_epochs_match_reference_with_leftovers():
    """Few peel rounds and a short sweep leave cycles to the second
    closure, which defers them (and the defer budget later aborts)."""
    ts, _, _ = run_epochs(BASE + ["--cc_alg=MAAT", "--maat_peel_rounds=1",
                                  "--sweep_rounds=3"])
    assert int(ts.stats["defer_cnt"]) > 0
