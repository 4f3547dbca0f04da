"""K11b's cluster kernel as a numpy model on the CPU, against the plain
peel.

``csrc/maat.cu`` ``peel_kernel`` runs the peel in a cluster of C CTAs.
The model keeps the state the kernel keeps and follows its rules (not
its threads):

* CTA c owns the words [c own, (c + 1) own) of the B-bit sets (32 txns a
  word).  It decides only its own txns and writes only its words of the
  next frontiers and of the victims, with a flag (a frontier changed, a
  frontier is not empty, a candidate is left); an exchange hands the
  words to every CTA and ORs the flags, so every CTA takes the same
  exits.
* Each owned member keeps a witness a direction, across sweep rounds and
  peel rounds: where the witness is still in the frontier the member
  stays without a look at its row; else its row is scanned for a member
  of the frontier, one on a cycle first, which becomes the witness.
* Each owned candidate keeps a younger neighbour: where it is still a
  candidate the candidate is no victim; else its row and column are
  scanned for a younger candidate, and one without is a victim.
* A direction ends at no change, an empty frontier or the last round;
  a peel round's sweeps end when no candidate is left, and the peel when
  a round starts without one.

The kernel keeps whichever witness its warp finds; the model takes the
lowest or a random one (``pick``), and both must give ``peel_plain``'s
aborted set.  Its counts (peel rounds with candidates, sweep exchanges,
victims) must equal ``chip_smoke.peel_trace``'s.  The rows are K11a's,
packed over live0: the model masks P with live0 as they are.
"""

import numpy as np
import pytest
import torch

from chip_smoke import k11_graphs, peel_trace
from deneva_tpu_torch.cc import maat


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain peel and the trace run many small torch ops: one
    intra-op thread keeps them from contending with the other test
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _first(hits, pref, pick, rng):
    """A witness among ``hits``, one in ``pref`` first; -1 where none."""
    for s in (hits & pref, hits):
        idx = np.flatnonzero(s)
        if idx.size:
            return int(idx[0] if pick == "lowest" else rng.choice(idx))
    return -1


def cluster_peel(p, live0, on_cycle0, rank, rounds, peel_rounds, gate,
                 ctas, pick="lowest", seed=0):
    """The kernel's peel on numpy sets: returns (aborted, (peel rounds
    with candidates, sweep exchanges, victims), rows scanned)."""
    live0, oc, gate = (t.numpy() for t in (live0, on_cycle0, gate))
    rank = rank.numpy().astype(np.int64)
    b = live0.shape[0]
    words = -(-b // 32)
    own = -(-words // ctas)
    if not gate.any():
        return torch.zeros(b, dtype=torch.bool), (0, 0, 0), 0
    sub = p.numpy() & live0[:, None] & live0[None, :]
    rows = (sub.T, sub)       # d 0 sweeps P (P's columns), d 1 P^T (rows)
    lane = np.arange(b)
    owned = [lane[(lane // 32 >= c * own) & (lane // 32 < (c + 1) * own)]
             for c in range(ctas)]
    rng = np.random.default_rng(seed)
    wit = np.full((2, b), -1)          # a predecessor in F, a direction
    ywit = np.full(b, -1)              # a younger candidate neighbour
    ab = np.zeros(b, dtype=bool)
    n_peel = n_sweep = scans = 0
    for _ in range(peel_rounds):
        f0 = live0 & ~ab
        if not (f0 & oc).any():
            break
        cur, fin = [f0.copy(), f0.copy()], [f0.copy(), f0.copy()]
        act = [rounds > 0, rounds > 0]
        cand = True
        for r in range(rounds):
            if not (act[0] or act[1]):
                break
            nxt = [np.zeros(b, dtype=bool) if act[d] else fin[d]
                   for d in (0, 1)]
            every = 0
            for mine in owned:
                for d in (0, 1):
                    if not act[d]:
                        continue
                    for j in mine[cur[d][mine]]:
                        w = wit[d, j]
                        if w >= 0 and cur[d][w]:
                            nxt[d][j] = True
                            continue
                        scans += 1
                        f = _first(rows[d][j] & cur[d], oc, pick, rng)
                        if f >= 0:
                            wit[d, j] = f
                            nxt[d][j] = True
                flag = 0
                for d in (0, 1):
                    if act[d]:
                        flag |= int((nxt[d][mine] != cur[d][mine]).any()) \
                            << 2 * d
                        flag |= int(nxt[d][mine].any()) << 2 * d + 1
                flag |= int((nxt[0] & nxt[1] & oc)[mine].any()) << 4
                every |= flag               # the exchange
            n_sweep += 1
            cand = bool(every >> 4 & 1)
            for d in (0, 1):
                if act[d] and (not every >> 2 * d & 1
                               or not every >> 2 * d + 1 & 1
                               or r == rounds - 1):
                    fin[d], act[d] = nxt[d], False
            cur = [nxt[d] if act[d] else fin[d] for d in (0, 1)]
            if not cand:
                break
        if not cand:
            break
        uf = fin[0] & fin[1] & oc
        v = np.zeros(b, dtype=bool)
        for mine in owned:
            for j in mine[uf[mine]]:
                y = ywit[j]
                if y >= 0 and uf[y]:
                    continue
                scans += 1
                younger = (rank > rank[j]) | ((rank == rank[j]) & (lane > j))
                y = _first((sub[j] | sub[:, j]) & uf & younger, uf, pick,
                           rng)
                if y >= 0:
                    ywit[j] = y
                else:
                    v[j] = True
        n_peel += 1                         # the victims' exchange
        ab |= v
    return torch.from_numpy(ab), (n_peel, n_sweep, int(ab.sum())), scans


def _digraph(b, seed, density):
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(b, b, generator=g) < density / b
    p.fill_diagonal_(False)
    live = torch.rand(b, generator=g) < 0.85
    rank = torch.randint(0, max(b // 4, 1), (b,), generator=g,
                         dtype=torch.int32)
    return p, live, rank


def _check(p, live, rank, gate, rounds, peel_rounds, ctas, pick):
    oc, _ = maat.reach_stats(p, live, gate, False)
    got, counts, _ = cluster_peel(p, live, oc, rank, rounds, peel_rounds,
                                  gate, ctas, pick)
    assert torch.equal(got, maat.peel_plain(p, live, oc, rank, rounds,
                                            peel_rounds, gate))
    tr = peel_trace(p, live, oc, rank, rounds, peel_rounds, gate)
    assert counts == (sum(1 for r in tr if r["candidates"]),
                      sum(r["x"] for r in tr),
                      sum(r["victims"] for r in tr))


@pytest.mark.parametrize("b", [16, 100, 257])
@pytest.mark.parametrize("density", [1.5, 4.0])
@pytest.mark.parametrize("rounds,peel_rounds", [(0, 1), (1, 1), (24, 16),
                                                (3, 0)])
@pytest.mark.parametrize("ctas,pick", [(1, "lowest"), (2, "any"),
                                       (8, "lowest")])
def test_cluster_peel_matches_plain(b, density, rounds, peel_rounds, ctas,
                                    pick):
    p, live, rank = _digraph(b, b + int(density), density)
    _check(p, live, rank, live.clone(), rounds, peel_rounds, ctas, pick)


@pytest.mark.parametrize("graph", ["ring", "dag", "cycles23", "chain",
                                   "sparse_live", "empty_live", "gate_off"])
@pytest.mark.parametrize("ctas,pick", [(1, "any"), (4, "lowest"),
                                       (16, "any")])
def test_cluster_peel_structured_matches_plain(graph, ctas, pick):
    p, live, gate = k11_graphs(300, seed=3)[graph]
    rank = torch.arange(300, dtype=torch.int32) % 7       # tied ranks
    _check(p, live, rank, gate, 24, 16, ctas, pick)


def test_witnesses_spare_rows():
    """On a dense digraph whose live txns are nearly all on cycles, the
    witnesses found by a member's first scan hold through later sweep
    rounds and peel rounds: the model scans under a quarter of the rows
    that testing every member's row each round would read."""
    p, live, rank = _digraph(257, 5, 8.0)
    oc, _ = maat.reach_stats(p, live, live, False)
    _, (n_peel, n_sweep, _), scans = cluster_peel(p, live, oc, rank, 24, 16,
                                                  live, 4)
    every = n_sweep * 2 * int(live.sum()) + n_peel * int(oc.sum())
    assert n_peel == 16 and scans < every // 4
