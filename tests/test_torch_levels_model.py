"""K9b's cluster kernel as a numpy model on the CPU, against the plain
level sweep and ``deneva_tpu``'s ``precedence_levels``.

``csrc/levels.cu`` ``precedence_kernel`` runs the rounds in a cluster of
C CTAs.  The model keeps the state the kernel keeps and follows its rules
(not its threads):

* CTA c owns the words [c own, (c + 1) own) of the B-bit sets (32 txns a
  word) and packs its txns' predecessor rows from P's column strip: row
  j's bit i = P[i, j] & active[i].  Where the rows live (shared memory
  or L2) changes no value, so the model has no regime.
* While packing, each CTA marks F_1 (active j with an active
  predecessor) and a witness a txn (the lowest such predecessor, as its
  atomicMin keeps); the rounds start at F_1.
* A round: each CTA keeps an owned member of F_r whose witness is still
  in F_r, lists the others and scans each listed row for a member of F_r
  (its new witness; the kernel keeps whichever its team finds, the model
  the lowest or a random one); it writes its words of F_{r + 1} and their
  count, and an exchange copies both into every CTA's replica.
* Every CTA decides from its own replica: |F| = 0, |F| unchanged (a
  fixpoint, the rounds left credited at once) or ``rounds`` reached.  The
  model checks that all CTAs take the same exit in the same round.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.ops import precedence_levels as j_precedence_levels
from deneva_tpu_torch.ops import conflict

LOW_BIT = np.array([(v & -v).bit_length() - 1 if v else 8
                    for v in range(256)], dtype=np.int64)


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain sweep runs many small torch ops: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _first_hits(packed_rows, cur_packed, pick, rng):
    """For each packed row (txns as little-endian bits): a member of the
    packed set it meets, the lowest or a random one; -1 where none."""
    hit = packed_rows & cur_packed[None, :]
    nz = hit != 0
    out = np.full(hit.shape[0], -1, dtype=np.int64)
    rows = np.flatnonzero(nz.any(axis=1))
    if pick == "lowest":
        byte = nz[rows].argmax(axis=1)
        out[rows] = byte * 8 + LOW_BIT[hit[rows, byte]]
    else:
        for r in rows:
            idx = np.flatnonzero(np.unpackbits(hit[r], bitorder="little"))
            out[r] = rng.choice(idx)
    return out


def cluster_levels(p, active, rounds, ctas, pick="lowest", seed=0):
    """The kernel's levels on numpy sets: (lv int32[B], unstable bool[B],
    rounds that exchanged)."""
    b = active.shape[0]
    words = -(-b // 32)
    own = -(-words // ctas)
    if rounds == 0:
        return np.zeros(b, np.int32), active.copy(), 0
    rng = np.random.default_rng(seed)
    # row j (predecessors of j): P[:, j] & active, packed over i
    pred = (p & active[:, None]).T
    packed = np.packbits(pred, axis=1, bitorder="little")
    owned = [np.arange(min(b, 32 * c * own), min(b, 32 * (c + 1) * own))
             for c in range(ctas)]
    wit = np.full(b, -1, dtype=np.int64)
    replicas = [active.copy() for _ in range(ctas)]
    n = int(active.sum())
    lv = np.zeros(b, np.int64)

    def exchange(own_words):
        """Each CTA's owned bits and count into every replica; the counts'
        sum every CTA sees."""
        counts = [int(f.sum()) for f in own_words]
        for rep in replicas:
            for js, f in zip(owned, own_words):
                rep[js] = f
        sums = {sum(counts) for _ in replicas}
        assert len(sums) == 1
        return sums.pop()

    # each CTA packs its column strip: F_1 and the lowest witness
    f1 = []
    for js in owned:
        strip = pred[js]
        has = strip.any(axis=1) & active[js]
        wit[js] = np.where(has, strip.argmax(axis=1), -1)
        f1.append(has)
    n_prev, n, r = n, exchange(f1), 1
    lv += replicas[0]
    while True:
        # every CTA decides from its own replica and the same counts
        ends = {(r >= rounds, n == 0, n == n_prev) for _ in replicas}
        assert len(ends) == 1
        done, empty, fixed = ends.pop()
        if done or empty:
            break
        if fixed:
            lv += (rounds - r) * replicas[0]
            break
        cur = replicas[0].copy()
        cur_packed = np.packbits(cur, bitorder="little")
        nxt = []
        for c, js in enumerate(owned):
            assert np.array_equal(replicas[c], cur)
            inf = cur[js]
            w = wit[js]
            keep = inf & (w >= 0) & cur[np.maximum(w, 0)]
            listed = js[inf & ~keep]
            f = _first_hits(packed[listed], cur_packed, pick, rng)
            wit[listed[f >= 0]] = f[f >= 0]
            mine = keep.copy()
            mine[np.searchsorted(js, listed[f >= 0])] = True
            nxt.append(mine)
        n_prev, n = n, exchange(nxt)
        r += 1
        lv += replicas[0]
    return lv.astype(np.int32), replicas[0].copy(), r


def _graph(kind, b, seed):
    """(P, active) of one kind: ``cycles`` (a sparse digraph with cycles
    and self-loops), ``dag`` (edges i -> j for i < j only), ``none`` (no
    active txn), ``all`` (every txn active, dense enough that most txns
    sit downstream of a cycle), ``chain`` (0 -> 1 -> ... -> B - 1, longer
    than the rounds, with some noise below it)."""
    rng = np.random.default_rng(seed)
    active = rng.random(b) < 0.85
    if kind == "chain":
        p = np.zeros((b, b), dtype=bool)
        idx = np.arange(b - 1)
        p[idx, idx + 1] = True
        p |= np.triu(rng.random((b, b)) < min(0.5, 1.0 / b), 2)
        return p, np.ones(b, dtype=bool)
    density = min(0.3, (3.0 if kind != "all" else 6.0) / b)
    p = rng.random((b, b)) < density
    if kind == "dag":
        p = np.triu(p, 1)
    else:
        np.fill_diagonal(p, rng.random(b) < 0.05)
    if kind == "none":
        active[:] = False
    if kind == "all":
        active[:] = True
    return p, active


KINDS = ("cycles", "dag", "none", "all", "chain")


@functools.lru_cache(maxsize=None)
def _jax_levels(rounds):
    return jax.jit(functools.partial(j_precedence_levels, rounds=rounds))


@pytest.mark.parametrize("rounds", [0, 1, 3, 24])
@pytest.mark.parametrize("b", [1, 31, 33, 100, 1024, 2048])
def test_cluster_model_matches_plain_and_reference(b, rounds):
    for kind in KINDS:
        p, active = _graph(kind, b, b * 31 + rounds)
        want = conflict.precedence_levels_plain(
            torch.from_numpy(p), torch.from_numpy(active), rounds)
        want = tuple(t.numpy() for t in want)
        jlv, jun = _jax_levels(rounds)(jnp.asarray(p), jnp.asarray(active))
        assert np.array_equal(np.asarray(jlv), want[0]), kind
        assert np.array_equal(np.asarray(jun), want[1]), kind
        for ctas in (1, 2, 4, 8, 16):
            lv, un, _ = cluster_levels(p, active, rounds, ctas)
            assert np.array_equal(lv, want[0]), (kind, ctas)
            assert np.array_equal(un, want[1]), (kind, ctas)


@pytest.mark.parametrize("ctas", [2, 8, 16])
@pytest.mark.parametrize("kind", ["cycles", "all", "chain"])
def test_cluster_model_any_witness(kind, ctas):
    """The kernel keeps whichever witness a team finds: any choice gives
    the plain levels."""
    b, rounds = 300, 24
    p, active = _graph(kind, b, 7)
    want = conflict.precedence_levels_plain(
        torch.from_numpy(p), torch.from_numpy(active), rounds)
    for seed in (ctas, ctas + 100):
        lv, un, _ = cluster_levels(p, active, rounds, ctas, pick="random",
                                   seed=seed)
        assert np.array_equal(lv, want[0].numpy())
        assert np.array_equal(un, want[1].numpy())


def test_cluster_model_rounds_start_at_f1_and_stop_at_fixpoint():
    """The rounds start one on (F_1 from the pack); a graph that reaches
    its fixpoint stops there, not at ``rounds``."""
    b = 64
    p = np.zeros((b, b), dtype=bool)
    p[np.arange(b), (np.arange(b) + 1) % b] = True     # one cycle
    active = np.ones(b, dtype=bool)
    lv, un, r = cluster_levels(p, active, 24, 2)
    assert r == 1 and lv.tolist() == [24] * b and un.all()
    chain = np.zeros((b, b), dtype=bool)
    chain[np.arange(b - 1), np.arange(1, b)] = True
    lv, un, r = cluster_levels(chain, active, 24, 4)
    assert r == 24 and lv.tolist() == [min(j, 24) for j in range(b)]
    assert un.tolist() == [j >= 24 for j in range(b)]
