"""Hashing, incidence, overlap and the first-fit sweep of ``deneva_tpu_torch``
against ``deneva_tpu`` on the CPU: the plain versions of K5+K6, K7 and K8
on the same numpy-seeded inputs, K8 also at the sweep backends' B =
2,048.  Every comparison is exact (bucket ids, bf16 count bits,
booleans).  A numpy model of K8's sweep as its cluster of CTAs runs it
(each CTA's rows and copy of the sets, round 0 from the rows' edge
counts, the per-round exchange of words) is held against the plain
version at 1, 2, 4 and 8 CTAs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.cc.base import AccessBatch as JBatch
from deneva_tpu.cc.base import build_incidence as j_build_incidence
from deneva_tpu.ops import conflict as jconflict
from deneva_tpu.ops import hashing as jhashing
from deneva_tpu_torch.cc.base import AccessBatch, build_incidence
from deneva_tpu_torch.ops import conflict, hashing

VIEWS = ("r", "w", "u", "pr", "uo", "ro", "wo", "pro")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("family", [0, 1, 2, 3])
@pytest.mark.parametrize("n_buckets", [1, 256, 8192, 2**31])
def test_combine_key_and_bucket_hash_exact(family, n_buckets):
    rng = np.random.default_rng(family)
    keys = np.concatenate([
        rng.integers(-2**31, 2**31, 4000, dtype=np.int64),
        [0, 1, -1, -2**31, 2**31 - 1, 2**30, -2**30]]).astype(np.int32)
    tables = rng.integers(0, 9, keys.shape).astype(np.int32)
    want_id = np.asarray(jhashing.combine_key(jnp.asarray(tables),
                                              jnp.asarray(keys)))
    got_id = hashing.combine_key(torch.from_numpy(tables),
                                 torch.from_numpy(keys))
    np.testing.assert_array_equal(got_id.numpy(), want_id.astype(np.int64))
    want = np.asarray(jhashing.bucket_hash(jnp.asarray(want_id), n_buckets,
                                           family))
    got = hashing.bucket_hash(got_id, n_buckets, family)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a scalar table id folds like an array of them
    np.testing.assert_array_equal(
        hashing.combine_key(3, torch.from_numpy(keys)).numpy(),
        np.asarray(jhashing.combine_key(3, jnp.asarray(keys))).astype(
            np.int64))


@pytest.mark.parametrize("b,a,k", [(1, 1, 8), (64, 10, 256), (100, 16, 64),
                                   (33, 40, 8)])
def test_access_incidence_exact_bf16(b, a, k):
    rng = np.random.default_rng(b + a)
    # few buckets per row: duplicates inside a row are common
    ids = rng.integers(0, min(k, 6), (b, a)).astype(np.int32)
    ids += rng.integers(0, k // min(k, 6), (b, 1)).astype(np.int32) \
        * min(k, 6)
    valid = rng.random((b, a)) < 0.7
    want = jconflict.access_incidence(jnp.asarray(ids), jnp.asarray(valid),
                                      k)
    got = conflict.access_incidence(torch.from_numpy(ids),
                                    torch.from_numpy(valid), k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _jbits(want))


def _incidences(b, k, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, k, (b, 6)).astype(np.int32)
        valid = rng.random((b, 6)) < 0.6
        out.append((jconflict.access_incidence(jnp.asarray(ids),
                                               jnp.asarray(valid), k),
                    conflict.access_incidence(torch.from_numpy(ids),
                                              torch.from_numpy(valid), k)))
    return out


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("b,k", [(64, 64), (96, 256), (5, 8)])
def test_overlap_exact(two, b, k):
    incs = _incidences(b, k, 4 if two else 2, seed=b * k + two)
    j = [x for x, _ in incs]
    t = [y for _, y in incs]
    want = jconflict.overlap(*j)
    got = conflict.overlap(*t)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < b * b


def _premise_lanes(rng, b, k, kind):
    """Bucket ids and valid flags of ``b`` rows: few lanes a row, or all
    lanes of a row in one bucket (counts up to 256), half the rows empty,
    or a row touching every bucket."""
    a = 256 if kind == "duplicates" else (k if kind == "dense_rows" else 6)
    ids = rng.integers(0, k, (b, a)).astype(np.int32)
    valid = rng.random((b, a)) < (0.02 if kind == "dense_rows" else 0.7)
    if kind == "duplicates":
        ids[:] = ids[:, :1]
        valid[0] = True
    if kind == "empty_rows":
        valid[: b // 2] = False
    if kind == "dense_rows":
        ids[b // 3] = np.arange(k)
        valid[b // 3] = True
    return ids, valid


@pytest.mark.parametrize("kind", ["random", "alias", "empty_rows",
                                  "dense_rows", "duplicates"])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("b,k", [(48, 64), (7, 8)])
def test_overlap_is_a_bucket_intersection(kind, two, b, k):
    """K7's premise: on K5+K6 count rows the reference's product test
    ``A @ B.T > 0`` is the bucket intersection ``exists k: A > 0 and B >
    0`` (counts are non-negative: nothing cancels), which the kernel
    computes from bitmaps.  The port's plain version equals both."""
    rng = np.random.default_rng(b * k + 7 * two + len(kind))
    lanes = [_premise_lanes(rng, b, k, kind) for _ in range(4 if two else 2)]
    if kind == "alias":
        lanes[1] = lanes[0]
        if two:
            lanes[3] = lanes[2]
    j = [jconflict.access_incidence(jnp.asarray(i), jnp.asarray(v), k)
         for i, v in lanes]
    t = [conflict.access_incidence(torch.from_numpy(i), torch.from_numpy(v),
                                   k) for i, v in lanes]
    if kind == "alias":      # one tensor on both sides, as twopl.py passes
        t[1] = t[0]
        if two:
            t[3] = t[2]
    cnt = [np.asarray(x, dtype=np.float32) for x in j]
    assert min(float(c.min()) for c in cnt) >= 0
    if kind == "duplicates":
        assert max(float(c.max()) for c in cnt) == 256

    def meets(x, y):
        return ((x > 0)[:, None, :] & (y > 0)[None, :, :]).any(axis=2)
    want = meets(cnt[0], cnt[1])
    if two:
        want &= meets(cnt[2], cnt[3])
    ref = np.asarray(jconflict.overlap(*j))
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(conflict.overlap_plain(*t).numpy(), want)
    np.testing.assert_array_equal(conflict.overlap(*t).numpy(), want)
    if kind == "empty_rows":
        assert not want[: b // 2].any()
    if kind == "dense_rows" and not two:
        np.testing.assert_array_equal(want[b // 3], (cnt[1] > 0).any(1))


@pytest.mark.parametrize("rounds", [1, 3, 24])
@pytest.mark.parametrize("b", [16, 64, 200])
def test_earlier_edges_and_first_fit_exact(rounds, b):
    rng = np.random.default_rng(rounds * 1000 + b)
    conflict_m = rng.random((b, b)) < 0.2
    conflict_m |= conflict_m.T
    # rank ties among active txns: ranks from a small range
    rank = rng.integers(0, b // 3, b).astype(np.int32)
    active = rng.random(b) < 0.85
    je = jconflict.earlier_edges(jnp.asarray(conflict_m), jnp.asarray(rank),
                                 jnp.asarray(active))
    te = conflict.earlier_edges(torch.from_numpy(conflict_m),
                                torch.from_numpy(rank),
                                torch.from_numpy(active))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    want = jconflict.greedy_first_fit(je, jnp.asarray(active), rounds)
    got = conflict.greedy_first_fit(te, torch.from_numpy(active), rounds)
    fused = conflict.first_fit(torch.from_numpy(conflict_m),
                               torch.from_numpy(rank),
                               torch.from_numpy(active), rounds)
    for w, g, f in zip(want, got, fused):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(f.numpy(), np.asarray(w))
    win, lose, und = (x.numpy() for x in got)
    assert win.any() and (lose.any() or rounds == 1)
    assert not (win & lose).any() and ((win | lose | und) == active).all()
    if rounds == 1:
        assert und.any()    # a loss needs a win of an earlier round


def test_first_fit_matches_reference_at_skew_shape():
    """B = 2,048 (``ycsb_skew``'s batch) at the config's 24 rounds, a
    conflict density near that shape's (~2% of pairs), rank ties."""
    rng = np.random.default_rng(2048)
    b = 2048
    conflict_m = rng.random((b, b)) < 0.02
    rank = rng.integers(0, b // 2, b).astype(np.int32)
    active = rng.random(b) < 0.95
    je = jconflict.earlier_edges(jnp.asarray(conflict_m), jnp.asarray(rank),
                                 jnp.asarray(active))
    want = jconflict.greedy_first_fit(je, jnp.asarray(active), 24)
    got = conflict.first_fit(torch.from_numpy(conflict_m),
                             torch.from_numpy(rank), torch.from_numpy(active),
                             24)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and got[1].any()


def k8_cluster_model(conflict_m, rank, active, rounds: int, ctas: int):
    """K8's sweep as ``csrc/conflict.cu`` runs it in a cluster of ``ctas``
    CTAs, in numpy: CTA r owns row words [r own, (r + 1) own) and keeps
    its own copy of the win / lose sets; round 0 wins the active rows
    without edges (the pack's counts); a later round reads each pending
    owned row against the CTA's copy; each CTA's owned words and changed
    flag are then stored into every other CTA's copy.  Returns (win,
    lose, undecided)."""
    b = active.shape[0]
    words = 4 * -(-b // 128)   # W of conflict.cu: B to 128 columns
    own = -(-words // ctas)
    n = 32 * words
    e = np.zeros((n, n), bool)
    e[:b, :b] = conflict.earlier_edges(torch.from_numpy(conflict_m),
                                       torch.from_numpy(rank),
                                       torch.from_numpy(active)).numpy()
    act = np.zeros(n, bool)
    act[:b] = active
    cta = []
    for r in range(ctas):
        w0 = min(r * own, words)
        cta.append(dict(rows=np.arange(32 * w0,
                                       32 * (w0 + min(own, words - w0))),
                        win=np.zeros(n, bool), lose=np.zeros(n, bool),
                        flags=np.zeros(ctas, bool)))
    for rnd in range(rounds):
        for c in cta:
            rows = c["rows"]
            if rnd == 0:
                nw = act[rows] & ~e[rows].any(1)
                nl = np.zeros(rows.size, bool)
            else:
                p = act[rows] & ~c["win"][rows] & ~c["lose"][rows]
                blocked = (e[rows] & ~c["lose"]).any(1)
                hit = (e[rows] & c["win"]).any(1)
                nw = p & ~blocked
                nl = p & ~nw & hit
            c["next"] = (c["win"][rows] | nw, c["lose"][rows] | nl)
            c["any"] = bool((nw | nl).any())
        for r, c in enumerate(cta):
            for q, o in enumerate(cta):
                o["win"][c["rows"]], o["lose"][c["rows"]] = c["next"]
                o["flags"][r] = c["any"]
        go = {bool(c["flags"].any()) for c in cta}
        assert len(go) == 1             # every CTA leaves in one round
        if not go.pop():
            break
    win = cta[0]["win"][:b]
    lose = cta[0]["lose"][:b]
    return win, lose, active & ~win & ~lose


@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
@pytest.mark.parametrize("b,kind", [(100, "random"), (1000, "random"),
                                    (2048, "random"), (300, "chain"),
                                    (257, "dense"), (64, "none_active")])
def test_first_fit_cluster_model_matches_plain(ctas, b, kind):
    rng = np.random.default_rng(b + ctas)
    i = np.arange(b)
    if kind == "chain":
        conflict_m = np.abs(i[:, None] - i[None, :]) == 1
        rank = i.astype(np.int32)
    elif kind == "dense":
        conflict_m = i[:, None] != i[None, :]
        rank = rng.integers(0, 5, b).astype(np.int32)
    else:
        conflict_m = rng.random((b, b)) < min(0.2, 20.0 / b)
        rank = rng.integers(0, max(b // 3, 1), b).astype(np.int32)
    active = rng.random(b) < 0.9 if kind != "none_active" \
        else np.zeros(b, bool)
    for rounds in (3, 24):
        want = conflict.first_fit_plain(torch.from_numpy(conflict_m),
                                        torch.from_numpy(rank),
                                        torch.from_numpy(active), rounds)
        got = k8_cluster_model(conflict_m, rank, active, rounds, ctas)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("order_free", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_build_incidence_all_views_exact(order_free, exact):
    rng = np.random.default_rng(7 + order_free + 2 * exact)
    b, a, k = 48, 10, 64
    f = dict(table_ids=rng.integers(0, 3, (b, a)).astype(np.int32),
             keys=rng.integers(-500, 500, (b, a)).astype(np.int32),
             is_read=rng.random((b, a)) < 0.6,
             is_write=rng.random((b, a)) < 0.5,
             valid=rng.random((b, a)) < 0.9,
             ts=np.arange(b, dtype=np.int32),
             rank=np.arange(b, dtype=np.int32),
             active=rng.random(b) < 0.8)
    of = rng.random((b, a)) < 0.3 if order_free else None
    jinc = j_build_incidence(JBatch(**{n: jnp.asarray(v)
                                       for n, v in f.items()}), k, exact,
                             order_free=None if of is None
                             else jnp.asarray(of))
    tinc = build_incidence(AccessBatch(**{n: torch.from_numpy(v)
                                          for n, v in f.items()}), k, exact,
                           order_free=None if of is None
                           else torch.from_numpy(of))
    np.testing.assert_array_equal(tinc.bucket1.numpy(),
                                  np.asarray(jinc.bucket1))
    for fam in (1, 2):
        for v in VIEWS:
            want, got = getattr(jinc, f"{v}{fam}"), getattr(tinc, f"{v}{fam}")
            if fam == 2 and not exact:
                assert want is None and got is None
                continue
            np.testing.assert_array_equal(_bits(got), _jbits(want),
                                          err_msg=f"{v}{fam}")
    if not order_free:
        assert tinc.uo1 is tinc.u1 and tinc.pro1 is tinc.pr1


def test_build_incidence_builds_only_requested_views():
    rng = np.random.default_rng(3)
    b, a = 16, 4
    batch = AccessBatch(
        table_ids=torch.zeros(b, a, dtype=torch.int32),
        keys=torch.from_numpy(rng.integers(0, 50, (b, a)).astype(np.int32)),
        is_read=torch.ones(b, a, dtype=torch.bool),
        is_write=torch.from_numpy(rng.random((b, a)) < 0.5),
        valid=torch.ones(b, a, dtype=torch.bool),
        ts=torch.arange(b, dtype=torch.int32),
        rank=torch.arange(b, dtype=torch.int32),
        active=torch.ones(b, dtype=torch.bool))
    inc = build_incidence(batch, 32, True, views=("uo", "w"))
    assert inc.uo1 is inc.u1 and inc.uo2 is inc.u2
    assert inc.w1 is not None and inc.w2 is not None
    assert inc.r1 is None and inc.pr2 is None and inc.ro1 is None
    with pytest.raises(ValueError):
        conflict.hashed_incidence(batch.table_ids, batch.keys, batch.is_read,
                                  batch.is_write, batch.valid, batch.active,
                                  None, 32, 1, ("uo",))
