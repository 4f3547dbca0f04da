"""K18a's cooperative kernel as a numpy model on the CPU, against the plain
capacity rule and ``deneva_tpu``'s ``mc_plan_defer``.

``csrc/mc.cu`` ``defer_kernel`` runs in phases over tiles of txns (1,024
on the card; the model takes any tile so that small slices span many
tiles).  The model keeps the state the kernel keeps and follows its
phases (not its threads):

0. each txn's owner counts from its lanes (invalid lanes count nowhere),
   a byte an owner; each tile's histogram of each byte of ts ^ 2^31;
1. the digit bases from the tiles' histograms; a byte whose digits all
   agree makes no pass;
2. one stable LSD pass a remaining byte over (ts, txn) words: inside a
   tile, words keep their order within a digit; a tile's words of a
   digit follow the earlier tiles' words of that digit (the look-back's
   prefix); the last pass writes the order;
3. by position, tile by tile: inclusive scans of the D count rows, the
   earlier tiles' totals (the look-back), and the test: t defers iff
   prefix_o(t) + c[t][o] > pair_cap for an owner o it touches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.ops import forward as jf
from deneva_tpu_torch.ops import forward as tf


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain rule runs many small torch ops: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def warp_owner_counts(keys, valid, d, tile=1024):
    """Phase 0's owner counts as the kernel's warps take them: a tile's
    lanes in chunks of 32 adjacent ones (chunk c to warp c % 32), a
    ballot an owner, and each lane that starts a txn's run in its chunk
    (lane 0, or a txn's first lane) adds the run's counts, a byte an
    owner, to the txn's word; a lane's (txn, place) advance by divmod(
    tile, A) from one of its warp's chunks to the next, as the kernel
    keeps them.  Returns the packed words, int64[bD]."""
    bd, a = keys.shape
    words = np.zeros(bd, np.int64)
    warps = tile // 32
    for t0 in range(0, bd, tile):
        nl = (min(bd, t0 + tile) - t0) * a
        kt = keys[t0:t0 + tile].reshape(-1)
        vt = valid[t0:t0 + tile].reshape(-1)
        for warp in range(warps):
            lanes = np.arange(32)
            txn, rem = np.divmod(32 * warp + lanes, a)
            for l0 in range(32 * warp, nl, tile):
                l = l0 + lanes
                inside = l < nl
                o = np.where(inside & vt[np.minimum(l, nl - 1)],
                             kt[np.minimum(l, nl - 1)].astype(np.int64) % d,
                             -1)
                head = inside & ((lanes == 0) | (rem == 0))
                for h in np.flatnonzero(head):
                    later = np.flatnonzero(head[h + 1:])
                    end = h + 1 + later[0] if later.size else 32
                    run = o[h:end]
                    add = sum(int((run == q).sum()) << (8 * q)
                              for q in range(d))
                    words[t0 + txn[h]] += add
                txn += tile // a
                rem += tile % a
                carry = rem >= a
                rem[carry] -= a
                txn[carry] += 1
    return words


def cooperative_defer(keys, valid, ts, d, cap, tile=1024):
    """The kernel's phases on numpy arrays: (dfr bool[bD], order
    int32[bD], radix passes made)."""
    bd, a = keys.shape
    tiles = -(-bd // tile)
    # phase 0: owner counts a byte each, packed into one word a txn
    owner = keys.astype(np.int64) % d
    counts = np.zeros((bd, 8), np.int64)
    np.add.at(counts, (np.repeat(np.arange(bd), a)[valid.reshape(-1)],
                       owner[valid]), 1)
    assert counts.max(initial=0) < 256
    packed = (counts << (8 * np.arange(8))).sum(axis=1)
    assert np.array_equal(warp_owner_counts(keys, valid, d), packed)
    key = (ts.astype(np.int64) + 2**31) & 0xFFFFFFFF
    digits = np.stack([(key >> (8 * p)) & 255 for p in range(4)])
    hist = np.zeros((4, tiles, 256), np.int64)
    for k in range(tiles):
        for p in range(4):
            hist[p, k] = np.bincount(digits[p, k * tile:(k + 1) * tile],
                                     minlength=256)
    # phase 1: digit bases; the bytes that need a pass
    tot = hist.sum(axis=1)
    base = np.cumsum(tot, axis=1) - tot
    passes = [p for p in range(4) if tot[p].max() < bd]
    # phase 2: the passes over (key, txn) words
    words = np.arange(bd)                   # txn ids in the current order
    for p in passes:
        dg = digits[p, words]
        out = np.empty(bd, np.int64)
        seen = np.zeros(256, np.int64)      # earlier tiles' counts (look-back)
        for k in range(tiles):
            d_k = dg[k * tile:(k + 1) * tile]
            rank = np.zeros(d_k.size, np.int64)
            order_k = np.argsort(d_k, kind="stable")
            first = np.searchsorted(d_k[order_k], d_k[order_k])
            rank[order_k] = np.arange(d_k.size) - first
            at = base[p, d_k] + seen[d_k] + rank
            out[at] = words[k * tile:(k + 1) * tile]
            seen += np.bincount(d_k, minlength=256)
        words = out
    order = words.astype(np.int32)
    # phase 3: by position, the count rows' scans and the test
    c = (packed[order][:, None] >> (8 * np.arange(8))) & 255
    dfr = np.zeros(bd, bool)
    prefix = np.zeros(8, np.int64)          # earlier tiles (look-back)
    for k in range(tiles):
        ck = c[k * tile:(k + 1) * tile, :d]
        incl = prefix[:d] + np.cumsum(ck, axis=0)
        dfr[order[k * tile:(k + 1) * tile]] = ((ck > 0) & (incl > cap)).any(
            axis=1)
        prefix[:d] += ck.sum(axis=0)
    return dfr, order, len(passes)


def _slice(bd, a, d, seed, kind):
    """One source slice: keys skewed like zipf 0.9 over 2^20, ts from a
    sequence window; ``kind`` picks the edge: ``rep_ts`` (ts repeat),
    ``one_owner`` (every key owned by shard 1), ``invalid`` (every lane
    invalid), ``signed`` (ts over the whole int32 range, negatives
    included), ``equal_ts`` (one ts)."""
    rng = np.random.default_rng(seed)
    keys = ((1 << 20) * rng.random((bd, a)) ** 4).astype(np.int32)
    if kind == "one_owner":
        keys = keys // d * d + 1
    valid = rng.random((bd, a)) >= 0.1
    if kind == "invalid":
        valid[:] = False
    ts = (1_000_000 + rng.permutation(3 * bd)[:bd]).astype(np.int32)
    if kind == "rep_ts":
        ts = rng.integers(1, max(bd // 8, 2), bd).astype(np.int32)
    if kind == "signed":
        ts = rng.integers(-2**31, 2**31 - 1, bd).astype(np.int32)
    if kind == "equal_ts":
        ts[:] = 5
    return keys, valid, ts


@functools.lru_cache(maxsize=None)
def _jax_defer(d, cap):
    return jax.jit(functools.partial(jf.mc_plan_defer, d_parts=d,
                                     pair_cap=cap))


CASES = [
    # bD, A, D, pair_cap, kind, tile
    (1, 4, 2, 4, "seq", 1024),
    (5, 3, 8, 3, "rep_ts", 2),
    (300, 10, 8, 10, "one_owner", 64),      # pair_cap = one txn's lanes
    (777, 7, 3, 140, "rep_ts", 100),
    (1000, 10, 8, 128, "seq", 1024),
    (1025, 10, 4, 640, "signed", 256),      # ragged: one txn past a tile
    (2500, 6, 2, 1024, "seq", 333),
    (640, 4, 5, 4, "invalid", 128),         # every lane invalid
    (513, 5, 6, 5, "equal_ts", 64),         # no radix pass at all
    (2048, 10, 7, 512, "one_owner", 1024),
]


@pytest.mark.parametrize("bd,a,d,cap,kind,tile", CASES)
def test_cooperative_model_matches_plain(bd, a, d, cap, kind, tile):
    keys, valid, ts = _slice(bd, a, d, bd + a + d, kind)
    dfr, order, passes = cooperative_defer(keys, valid, ts, d, cap, tile)
    want = tf.mc_slice_defer_plain(torch.from_numpy(keys),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(ts), d, cap)
    assert np.array_equal(dfr, want[0].numpy())
    assert np.array_equal(order, want[1].numpy())
    assert (passes == 0) == (np.unique(ts).size == 1)
    if kind == "one_owner":
        assert dfr.any() and not dfr.all()
    if kind == "invalid":
        assert not dfr.any()


@pytest.mark.parametrize("bd,a,d,cap,kind,tile", CASES[1:8])
def test_cooperative_model_matches_reference_over_d_slices(bd, a, d, cap,
                                                           kind, tile):
    """The reference's rule over the replicated batch of D slices is the
    model slice by slice."""
    slices = [_slice(bd, a, d, 97 * s + bd, kind) for s in range(d)]
    keys, valid, ts = (np.concatenate(x) for x in zip(*slices))
    want = np.asarray(_jax_defer(d, cap)(jnp.asarray(keys), jnp.asarray(ts),
                                         jnp.asarray(valid)))
    got = np.concatenate([cooperative_defer(k, v, t, d, cap, tile)[0]
                          for k, v, t in slices])
    assert np.array_equal(got, want)
