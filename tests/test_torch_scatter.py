"""``last_writer`` of ``deneva_tpu_torch`` against ``deneva_tpu`` on the CPU,
exactly, in both of the reference's regimes: the sort tournament below
capacity and the scatter-max arena at or above it.  Inputs carry
duplicate slots, ties on ``order``, masked lanes, lanes aimed at the
trash slot and ``order`` at INT32_MIN.  A numpy model of K10's
shared-table launch (``csrc/scatter.cu``: the slots' owner CTAs, each
CTA's open-addressing table at half load, the sub-rounds of a table
that passes it) is held to both at 1, 2, 8 and 32 CTAs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.ops.scatter import last_writer as j_last_writer
from deneva_tpu_torch.ops.scatter import last_writer, last_writer_plain

INT32_MIN = -2**31


def _lanes(n, n_slots, capacity, seed):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, n_slots, n).astype(np.int32)
    slots[rng.random(n) < 0.05] = capacity          # trash-aimed lanes
    order = rng.integers(0, 6, n).astype(np.int32)  # many ties
    order[rng.random(n) < 0.1] = INT32_MIN
    order[rng.random(n) < 0.05] = 2**31 - 1
    mask = rng.random(n) < 0.7
    return slots, order, mask


@pytest.mark.parametrize("n,n_slots,capacity", [
    (200, 30, 1000),        # sort regime
    (10240, 4000, 1 << 24),  # sort regime, the OCC epoch's lane count
    (200, 30, 30),          # arena regime
    (4096, 500, 600),       # arena regime
    (1, 1, 1), (1, 1, 5), (3, 1, 2)])
def test_last_writer_matches_reference(n, n_slots, capacity):
    slots, order, mask = _lanes(n, n_slots, capacity, seed=n + capacity)
    want = np.asarray(j_last_writer(jnp.asarray(slots), jnp.asarray(order),
                                    jnp.asarray(mask), capacity))
    got = last_writer(torch.from_numpy(slots), torch.from_numpy(order),
                      torch.from_numpy(mask), capacity)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # one winner per written slot, none among masked lanes
    assert not (got.numpy() & ~mask).any()
    assert len(np.unique(slots[want])) == int(want.sum())
    assert set(slots[want]) == set(slots[mask])


def test_both_regimes_compute_one_function():
    slots, order, mask = _lanes(500, 40, 50, seed=9)
    slots = np.minimum(slots, 39)
    s, o, m = (torch.from_numpy(x) for x in (slots, order, mask))
    arena = last_writer_plain(s, o, m, 50)          # n >= capacity
    tournament = last_writer_plain(s, o, m, 4096)   # n < capacity
    assert torch.equal(arena, tournament)
    # the definition: max (order, lane) among masked lanes of each slot
    for i in range(len(slots)):
        peers = np.nonzero(mask & (slots == slots[i]))[0]
        best = max(peers, key=lambda j: (order[j], j)) if len(peers) else -1
        assert bool(arena[i]) == (bool(mask[i]) and best == i)


# -- a numpy model of K10's shared-table launch (csrc/scatter.cu) ----------

M32 = 0xFFFFFFFF


def _hash(slots):
    """slot_hash: Fibonacci hashing, a bijection of the 32 bits."""
    return (slots.astype(np.int64) & M32) * 2654435761 & M32


def _top(h, bits):
    """The top ``bits`` bits of 32-bit hashes (0 where bits is 0)."""
    return h >> (32 - bits) if bits else np.zeros_like(h)


def k10_layout(n, ctas=0):
    """(CTAs, log2 table entries) of the shared regime as ``layout`` picks
    them on a card with room for 8,192 entries a CTA: C CTAs with C x
    1,024 >= 2N (at most 128), then the fewest entries (>= 128, <= 8,192)
    holding twice a CTA's share of the lanes."""
    c = ctas or 1
    while not ctas and c < 128 and c * 1024 < 2 * n:
        c *= 2
    share = 2 * -(-n // c)
    logt = 7
    while logt < 13 and (1 << logt) < share:
        logt += 1
    return c, logt


def k10_model(slots, order, mask, ctas, logt):
    """K10's flags as its ``ctas`` CTAs of 2^logt-entry tables compute
    them: CTA r owns the masked lanes whose hash's top log2 C bits are r;
    in one pass it clears their flags (and, in the first sub-round, those of the
    unmasked lanes of its class, lane / 4 mod C), claims an entry
    per distinct slot by linear probing from a second hash's top bits and
    keeps the max word (order - INT32_MIN) << 32 | lane there; a
    sub-round past half the entries is set aside and the CTA splits its
    slots over Q = 2, 4, ... sub-rounds by the hash's next bits; after
    its barrier the CTA sets the flag of each entry's word's lane.
    Returns (win, the most sub-rounds a CTA ran); asserts each flag is
    written by one CTA only, and every flag by one."""
    n = slots.size
    logc = ctas.bit_length() - 1
    t, limit = 1 << logt, (1 << logt) // 2
    h = _hash(slots)
    lane = np.arange(n)
    word = ((order.astype(np.int64) + 2**31).astype(np.uint64)
            << np.uint64(32)) | lane.astype(np.uint64)
    win = np.zeros(n, bool)
    writer = np.full(n, -1)
    most = 1

    def write(idx, value, me):
        assert np.isin(writer[idx], (-1, me)).all()
        writer[idx] = me
        win[idx] = value
    for me in range(ctas):
        logq = 0
        while True:
            qn = 1 << logq
            spill = False
            for q in range(qn):
                mine = np.nonzero(mask & (_top(h, logc + logq)
                                          == (me << logq | q)))[0]
                write(mine, False, me)
                if q == 0:
                    write(lane[~mask & ((lane >> 2) & (ctas - 1) == me)],
                          False, me)
                tkey = np.full(t, -1, np.int64)
                tval = np.zeros(t, np.uint64)
                for i in mine:
                    j = ((int(h[i]) * 0x85EBCA77) & M32) >> (32 - logt)
                    for _ in range(t):
                        if tkey[j] in (-1, slots[i]):
                            break
                        j = (j + 1) % t
                    else:
                        spill = True
                        break
                    tkey[j] = slots[i]
                    tval[j] = max(tval[j], word[i])
                if spill or (tkey >= 0).sum() > limit:
                    spill = True
                    break
                write((tval[tkey >= 0] & np.uint64(M32)).astype(np.int64),
                      True, me)
            if not spill:
                break
            logq += 1
        most = max(most, 1 << logq)
    assert (writer >= 0).all()
    return win, most


def _k10_case(kind, n, capacity, seed):
    rng = np.random.default_rng(seed)
    slots, order, mask = _lanes(n, min(max(n // 4, 1), capacity), capacity,
                                seed)
    if kind == "one_slot":
        slots[:] = 3
        mask[:] = True
    elif kind == "no_mask":
        mask[:] = False
    elif kind == "extremes":
        order = np.where(rng.random(n) < 0.5, INT32_MIN, 2**31 - 1
                         ).astype(np.int32)
    elif kind == "distinct":        # every lane its own slot
        slots = rng.permutation(capacity)[:n].astype(np.int32)
    return slots, order, mask


@pytest.mark.parametrize("ctas", [1, 2, 8, 32])
@pytest.mark.parametrize("kind,n,capacity", [
    ("random", 1023, 1 << 20), ("random", 1025, 1 << 20),
    ("random", 4097, 1 << 20), ("one_slot", 3000, 1 << 20),
    ("no_mask", 2049, 1 << 20), ("extremes", 1500, 400),
    ("distinct", 2048, 1 << 16), ("arena", 4096, 600),
    ("arena", 300, 30)])
def test_last_writer_model_matches_plain_and_reference(ctas, kind, n,
                                                       capacity):
    slots, order, mask = _k10_case(kind, n, capacity, seed=n + ctas)
    want = np.asarray(j_last_writer(jnp.asarray(slots), jnp.asarray(order),
                                    jnp.asarray(mask), capacity))
    plain = last_writer_plain(torch.from_numpy(slots),
                              torch.from_numpy(order),
                              torch.from_numpy(mask), capacity).numpy()
    np.testing.assert_array_equal(plain, want)
    got, _ = k10_model(slots, order, mask, ctas, k10_layout(n, ctas)[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctas,logt", [(1, 7), (2, 7), (8, 7), (1, 4)])
def test_last_writer_model_splits_a_full_table_exactly(ctas, logt):
    """Tables too small for their slots (and, at 8 CTAs, slots built to
    share one owner, as an input chosen against the hash would): the
    CTAs run sub-rounds and the flags stay exact."""
    n = 3000
    slots, order, mask = _k10_case("distinct", n, 1 << 16, seed=logt)
    if ctas == 8:
        pool = np.arange(1 << 16, dtype=np.int32)
        slots = pool[_top(_hash(pool), 3) == 5][:n].copy()
    want = last_writer_plain(torch.from_numpy(slots),
                             torch.from_numpy(order),
                             torch.from_numpy(mask), 1 << 16).numpy()
    got, rounds = k10_model(slots, order, mask, ctas, logt)
    np.testing.assert_array_equal(got, want)
    assert rounds > 1


@pytest.mark.parametrize("n", [1, 1000, 10240, 20480, 30720, 32768])
def test_last_writer_layout_keeps_tables_half_full(n):
    """The library's layout (as ``k10_layout`` models it) gives every N
    of the shared regime (up to 32,768 lanes) room for twice a CTA's
    share of the lanes, in tables of at most 1,024 entries."""
    c, logt = k10_layout(n)
    assert c * (1 << logt) >= 2 * n and (1 << logt) <= 1024 and c <= 64
