"""``last_writer`` of ``deneva_tpu_torch`` against ``deneva_tpu`` on the CPU,
exactly, in both of the reference's regimes: the sort tournament below
capacity and the scatter-max arena at or above it.  Inputs carry
duplicate slots, ties on ``order``, masked lanes, lanes aimed at the
trash slot and ``order`` at INT32_MIN."""

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
