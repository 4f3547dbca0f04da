"""K11a's plain side on the CPU: `cc.maat.reach_stats` (the plain route
on CPU tensors) on the structured graphs that ``chip_smoke.py`` and the
CUDA tests hand the kernel, against a breadth-first closure in numpy
from every source, with the ``counts`` flag on and off; and the group
sizes the kernel takes for each B.
"""

import numpy as np
import pytest
import torch

from chip_smoke import k11_graphs
from deneva_tpu_torch.cc import maat


def _np_closure(p, live):
    """reach[s, v]: a path of one or more edges from s to v over live
    txns, one breadth-first search per source."""
    b = p.shape[0]
    sub = p & live[:, None] & live[None, :]
    reach = np.zeros((b, b), bool)
    for s in range(b):
        front = sub[s].copy()
        seen = front.copy()
        while front.any():
            nxt = sub[front].any(axis=0) & ~seen
            seen |= nxt
            front = nxt
        reach[s] = seen
    return reach


@pytest.mark.parametrize("b", [16, 100, 257])
@pytest.mark.parametrize("graph", ["ring", "dag", "cycles23", "chain",
                                   "sparse_live", "empty_live", "gate_off"])
def test_reach_stats_plain_matches_numpy_closure(b, graph):
    p, live, gate = k11_graphs(b, seed=b)[graph]
    sr, anc = maat.reach_stats(p, live, gate)
    sr0, none = maat.reach_stats(p, live, gate, False)
    assert none is None and torch.equal(sr, sr0)
    if not gate.any():
        assert not sr.any() and not anc.any()
        return
    reach = _np_closure(p.numpy(), live.numpy())
    np.testing.assert_array_equal(sr.numpy(), np.diagonal(reach))
    np.testing.assert_array_equal(anc.numpy(), reach.sum(axis=0))
    if graph == "chain":
        assert not sr.any() and anc.tolist() == list(range(b))
    if graph == "ring":
        assert bool(sr.all())


def test_reach_group_sizes():
    """Every B the earlier one-warp-a-source kernel took (up to 28,736)
    has a group size; past one block's shared memory the wrapper
    raises."""
    assert maat.reach_group(2048) == 32 and maat.reach_group(16384) == 32
    assert maat.reach_group(16548) == 32 and maat.reach_group(16549) == 16
    assert maat.reach_group(28736) == 16 and maat.reach_group(32124) == 16
    with pytest.raises(ValueError):
        maat.reach_group(32125)
