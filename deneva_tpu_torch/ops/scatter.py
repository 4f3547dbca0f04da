"""Duplicate-scatter resolution (port of ``deneva_tpu/ops/scatter.py``).

When several committed txns of one epoch write the same slot, the batch
applies exactly the write of the latest in serialization order — the
batch analogue of the reference applying writes serially under latches
(`storage/row.cpp:351-420`).

**K10** `last_writer` (``csrc/scatter.cu``) replaces
``ops/scatter.py:33``.  The reference takes a sort tournament below
capacity and a scatter-max arena at or above it; both compute one
function, which the kernel computes in O(N) through an open-addressing
table keyed by slot.  `last_writer_plain` ports both regimes op for op.
"""

from __future__ import annotations

import torch

from deneva_tpu_torch import kernels

INT32_MIN = -2**31

K10_LAST_WRITER = kernels.Kernel("dt_last_writer", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.P, kernels.P,
    kernels.I32, kernels.P, kernels.P])


def _lex_sort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting by ``keys`` lexicographically (first most
    significant): stable sorts from the last key to the first."""
    perm = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def last_writer_plain(slots: torch.Tensor, order: torch.Tensor,
                      mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """bool[N]: per slot, the masked entry with the highest (order, lane).

    Masked-out entries never win; entries aimed at the trash slot win
    among themselves and write only the trash row."""
    n = slots.shape[0]
    slots = torch.where(mask, slots, capacity).to(torch.int32)
    lane = torch.arange(n, dtype=torch.int32, device=slots.device)
    neg = torch.iinfo(order.dtype).min
    if n < capacity:
        # sort tournament: each slot's winner is its segment's tail under
        # (slot, order, lane); keys are unique, so sort order is total
        eff_ord = torch.where(mask, order, neg)
        eff_lane = torch.where(mask, lane, -1)
        perm = _lex_sort([slots, eff_ord, eff_lane])
        ssl = slots[perm]
        tail = torch.cat([ssl[1:] != ssl[:-1],
                          torch.ones(1, dtype=torch.bool,
                                     device=slots.device)])
        win = torch.empty_like(tail)
        win[perm] = tail
        return win & mask
    # arena: scatter-max of order per slot, then of lane among the best
    eff = torch.where(mask, order, neg)
    idx = slots.to(torch.int64)
    best = torch.full((capacity + 1,), neg, dtype=order.dtype,
                      device=slots.device).scatter_reduce_(
        0, idx, eff, "amax")
    is_best = mask & (eff == best[idx])
    eff_lane = torch.where(is_best, lane, -1)
    best_lane = torch.full((capacity + 1,), -1, dtype=torch.int32,
                           device=slots.device).scatter_reduce_(
        0, idx, eff_lane, "amax")
    return is_best & (eff_lane == best_lane[idx])


def last_writer(slots: torch.Tensor, order: torch.Tensor,
                mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """K10 (``slots`` in [0, capacity], int32 ``order``)."""
    if kernels.on_cpu(slots, order, mask):
        return last_writer_plain(slots, order, mask, capacity)
    n = slots.shape[0]
    dev = slots.device
    kernels.check("slots", slots, torch.int32, (n,), dev)
    kernels.check("order", order, torch.int32, (n,), dev)
    kernels.check("mask", mask, torch.bool, (n,), dev)
    size = 32
    while size < 2 * n:
        size *= 2
    tkeys = torch.empty(size, dtype=torch.int32, device=dev)
    tvals = torch.empty(size, dtype=torch.int64, device=dev)
    win = torch.empty(n, dtype=torch.bool, device=dev)
    K10_LAST_WRITER.launch(kernels.ptr(slots), kernels.ptr(order),
                           kernels.ptr(mask), n, kernels.ptr(tkeys),
                           kernels.ptr(tvals), size, kernels.ptr(win),
                           kernels.stream(slots))
    return win
