"""Duplicate-scatter resolution (port of ``deneva_tpu/ops/scatter.py``).

When several committed txns of one epoch write the same slot, the batch
applies exactly the write of the latest in serialization order — the
batch analogue of the reference applying writes serially under latches
(`storage/row.cpp:351-420`).

**K10** `last_writer` (``csrc/scatter.cu``) replaces
``ops/scatter.py:33``.  The reference takes a sort tournament below
capacity and a scatter-max arena at or above it; both compute one
function, which the kernel computes in O(N) through open-addressing
tables keyed by slot: up to 32,768 lanes in one launch of CTAs that each
own the slots of one hash class in their shared memory, beyond that in
one global table (`last_writer_layout`).  `last_writer_plain` ports both
of the reference's regimes op for op.
"""

from __future__ import annotations

import functools

import torch

from deneva_tpu_torch import kernels

INT32_MIN = -2**31

K10_LAST_WRITER = kernels.Kernel("dt_last_writer", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.P,
    kernels.I64, kernels.P, kernels.P])


@functools.lru_cache(maxsize=256)
def _layout(n: int, ctas: int, device: int) -> tuple[int, int, int]:
    with torch.cuda.device(device):
        return kernels.layout("dt_last_writer_layout", n, ctas)


def last_writer_layout(n: int, device, ctas: int = 0
                       ) -> tuple[int, int, int]:
    """K10's launch for ``n`` lanes as the library lays it out: (CTAs,
    table entries a CTA, 0) in the shared-memory regime, (0, 0, global
    table entries) in the global one.  ``ctas`` > 0 asks for that many
    CTAs (a power of two up to 128), -1 for the global table, 0 for the
    library's choice by ``n``."""
    return _layout(n, ctas, torch.device(device).index)


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
    return _last_writer(slots, order, mask, 0)


def _last_writer(slots: torch.Tensor, order: torch.Tensor,
                 mask: torch.Tensor, ctas: int) -> torch.Tensor:
    """K10 on the card, laid out as ``last_writer_layout(n, ., ctas)``
    says; only the global regime takes scratch."""
    n = slots.shape[0]
    dev = slots.device
    kernels.check("slots", slots, torch.int32, (n,), dev)
    kernels.check("order", order, torch.int32, (n,), dev)
    kernels.check("mask", mask, torch.bool, (n,), dev)
    size = last_writer_layout(n, dev, ctas)[2]
    # the global table's words and keys (int32, two to a word)
    scratch = torch.empty(size + size // 2, dtype=torch.int64, device=dev) \
        if size else None
    win = torch.empty(n, dtype=torch.bool, device=dev)
    K10_LAST_WRITER.launch(kernels.ptr(slots), kernels.ptr(order),
                           kernels.ptr(mask), n, ctas,
                           None if scratch is None else kernels.ptr(scratch),
                           size + size // 2, kernels.ptr(win),
                           kernels.stream(slots))
    return win
