"""Indexes: key -> slot (reference `storage/index_hash.{h,cpp}`, `index_btree`).

The port carries YCSB's two primary indexes:

* `DenseIndex` — the affine key -> slot map (`benchmarks/ycsb_wl.cpp:
  70-74`, ``deneva_tpu/storage/index.py:34``), plain PyTorch;
* `SortedIndex` — the ordered index of ``INDEX_STRUCT=IDX_BTREE``
  (``deneva_tpu/storage/index.py:121``): a sorted key array probed by
  binary search.  ``lookup`` runs as kernel **K14b** (``csrc/index.cu``),
  replacing ``:155-166`` `_lower` and `lookup`: one thread per query, a
  branchless lower bound, the hit test, the slot or the miss slot.

`SortedIndex`'s count and range scans, `HashIndex` and
`DynamicSortedIndex` have no YCSB caller; they come with TPC-C / PPS
(ROADMAP.md queue 1, item 15).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deneva_tpu_torch import kernels

K14B_LOOKUP = kernels.Kernel("dt_sorted_lookup", [
    kernels.P, kernels.P, kernels.I32, kernels.P, kernels.I64, kernels.I32,
    kernels.P, kernels.P])


@dataclass
class DenseIndex:
    base: int = 0
    stride: int = 1
    size: int = 0          # number of indexed keys; OOB -> miss
    miss_slot: int = 0     # table trash slot

    def lookup(self, keys: torch.Tensor) -> torch.Tensor:
        q = keys.to(torch.int32) - self.base
        if self.stride == 1:
            ok = (q >= 0) & (q < self.size)
            slot = q
        else:
            slot = torch.div(q, self.stride, rounding_mode="floor")
            ok = (q >= 0) & (torch.remainder(q, self.stride) == 0) \
                & (slot < self.size)
        return torch.where(ok, slot, torch.full_like(slot, self.miss_slot))


@dataclass
class SortedIndex:
    """Ordered key -> slot index: ``keys`` ascending (duplicates
    allowed), ``slots`` the row slot of each entry; a probe returns the
    first matching entry's slot or ``miss_slot``."""

    keys: torch.Tensor      # int32[n] ascending
    slots: torch.Tensor     # int32[n]
    n: int
    miss_slot: int

    @classmethod
    def build(cls, keys, slots, miss_slot: int, device=None
              ) -> "SortedIndex":
        """Entries sorted by key, stably (``deneva_tpu/storage/index.py:
        145``); ``keys`` and ``slots`` are numpy arrays or tensors."""
        keys = torch.as_tensor(keys, dtype=torch.int32, device=device)
        slots = torch.as_tensor(slots, dtype=torch.int32, device=keys.device)
        if keys.ndim != 1 or keys.shape != slots.shape:
            raise ValueError("SortedIndex.build takes two equal 1-d arrays")
        order = torch.sort(keys, stable=True).indices
        return cls(keys=keys[order].contiguous(),
                   slots=slots[order].contiguous(), n=int(keys.numel()),
                   miss_slot=int(miss_slot))

    def _lower(self, q: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(self.keys, q.to(torch.int32).contiguous(),
                                  side="left").to(torch.int32)

    def lookup_plain(self, q: torch.Tensor) -> torch.Tensor:
        """First slot whose key == q; misses -> miss_slot."""
        if self.n == 0:
            return torch.full(q.shape, self.miss_slot, dtype=torch.int32,
                              device=q.device)
        lo = torch.clamp(self._lower(q), 0, self.n - 1).long()
        hit = self.keys[lo] == q.to(torch.int32)
        return torch.where(hit, self.slots[lo],
                           torch.full_like(lo, self.miss_slot,
                                           dtype=torch.int32))

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        """K14b on a CUDA query tensor of any shape."""
        if kernels.on_cpu(q, self.keys):
            return self.lookup_plain(q)
        dev = self.keys.device
        kernels.check("keys", self.keys, torch.int32, (self.n,), dev)
        kernels.check("slots", self.slots, torch.int32, (self.n,), dev)
        kernels.check("q", q, torch.int32, device=dev)
        out = torch.empty_like(q)
        K14B_LOOKUP.launch(kernels.ptr(self.keys), kernels.ptr(self.slots),
                           self.n, kernels.ptr(q), q.numel(), self.miss_slot,
                           kernels.ptr(out), kernels.stream(q))
        return out
