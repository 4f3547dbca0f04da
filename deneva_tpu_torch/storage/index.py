"""Indexes: key -> slot (reference `storage/index_hash.{h,cpp}`, `index_btree`).

The port carries YCSB's two primary indexes:

* `DenseIndex` — the affine key -> slot map (`benchmarks/ycsb_wl.cpp:
  70-74`, ``deneva_tpu/storage/index.py:34``), plain PyTorch;
* `SortedIndex` — the ordered index of ``INDEX_STRUCT=IDX_BTREE``
  (``deneva_tpu/storage/index.py:121``): a sorted key array probed by
  binary search.  ``lookup`` runs as kernel **K14b** (``csrc/index.cu``),
  replacing ``:155-166`` `_lower` and `lookup`: one thread per query, a
  branchless lower bound, the hit test, the slot or the miss slot.

and TPC-C's secondary index:

* `HashIndex` — the open-addressing key -> slot map
  (``deneva_tpu/storage/index.py:48``), built on the host with the
  reference's numpy builder (`_hash_np`, a copy of ``:310``) and probed
  on the device.  ``lookup`` runs as kernel **K14a** (``csrc/index.cu``),
  replacing ``:97`` `HashIndex.lookup`: one thread per probe walks at
  most ``max_probe`` cells and stops at a hit or an empty cell, so a
  key not found within ``max_probe`` cells misses, as the reference's
  fixed-depth loop gives.  TPC-C's CUSTOMER_LAST index is one.

`SortedIndex`'s count and range scans and `DynamicSortedIndex` have no
caller but ``tpcc_order_index`` (ROADMAP.md queue 1, item 15a).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.ops.hashing import mul32

_EMPTY = -1
_MULT = 2654435761  # Knuth multiplicative hash

K14A_LOOKUP = kernels.Kernel("dt_hash_lookup", [
    kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.P, kernels.I64,
    kernels.I32, kernels.P, kernels.P])

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
class HashIndex:
    """Open-addressing key -> slot map; ``keys`` holds -1 in a free cell."""

    keys: torch.Tensor      # int32[cap]
    slots: torch.Tensor     # int32[cap]
    cap: int                # power of two
    max_probe: int
    miss_slot: int

    @classmethod
    def build(cls, keys, slots, miss_slot: int, load_factor: float = 0.5,
              device=None) -> "HashIndex":
        """The reference's vectorized host build (``deneva_tpu/storage/
        index.py:59``): entries sorted stably by home bucket take
        ``pos = max(home, prev_pos + 1)`` — the table sequential
        insertion in home-bucket order builds — and the table doubles
        while a cluster runs past its end."""
        keys = np.asarray(keys, np.int32)
        slots = np.asarray(slots, np.int32)
        if keys.ndim != 1 or keys.shape != slots.shape:
            raise ValueError("HashIndex.build takes two equal 1-d arrays")
        if not np.all(keys >= 0):
            raise ValueError("negative keys are reserved")
        if len(np.unique(keys)) != len(keys):
            raise ValueError("duplicate keys in unique HashIndex")
        cap = 1
        while cap < max(8, int(len(keys) / load_factor)):
            cap *= 2
        while True:
            h = _hash_np(keys, cap).astype(np.int64)
            order = np.argsort(h, kind="stable")
            hs = h[order]
            lane = np.arange(len(hs), dtype=np.int64)
            pos = np.maximum.accumulate(hs - lane) + lane
            if len(pos) == 0 or pos.max() < cap:
                break
            cap *= 2
        tab_k = np.full(cap, _EMPTY, np.int32)
        tab_s = np.zeros(cap, np.int32)
        tab_k[pos] = keys[order]
        tab_s[pos] = slots[order]
        max_probe = int((pos - hs).max()) + 1 if len(pos) else 1
        return cls(keys=torch.from_numpy(tab_k).to(device),
                   slots=torch.from_numpy(tab_s).to(device), cap=cap,
                   max_probe=max(8, max_probe), miss_slot=int(miss_slot))

    def lookup_plain(self, q: torch.Tensor) -> torch.Tensor:
        """Plain K14a, op for op from ``deneva_tpu/storage/index.py:97``."""
        q = q.to(torch.int32)
        start = _hash_torch(q, self.cap)
        found = torch.full_like(q, self.miss_slot)
        done = torch.zeros_like(q, dtype=torch.bool)
        for p in range(self.max_probe):
            pos = ((start + p) & (self.cap - 1)).long()
            k = self.keys[pos]
            hit = (k == q) & ~done
            found = torch.where(hit, self.slots[pos], found)
            done = done | hit | (k == _EMPTY)
        return found

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        """K14a on a CUDA query tensor of any shape."""
        if kernels.on_cpu(q, self.keys):
            return self.lookup_plain(q)
        dev = self.keys.device
        kernels.check("keys", self.keys, torch.int32, (self.cap,), dev)
        kernels.check("slots", self.slots, torch.int32, (self.cap,), dev)
        kernels.check("q", q, torch.int32, device=dev)
        out = torch.empty_like(q)
        K14A_LOOKUP.launch(kernels.ptr(self.keys), kernels.ptr(self.slots),
                           self.cap, self.max_probe, kernels.ptr(q),
                           q.numel(), self.miss_slot, kernels.ptr(out),
                           kernels.stream(q))
        return out


def _hash_np(k: np.ndarray, cap: int) -> np.ndarray:
    """Home bucket (``deneva_tpu/storage/index.py:310``): a full-width
    avalanche (lowbias32-style), then the mask."""
    x = k.astype(np.uint32) * np.uint32(_MULT)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x.astype(np.int64) & (cap - 1)


def _hash_torch(k: torch.Tensor, cap: int) -> torch.Tensor:
    """`_hash_np` on int32 tensors, in int64 masked to 32 bits
    (``deneva_tpu/storage/index.py:324`` `_hash_jnp`)."""
    x = mul32(k.to(torch.int64) & 0xFFFFFFFF, _MULT)
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x & (cap - 1)).to(torch.int32)


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
