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

and ``tpcc_order_index``'s dynamic ORDER index:

* `DynamicSortedIndex` — a BIG-padded sorted array of static capacity
  that takes an epoch's inserts in one merge (``deneva_tpu/storage/
  index.py:217``).  ``insert`` runs as kernel **K14e merge**
  (``csrc/index.cu``), replacing ``:264``: the few new entries are
  ranked stably by key, then every live and every new entry finds its
  output position with one binary search in the other array, which is
  the stable sort of (live ++ new) the reference computes, cut to the
  capacity.  The count is advanced on the device.  Probes go through a
  `SortedIndex` view with ``n = cap``: ``lookup`` is K14b, and
  ``lookup_count``, ``range_slots`` and ``range_between``
  (``:168,193,202``) are kernel **K14e probes**: the lower bound (and
  for the count an upper bound), then a fixed-width window.
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

K14E_MERGE = kernels.Kernel("dt_index_merge", [
    kernels.P, kernels.P, kernels.I32, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.I32, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P])

K14E_PROBE = kernels.Kernel("dt_sorted_probe", [
    kernels.P, kernels.P, kernels.I32, kernels.P, kernels.P, kernels.I64,
    kernels.I32, kernels.I32, kernels.I32, kernels.P, kernels.P, kernels.P,
    kernels.P])
_PROBE_COUNT, _PROBE_RANGE, _PROBE_BETWEEN = 0, 1, 2
BIG = 2**31 - 1           # the padding key of a DynamicSortedIndex


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

    # -- count and range scans (``deneva_tpu/storage/index.py:168-215``)
    def lookup_count_plain(self, q: torch.Tensor) -> torch.Tensor:
        """Plain K14e probe: the number of entries with key == q."""
        q = q.to(torch.int32).contiguous()
        lo = self._lower(q)
        hi = torch.searchsorted(self.keys, q, side="right").to(torch.int32)
        return hi - lo

    def _window(self, q_lo: torch.Tensor, width: int):
        """(clipped positions, slots, in-bounds mask) of the ``width``
        entries with key >= q_lo."""
        start = self._lower(q_lo)
        pos = start[..., None] + torch.arange(width, dtype=torch.int32,
                                              device=start.device)
        ok = pos < self.n
        pos = torch.clamp(pos, 0, self.n - 1).long()
        slots = torch.where(ok, self.slots[pos],
                            torch.full_like(start[..., None],
                                            self.miss_slot))
        return pos, slots, ok

    def _empty_window(self, q_lo: torch.Tensor, width: int):
        shape = tuple(q_lo.shape) + (width,)
        return (torch.full(shape, self.miss_slot, dtype=torch.int32,
                           device=q_lo.device),
                torch.zeros(shape, dtype=torch.bool, device=q_lo.device))

    def range_slots_plain(self, q_lo: torch.Tensor, width: int):
        """Plain K14e probe: (slots[..., width], valid[..., width]) of the
        ``width`` entries with key >= q_lo (the B+-tree leaf walk);
        entries past the end are miss_slot and invalid."""
        if self.n == 0:
            return self._empty_window(q_lo, width)
        _, slots, ok = self._window(q_lo, width)
        return slots, ok

    def range_between_plain(self, q_lo: torch.Tensor, q_hi: torch.Tensor,
                            width: int):
        """Plain K14e probe: the window of keys in [q_lo, q_hi], capped
        at ``width``."""
        if self.n == 0:
            return self._empty_window(q_lo, width)
        pos, slots, ok = self._window(q_lo, width)
        inside = ok & (self.keys[pos] <= q_hi.to(torch.int32)[..., None])
        return torch.where(inside, slots,
                           torch.full_like(slots, self.miss_slot)), inside

    def _probe(self, mode: int, q_lo, q_hi=None, width: int = 0):
        dev = self.keys.device
        kernels.check("keys", self.keys, torch.int32, (self.n,), dev)
        kernels.check("slots", self.slots, torch.int32, (self.n,), dev)
        kernels.check("q", q_lo, torch.int32, device=dev)
        if q_hi is not None:
            kernels.check("q_hi", q_hi, torch.int32, tuple(q_lo.shape), dev)
        if width < 0:
            raise ValueError("width must be >= 0")
        # the count, or the window's slots and valid flags (the other
        # outputs are empty: the kernel writes only its mode's)
        win = (0,) if mode == _PROBE_COUNT else (*q_lo.shape, width)
        count = torch.empty(q_lo.shape if mode == _PROBE_COUNT else (0,),
                            dtype=torch.int32, device=dev)
        slots = torch.empty(win, dtype=torch.int32, device=dev)
        valid = torch.empty(win, dtype=torch.bool, device=dev)
        K14E_PROBE.launch(kernels.ptr(self.keys), kernels.ptr(self.slots),
                          self.n, kernels.ptr(q_lo),
                          None if q_hi is None else kernels.ptr(q_hi),
                          q_lo.numel(), width, mode, self.miss_slot,
                          kernels.ptr(count), kernels.ptr(slots),
                          kernels.ptr(valid), kernels.stream(q_lo))
        return count if mode == _PROBE_COUNT else (slots, valid)

    def lookup_count(self, q: torch.Tensor) -> torch.Tensor:
        """K14e probe on a CUDA query tensor of any shape."""
        if kernels.on_cpu(q, self.keys):
            return self.lookup_count_plain(q)
        return self._probe(_PROBE_COUNT, q)

    def range_slots(self, q_lo: torch.Tensor, width: int):
        """K14e probe: ``range_slots_plain`` on the card."""
        if kernels.on_cpu(q_lo, self.keys):
            return self.range_slots_plain(q_lo, width)
        return self._probe(_PROBE_RANGE, q_lo, width=width)

    def range_between(self, q_lo: torch.Tensor, q_hi: torch.Tensor,
                      width: int):
        """K14e probe: ``range_between_plain`` on the card."""
        if kernels.on_cpu(q_lo, q_hi, self.keys):
            return self.range_between_plain(q_lo, q_hi, width)
        return self._probe(_PROBE_BETWEEN, q_lo, q_hi, width)


@dataclass
class DynamicSortedIndex:
    """Ordered key -> slot index that takes batched inserts (port of
    ``deneva_tpu/storage/index.py:217``; the reference's latched B+-tree
    insert, `storage/index_btree.cpp:252-420`): a sorted array of static
    capacity padded with ``BIG`` keys.  An epoch's inserts merge in one
    call; entries past ``cap`` (the largest keys) drop, and ``cnt``
    counts every entry ever inserted, so ``cnt > cap`` marks an overflow
    the driver must surface (`overflowed`).  Duplicate keys are allowed;
    within a key, earlier entries come first."""

    keys: torch.Tensor      # int32[cap] ascending; BIG = free tail
    slots: torch.Tensor     # int32[cap]
    cnt: torch.Tensor       # int32 scalar: live entries (pre-clip total)
    cap: int
    miss_slot: int

    @classmethod
    def build(cls, keys, slots, miss_slot: int, cap: int, device=None
              ) -> "DynamicSortedIndex":
        """``deneva_tpu/storage/index.py:247``: the entries sorted stably
        by key (numpy), padded to ``cap``."""
        keys = np.asarray(keys, np.int32)
        slots = np.asarray(slots, np.int32)
        if keys.ndim != 1 or keys.shape != slots.shape:
            raise ValueError("DynamicSortedIndex.build takes two equal 1-d "
                             "arrays")
        if len(keys) > cap:
            raise ValueError("initial entries exceed capacity")
        if not (keys < BIG).all():
            raise ValueError("int32 max is the padding sentinel")
        order = np.argsort(keys, kind="stable")
        k = np.full(cap, BIG, np.int32)
        s = np.full(cap, miss_slot, np.int32)
        k[:len(keys)] = keys[order]
        s[:len(keys)] = slots[order]
        return cls(keys=torch.from_numpy(k).to(device),
                   slots=torch.from_numpy(s).to(device),
                   cnt=torch.tensor(len(keys), dtype=torch.int32,
                                    device=device),
                   cap=int(cap), miss_slot=int(miss_slot))

    def insert_plain(self, new_keys: torch.Tensor, new_slots: torch.Tensor,
                     mask: torch.Tensor) -> "DynamicSortedIndex":
        """Plain K14e merge, op for op from ``:264``: one stable sort of
        (live ++ new) by key, masked lanes carrying BIG, cut to ``cap``."""
        nk = torch.where(mask, new_keys.to(torch.int32),
                         torch.full_like(new_keys, BIG, dtype=torch.int32))
        ns = new_slots.to(torch.int32)
        allk = torch.cat([self.keys, nk.reshape(-1)])
        alls = torch.cat([self.slots, ns.reshape(-1)])
        order = torch.sort(allk, stable=True).indices[:self.cap]
        return DynamicSortedIndex(
            keys=allk[order], slots=alls[order],
            cnt=self.cnt + mask.sum(dtype=torch.int32),
            cap=self.cap, miss_slot=self.miss_slot)

    def insert(self, new_keys: torch.Tensor, new_slots: torch.Tensor,
               mask: torch.Tensor) -> "DynamicSortedIndex":
        """K14e merge: a new index holding the ``mask``-ed entries merged
        in, written into fresh buffers (this index is left as it was);
        the count advances on the device, with no host sync."""
        if kernels.on_cpu(new_keys, new_slots, mask, self.keys):
            return self.insert_plain(new_keys, new_slots, mask)
        dev = self.keys.device
        m = new_keys.numel()
        kernels.check("keys", self.keys, torch.int32, (self.cap,), dev)
        kernels.check("slots", self.slots, torch.int32, (self.cap,), dev)
        kernels.check("cnt", self.cnt, torch.int32, (), dev)
        nk, ns, nm = (t.reshape(-1) for t in (new_keys, new_slots, mask))
        kernels.check("new_keys", nk, torch.int32, (m,), dev)
        kernels.check("new_slots", ns, torch.int32, (m,), dev)
        kernels.check("mask", nm, torch.bool, (m,), dev)
        sk = torch.empty(m, dtype=torch.int32, device=dev)
        ss = torch.empty(m, dtype=torch.int32, device=dev)
        pop = torch.empty(1, dtype=torch.int32, device=dev)
        out_k = torch.empty_like(self.keys)
        out_s = torch.empty_like(self.slots)
        out_c = torch.empty_like(self.cnt)
        K14E_MERGE.launch(kernels.ptr(self.keys), kernels.ptr(self.slots),
                          self.cap, kernels.ptr(self.cnt), kernels.ptr(nk),
                          kernels.ptr(ns), kernels.ptr(nm), m,
                          kernels.ptr(sk), kernels.ptr(ss), kernels.ptr(pop),
                          kernels.ptr(out_k), kernels.ptr(out_s),
                          kernels.ptr(out_c), kernels.stream(nk))
        return DynamicSortedIndex(keys=out_k, slots=out_s, cnt=out_c,
                                  cap=self.cap, miss_slot=self.miss_slot)

    def overflowed(self) -> torch.Tensor:
        """bool scalar: more entries were inserted than ``cap`` holds.
        Past that, lookups may return slots of ring rows overwritten
        since, so the driver refuses the run (``:280``)."""
        return self.cnt > self.cap

    # probes: a SortedIndex over the padded arrays with n = cap; the BIG
    # padding sorts above every real key, so its bound checks cover it
    def _view(self) -> SortedIndex:
        return SortedIndex(keys=self.keys, slots=self.slots, n=self.cap,
                           miss_slot=self.miss_slot)

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        return self._view().lookup(q)

    def lookup_count(self, q: torch.Tensor) -> torch.Tensor:
        return self._view().lookup_count(q)

    def range_slots(self, q_lo: torch.Tensor, width: int):
        return self._view().range_slots(q_lo, width)

    def range_between(self, q_lo: torch.Tensor, q_hi: torch.Tensor,
                      width: int):
        return self._view().range_between(q_lo, q_hi, width)
