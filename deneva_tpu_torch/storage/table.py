"""Device-resident tables (reference `storage/row.{h,cpp}`, `storage/table.{h,cpp}`).

The port's counterpart of ``deneva_tpu/storage/table.py``: one tensor per
column, indexed by slot id, with one extra **trash slot** at index
``capacity`` that masked writes steer to, and the row count padded to a
multiple of 64 past it.

Column representations follow the reference package, with one PyTorch
twist: a ``string`` column in fingerprint mode is the reference's uint32
word, held here as an **int32 tensor of the same bytes** (torch's uint32
arithmetic is thin, so the port keeps uint32 values as int32 bit
patterns and computes in int64 masked to 32 bits; the CUDA kernels read
them as ``uint32_t``).  ``full_row`` string columns are ``uint8[rows,
size]`` exactly as in the reference.

Unlike the reference's immutable arrays, the port writes columns in
place: a full-row YCSB table at paper scale is 16.8 GB, and a functional
copy per epoch would double it.

MVCC's per-row `VersionRing` lives here too, with **K12d**
`VersionRing.push` (``csrc/version.cu``), which replaces
``deneva_tpu/storage/table.py:257`` `push_rows`.  Its read side, K12c,
applies YCSB's value law and sits beside K3 in `workloads.ycsb`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.storage.catalog import TableSchema


def padded_rows(capacity: int) -> int:
    """Allocated row count for a table of ``capacity`` rows: the trash
    slot at ``capacity``, padded to a multiple of 64."""
    return -(-(capacity + 1) // 64) * 64


def _col_spec(ctype: str, size: int, full_row: bool
              ) -> tuple[torch.dtype, tuple, str]:
    """(torch dtype, extra shape, reference numpy dtype) for one column."""
    if ctype in ("int64_t", "uint64_t", "int32_t", "uint32_t"):
        return torch.int32, (), "int32"
    if ctype in ("double", "float"):
        return torch.float32, (), "float32"
    if ctype == "string":
        if full_row:
            return torch.uint8, (size,), "uint8"
        return torch.int32, (), "uint32"
    raise ValueError(f"unknown column type {ctype!r}")


@dataclass
class DeviceTable:
    """One table: dict of column tensors + insert cursor."""

    columns: dict[str, torch.Tensor]
    row_cnt: torch.Tensor        # int32 scalar: next free slot
    name: str
    capacity: int
    full_row: bool
    # column -> numpy dtype of the reference's column ("uint32" marks an
    # int32 tensor that holds uint32 bit patterns)
    ref_dtypes: dict[str, str] = field(default_factory=dict)

    @classmethod
    def create(cls, schema: TableSchema, capacity: int, device,
               full_row: bool = False) -> "DeviceTable":
        nrows = padded_rows(capacity)
        cols, ref = {}, {}
        for c in schema.columns:
            dtype, extra, ref[c.name] = _col_spec(c.ctype, c.size, full_row)
            cols[c.name] = torch.zeros((nrows, *extra), dtype=dtype,
                                       device=device)
        return cls(columns=cols,
                   row_cnt=torch.zeros((), dtype=torch.int32, device=device),
                   name=schema.name, capacity=capacity, full_row=full_row,
                   ref_dtypes=ref)

    def gather(self, slots: torch.Tensor, cols: tuple[str, ...] | None = None
               ) -> dict[str, torch.Tensor]:
        """Read fields of many rows.  Out-of-range slots read the trash."""
        slots = _sanitize(slots, self.capacity)
        names = cols if cols is not None else tuple(self.columns)
        return {n: self.columns[n][slots] for n in names}

    def scatter(self, slots: torch.Tensor, updates: dict[str, torch.Tensor],
                mask: torch.Tensor | None = None) -> "DeviceTable":
        """Masked last-write scatter, in place.  Masked-out and
        out-of-range slots steer to the trash row.  Duplicate slots follow
        torch's unspecified order, as the reference's follow XLA's:
        callers pre-resolve winners (`ops.scatter.last_writer`), so only
        the trash row receives duplicates."""
        slots = _sanitize(slots, self.capacity, mask).long()
        for n, v in updates.items():
            col = self.columns[n]
            col.index_put_((slots,), v.to(col.dtype))
        return self


def _sanitize(slots: torch.Tensor, capacity: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    slots = slots.to(torch.int32)
    bad = (slots < 0) | (slots > capacity)
    if mask is not None:
        bad = bad | ~mask.to(torch.bool)
    return torch.where(bad, torch.full_like(slots, capacity), slots)


def to_numpy_column(t: torch.Tensor, ref_dtype: str) -> np.ndarray:
    """Column bytes in the reference's numpy dtype."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if ref_dtype == "uint32" else a


K12D_PUSH = kernels.Kernel("dt_version_push", [
    kernels.P, kernels.I32, kernels.P, kernels.P, kernels.P, kernels.I32,
    kernels.P])


@dataclass
class VersionRing:
    """Per-row bounded overwrite-timestamp history of one column (port of
    ``deneva_tpu/storage/table.py:185``; reference `row_mvcc.cpp:172-196`).

    Entry ``(r, i)``, stored flat at ``r*H + i``, holds the serialization
    timestamp of a committed overwrite of row r; 0 is empty.  Commit
    timestamps rise, so the oldest entry is the row's minimum and a push
    overwrites it (first minimum; empties first).  A reader at t needs the
    version written at ``v* = max(entries <= t, default 0)`` (0 is the
    load-time base), whose value the workload rebuilds from its law.

    The reference steers masked lanes of `push_rows` onto the ring's
    last row (its trash row) with unspecified values; the port writes
    nothing for them, so that row stays 0.  Like the tables, the port's
    ring is written in place."""

    wts: torch.Tensor    # int32[R*H] (flat [row, ring slot], row-major)
    depth: int           # H

    @classmethod
    def create(cls, nrows: int, depth: int, device) -> "VersionRing":
        return cls(wts=torch.zeros(nrows * depth, dtype=torch.int32,
                                   device=device), depth=depth)

    def rows(self, slots: torch.Tensor) -> torch.Tensor:
        """The H ring entries of many rows: int32[..., H]."""
        h = self.depth
        base = slots.to(torch.int64)[..., None] * h \
            + torch.arange(h, dtype=torch.int64, device=slots.device)
        return self.wts[base]

    @staticmethod
    def version_from(vw: torch.Tensor, ts: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(v*, has_newer) per access from pre-gathered rows ``vw``
        (int32[..., H]): the timestamp that wrote the version current at
        ``ts`` (0 = load base), and whether a retained overwrite
        postdates ``ts``."""
        newer = vw > ts[..., None]
        vstar = torch.where(newer, 0, vw).amax(dim=-1)
        return vstar, newer.any(dim=-1)

    def select_version(self, slots: torch.Tensor, ts: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """`rows` + `version_from`."""
        return self.version_from(self.rows(slots), ts)

    def push_rows(self, vw: torch.Tensor, slots: torch.Tensor,
                  wts: torch.Tensor, mask: torch.Tensor) -> "VersionRing":
        """Plain K12d: record committed overwrites given pre-gathered rows
        ``vw`` (int32[N, H]) of ``slots``; each masked lane stores its
        ``wts`` at its row's first minimum.  Callers pass at most one
        masked lane per row (the last writer of the epoch)."""
        h = self.depth
        p = torch.argmin(vw, dim=-1)          # first minimum, as jnp.argmin
        at = (slots.to(torch.int64) * h + p)[mask]
        self.wts[at] = wts[mask].to(torch.int32)
        return self

    def push_plain(self, slots: torch.Tensor, wts: torch.Tensor,
                   mask: torch.Tensor) -> "VersionRing":
        """`rows` + `push_rows`, the reference's ``push``."""
        return self.push_rows(self.rows(slots), slots, wts, mask)

    def push(self, slots: torch.Tensor, wts: torch.Tensor,
             mask: torch.Tensor) -> "VersionRing":
        """K12d: each masked lane (one per row) re-reads its row, takes
        the first minimum and stores its ``wts`` there, in place."""
        if kernels.on_cpu(self.wts, slots, wts, mask):
            return self.push_plain(slots, wts, mask)
        n = slots.shape[0]
        dev = self.wts.device
        kernels.check("ring", self.wts, torch.int32, device=dev)
        kernels.check("slots", slots, torch.int32, (n,), dev)
        kernels.check("wts", wts, torch.int32, (n,), dev)
        kernels.check("mask", mask, torch.bool, (n,), dev)
        K12D_PUSH.launch(kernels.ptr(slots), n, kernels.ptr(wts),
                         kernels.ptr(mask), kernels.ptr(self.wts),
                         self.depth, kernels.stream(slots))
        return self
