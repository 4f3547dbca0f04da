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
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

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
