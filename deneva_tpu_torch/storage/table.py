"""Device-resident tables (reference `storage/row.{h,cpp}`, `storage/table.{h,cpp}`).

The port's counterpart of ``deneva_tpu/storage/table.py``: one tensor per
column, indexed by slot id, with one extra **trash slot** at index
``capacity``, the slot of masked lanes and of keys another partition
owns (``part_cnt > 1``), and the row count padded to a multiple of 64
past it.  In a ``striped`` table (``part_cnt > 1``) no store of the
port writes the trash row: it keeps its loader value (0), which a gather
of a key this node does not own reads.

Column representations follow the reference package, with one PyTorch
twist: a ``string`` column in fingerprint mode is the reference's uint32
word, held here as an **int32 tensor of the same bytes** (torch's uint32
arithmetic is thin, so the port keeps uint32 values as int32 bit
patterns and computes in int64 masked to 32 bits; the CUDA kernels read
them as ``uint32_t``).  ``full_row`` string columns are ``uint8[rows,
size]`` exactly as in the reference.

Unlike the reference's immutable arrays, the port writes columns in
place: a full-row YCSB table at paper scale is 16.8 GB, and a functional
copy per epoch would double it.  A caller that reads a column and then
writes it (TPC-C's ``D_NEXT_O_ID``, ``S_QUANTITY``) gathers first, as
the reference's program order does; a gather returns a copy.

TPC-C's two batched writes are kernels (``csrc/table.cu``):

* **K14c** `DeviceTable.scatter_add` — replaces ``deneva_tpu/storage/
  table.py:126``: commutative adds of many lanes into many columns, exact
  under duplicate slots.  Integer columns add in any order; float
  columns add each slot's lanes **in lane order onto the old value**,
  as the reference's scatter-add does on the CPU, so float32 rows match
  it bit for bit (such a call groups its lanes by slot with a stable
  radix sort over the capacity's bits in one block, in chunks of up to
  4,096 lanes launched one after another); `scatter_add_many` takes up
  to three tables in one launch, a block each (TPC-C's Payment);
* **K14d** `DeviceTable.append` — replaces ``:137``: prefix-sum slots
  from the device-resident ``row_cnt`` (a ring table's cursor runs free
  and slots take ``% capacity``; otherwise rows past capacity drop and
  the cursor clamps), every column's row written, the cursor advanced.
  One block a tile of 2,048 lanes; a call of more tiles first counts
  each tile and copies the cursor to scratch.

Masked and out-of-range lanes of both write nothing.  The reference
steers them onto its trash row, whose value it leaves unspecified; the
port leaves that row alone, so only rows ``[0, capacity)`` compare.

A mesh (``device_parts = D > 1``) keeps its tables in the reference's
owner-major layout (`to_mc_layout`): block ``d`` of every column holds
the rows whose ownership anchor is d mod D, each block padded like a
table of its own with its last row as trash, and ``row_cnt`` holds one
cursor per block.  `DeviceTable.block` views one block as a table, so
writes through it land in the stacked columns.

MVCC's per-row `VersionRing` lives here too, with **K12d**
`VersionRing.push` (``csrc/version.cu``), which replaces
``deneva_tpu/storage/table.py:257`` `push_rows`.  Its read side, K12c,
applies YCSB's value law and sits beside K3 in `workloads.ycsb`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import ctypes

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
    ring: bool = False     # append wraps (windowed retention for insert-only
    #                        tables: HISTORY/ORDER/ORDER-LINE keep the last
    #                        `capacity` rows instead of growing unboundedly)
    # -- the owner-major layout of a mesh (to_mc_layout) --
    mc_parts: int = 1      # >1: columns hold mc_parts owner-major blocks
    #                        and row_cnt is int32[mc_parts]
    anchor_rows: int = 1   # rows per ownership anchor: owner(slot) =
    #                        (slot // anchor_rows) % mc_parts
    mc_replicated: bool = False  # read-only table every shard reads whole
    #                              (ITEM, USES, SUPPLIES)
    striped: bool = False  # part_cnt > 1: keys another partition owns
    #                        read the trash row, which no store writes

    @classmethod
    def create(cls, schema: TableSchema, capacity: int, device,
               full_row: bool = False, ring: bool = False,
               striped: bool = False) -> "DeviceTable":
        nrows = padded_rows(capacity)
        cols, ref = {}, {}
        for c in schema.columns:
            dtype, extra, ref[c.name] = _col_spec(c.ctype, c.size, full_row)
            cols[c.name] = torch.zeros((nrows, *extra), dtype=dtype,
                                       device=device)
        return cls(columns=cols,
                   row_cnt=torch.zeros((), dtype=torch.int32, device=device),
                   name=schema.name, capacity=capacity, full_row=full_row,
                   ref_dtypes=ref, ring=ring, striped=striped)

    def mc_block_rows(self) -> tuple[int, int, int]:
        """(rows, data rows, trash row) of each block of an owner-major
        table: a block's trash is its last padded row, a ring block's
        the row after its ``capacity // mc_parts`` data rows."""
        local, lb = mc_block_geometry(self.capacity, self.anchor_rows,
                                      self.mc_parts)
        if self.ring:
            local = self.capacity // self.mc_parts
            return lb, local, local
        return lb, local, lb - 1

    def block(self, d: int) -> "DeviceTable":
        """Block ``d`` of an owner-major table as a table of its own:
        every column a view of the block's rows and ``row_cnt`` a view of
        its cursor, so its writes land in this table.  Its capacity is
        its trash row (`mc_block_rows`)."""
        lb, _, cap = self.mc_block_rows()
        return DeviceTable(
            columns={n: v[d * lb:(d + 1) * lb]
                     for n, v in self.columns.items()},
            row_cnt=self.row_cnt[d], name=self.name, capacity=cap,
            full_row=self.full_row, ref_dtypes=self.ref_dtypes,
            ring=self.ring, striped=self.striped)

    def gather(self, slots: torch.Tensor, cols: tuple[str, ...] | None = None
               ) -> dict[str, torch.Tensor]:
        """Read fields of many rows.  Out-of-range slots read the trash."""
        slots = _sanitize(slots, self.capacity)
        names = cols if cols is not None else tuple(self.columns)
        return {n: self.columns[n][slots] for n in names}

    def scatter(self, slots: torch.Tensor, updates: dict[str, torch.Tensor],
                mask: torch.Tensor | None = None) -> "DeviceTable":
        """Masked last-write scatter, in place.  Masked-out and
        out-of-range slots steer to the trash row.  Callers pre-resolve
        winners (`ops.scatter.last_writer`), so no data row receives
        duplicates.  A ``striped`` table's trash row is read by the keys
        another partition owns: there those lanes store the row's own
        value back, so it keeps its loader value (the reference leaves it
        unspecified); elsewhere no gather reads it, and duplicates there
        follow torch's unspecified order."""
        slots = _sanitize(slots, self.capacity, mask).long()
        keep = slots < self.capacity if self.striped else None
        for n, v in updates.items():
            col = self.columns[n]
            v = v.to(col.dtype)
            if keep is not None:
                k = keep.reshape(keep.shape + (1,) * (v.ndim - keep.ndim))
                v = torch.where(k, v, col[self.capacity])
            col.index_put_((slots,), v)
        return self

    def _word_columns(self, updates: dict[str, torch.Tensor], n: int
                      ) -> tuple[list, list]:
        """(columns, values) of a kernel call: every column a contiguous
        4-byte column, every value a contiguous [n] tensor of its dtype."""
        if self.full_row:
            raise ValueError(f"{self.name}: K14c / K14d take 4-byte columns,"
                             " not full_row tables")
        cols, vals = [], []
        dev = self.row_cnt.device
        for name, v in updates.items():
            col = self.columns[name]
            kernels.check(name, col, col.dtype, device=dev)
            if col.dtype not in (torch.int32, torch.float32):
                raise TypeError(f"{name}: dtype {col.dtype}, expected int32 "
                                "or float32")
            v = v.to(col.dtype).reshape(-1).contiguous()
            kernels.check(f"{name} values", v, col.dtype, (n,), dev)
            cols.append(col)
            vals.append(v)
        if len(cols) > MAX_KERNEL_COLS:
            raise ValueError(f"{self.name}: at most {MAX_KERNEL_COLS} "
                             "columns per call")
        return cols, vals

    def scatter_add_plain(self, slots: torch.Tensor,
                          updates: dict[str, torch.Tensor],
                          mask: torch.Tensor | None = None) -> "DeviceTable":
        """Plain K14c, in place.  Integer columns take one ``index_add_``
        (exact in any order, wrapping as int32 does); a float column adds
        in rounds by each lane's rank among the lanes of its slot, so
        every slot sums its lanes one after another, in lane order, onto
        the old value."""
        slots = _sanitize(slots.reshape(-1), self.capacity,
                          None if mask is None else mask.reshape(-1))
        keep = slots < self.capacity
        s = slots[keep].long()
        rank = None
        for name, v in updates.items():
            col = self.columns[name]
            v = v.reshape(-1).to(col.dtype)[keep]
            if not col.dtype.is_floating_point:
                col.index_add_(0, s, v)
                continue
            if rank is None:
                rank = _rank_in_slot(s)
                rounds = int(rank.max()) + 1 if rank.numel() else 0
            for r in range(rounds):
                at = rank == r
                col[s[at]] = col[s[at]] + v[at]
        return self

    def scatter_add(self, slots: torch.Tensor,
                    updates: dict[str, torch.Tensor],
                    mask: torch.Tensor | None = None) -> "DeviceTable":
        """K14c: commutative read-modify-write of many lanes (balance +=
        x, count += 1), in place, exact under duplicate slots; masked
        and out-of-range lanes add nothing.  One launch for all of the
        call's columns."""
        if kernels.on_cpu(slots, self.row_cnt):
            return self.scatter_add_plain(slots, updates, mask)
        _scatter_add_kernel([(self, slots, updates)], mask)
        return self

    def write_target(self, slots: torch.Tensor
                     ) -> tuple["DeviceTable", torch.Tensor]:
        """(table, slots) that a write of ``slots`` through this table
        lands at: itself (`workloads.mc.McTableView` maps to its block)."""
        return self, slots

    def append_plain(self, rows: dict[str, torch.Tensor], mask: torch.Tensor,
                     anchor: torch.Tensor | None = None
                     ) -> tuple["DeviceTable", torch.Tensor]:
        """Plain K14d, op for op from ``deneva_tpu/storage/table.py:137``;
        writes rows and ``row_cnt`` in place.  Returns (table, slots),
        the trash slot for lanes that write nothing."""
        m = mask.reshape(-1).to(torch.int32)
        offs = torch.cumsum(m, 0, dtype=torch.int32) - m
        slots = self.row_cnt + offs          # int32: a ring cursor wraps
        total = m.sum().to(torch.int32)
        trash = torch.full_like(slots, self.capacity)
        if self.ring:
            slots = torch.where(m > 0, torch.remainder(slots, self.capacity),
                                trash)
            new_cnt = self.row_cnt + total
        else:
            slots = torch.where((m > 0) & (slots < self.capacity), slots,
                                trash)
            new_cnt = torch.clamp_max(self.row_cnt + total, self.capacity)
        keep = slots < self.capacity
        at = slots[keep].long()
        for name, v in rows.items():
            col = self.columns[name]
            col[at] = v.reshape(-1).to(col.dtype)[keep]
        self.row_cnt.copy_(new_cnt)
        return self, slots

    def append(self, rows: dict[str, torch.Tensor], mask: torch.Tensor,
               anchor: torch.Tensor | None = None
               ) -> tuple["DeviceTable", torch.Tensor]:
        """K14d: insert up to len(mask) rows at prefix-sum slots from
        ``row_cnt`` (`table_t::get_new_row` without the latch); returns
        (table, slots).  ``anchor``, each row's ownership anchor, is read
        only by `workloads.mc.McTableView.append`; executors pass it
        always, so one body serves both layouts."""
        if kernels.on_cpu(mask, self.row_cnt):
            return self.append_plain(rows, mask)
        n = mask.numel()
        dev = self.row_cnt.device
        mask = mask.reshape(-1)
        kernels.check("mask", mask, torch.bool, (n,), dev)
        kernels.check("row_cnt", self.row_cnt, torch.int32, (), dev)
        cols, vals = self._word_columns(rows, n)
        slots = torch.empty(n, dtype=torch.int32, device=dev)
        tiles = -(-n // APPEND_TILE)
        # more than one tile: each tile's count and a copy of the cursor
        scratch = torch.empty(tiles + 1, dtype=torch.int32, device=dev) \
            if tiles > 1 else None
        K14D_APPEND.launch(kernels.ptr(mask), n, kernels.ptr(self.row_cnt),
                           self.capacity, int(self.ring), len(cols),
                           _ptr_array(cols), _ptr_array(vals),
                           None if scratch is None else kernels.ptr(scratch),
                           0 if scratch is None else scratch.numel(),
                           kernels.ptr(slots), kernels.stream(mask))
        return self, slots


MC_CHUNK = 1 << 22      # rows `to_mc_layout` moves at a time


def mc_block_geometry(capacity: int, anchor_rows: int, d_parts: int
                      ) -> tuple[int, int]:
    """(data rows per block, padded rows per block) of the owner-major
    layout (``deneva_tpu/storage/table.py:283``): ``capacity //
    anchor_rows`` anchors dealt round-robin over ``d_parts`` blocks, each
    block padded like a table of its own, its last row its trash."""
    r = anchor_rows
    if capacity % r != 0:
        raise ValueError(f"capacity {capacity} not a multiple of "
                         f"anchor_rows {r}")
    anchors = capacity // r
    if anchors % d_parts != 0:
        raise ValueError(f"{anchors} ownership anchors do not divide over "
                         f"{d_parts} device partitions")
    local_rows = (anchors // d_parts) * r
    return local_rows, padded_rows(local_rows)


def to_mc_layout(tab: DeviceTable, d_parts: int, anchor_rows: int = 1
                 ) -> DeviceTable:
    """The owner-major layout of a loaded table
    (``deneva_tpu/storage/table.py:304``): block ``d`` (rows ``[d * lb,
    (d + 1) * lb)`` of every column) holds the rows whose anchor is d mod
    ``d_parts``, in anchor order, and its pad rows read the (zero) trash
    row.  A ring table starts empty with one cursor per block;
    ``row_cnt`` becomes int32[d_parts] either way.  It consumes ``tab``:
    columns move over one at a time, in chunks, so the peak is one
    column more."""
    r = anchor_rows
    local_rows, lb = mc_block_geometry(tab.capacity, r, d_parts)
    dev = tab.row_cnt.device
    cols = {}
    for name in list(tab.columns):
        v = tab.columns.pop(name)
        out = torch.zeros((d_parts * lb, *v.shape[1:]), dtype=v.dtype,
                          device=dev)
        if not tab.ring:
            for lo in range(0, d_parts * lb, MC_CHUNK):
                pos = torch.arange(lo, min(lo + MC_CHUNK, d_parts * lb),
                                   dtype=torch.int64, device=dev)
                d, j = pos // lb, pos % lb
                src = ((j // r) * d_parts + d) * r + j % r
                src = torch.where(j < local_rows, src, tab.capacity)
                out[lo:lo + pos.shape[0]] = v[src]
        cols[name] = out
    cnt = 0 if tab.ring else local_rows
    return DeviceTable(
        columns=cols, row_cnt=torch.full((d_parts,), cnt, dtype=torch.int32,
                                         device=dev),
        name=tab.name, capacity=tab.capacity, full_row=tab.full_row,
        ref_dtypes=tab.ref_dtypes, ring=tab.ring, mc_parts=d_parts,
        anchor_rows=r, striped=tab.striped)


def mc_stacked_rows(tab: DeviceTable) -> torch.Tensor:
    """int64[capacity]: where global row g of a stacked (non-ring) table
    lies in its owner-major columns, the inverse of `to_mc_layout`."""
    r, d_parts = tab.anchor_rows, tab.mc_parts
    lb = tab.mc_block_rows()[0]
    g = torch.arange(tab.capacity, dtype=torch.int64,
                     device=tab.row_cnt.device)
    a = g // r
    return (a % d_parts) * lb + (a // d_parts) * r + g % r


def fill_columns(tab: DeviceTable, n: int, cols: dict) -> DeviceTable:
    """Loader helper (``deneva_tpu/storage/table.py:332``): set the first
    ``n`` rows of the named columns and set ``row_cnt`` to ``n``."""
    for name, v in cols.items():
        col = tab.columns[name]
        col[:n] = torch.as_tensor(v).to(device=col.device, dtype=col.dtype)
    tab.row_cnt.fill_(n)
    return tab


def scatter_add_many_plain(calls, mask: torch.Tensor | None = None) -> None:
    """Plain `scatter_add_many`: `DeviceTable.scatter_add_plain` per
    table, in the order given."""
    for tab, slots, updates in calls:
        tab, slots = tab.write_target(slots)
        tab.scatter_add_plain(slots, updates, mask)


def scatter_add_many(calls, mask: torch.Tensor | None = None) -> None:
    """K14c over several tables in one launch, one block a table:
    ``calls`` is up to three ``(table, slots, updates)`` whose columns are
    disjoint (TPC-C's Payment: WAREHOUSE, DISTRICT, CUSTOMER), every
    ``slots`` one lane per entry of the shared ``mask``.  Tables may be
    `DeviceTable` or `workloads.mc.McTableView` (through
    ``write_target``).  The same result as the tables' ``scatter_add``
    calls in any order."""
    calls = [(*tab.write_target(slots), updates)
             for tab, slots, updates in calls]
    if len(calls) > MAX_ADD_TABLES:
        raise ValueError(f"scatter_add_many: at most {MAX_ADD_TABLES} "
                         f"tables per launch, got {len(calls)}")
    cols = [tab.columns[c].data_ptr() for tab, _, up in calls for c in up]
    if len(set(cols)) != len(cols):
        raise ValueError("scatter_add_many: a column appears twice")
    if kernels.on_cpu(*[slots for _, slots, _ in calls],
                      *[tab.row_cnt for tab, _, _ in calls]):
        scatter_add_many_plain(calls, mask)
        return
    _scatter_add_kernel(calls, mask)


def _scatter_add_kernel(calls, mask: torch.Tensor | None) -> None:
    """One K14c launch over ``calls`` (``(DeviceTable, slots, updates)``,
    the slots of one length)."""
    n = calls[0][1].numel()
    dev = calls[0][0].row_cnt.device
    if mask is not None:
        mask = mask.reshape(-1)
        kernels.check("mask", mask, torch.bool, (n,), dev)
    slot_ts, caps, ks, cols, vals = [], [], [], [], []
    for tab, slots, updates in calls:
        slots = slots.reshape(-1)
        kernels.check(f"{tab.name} slots", slots, torch.int32, (n,), dev)
        c, v = tab._word_columns(updates, n)
        if any(col.shape[0] <= tab.capacity for col in c):
            # the kernel reads the trash row at `capacity` for dropped lanes
            raise ValueError(f"{tab.name}: K14c needs a row at capacity")
        slot_ts.append(slots)
        caps.append(tab.capacity)
        ks.append(len(c))
        cols += c
        vals += v
    t = len(calls)
    K14C_SCATTER_ADD.launch(
        t, _ptr_array(slot_ts), None if mask is None else kernels.ptr(mask),
        n, _int_array(caps), _int_array(ks), _ptr_array(cols),
        _ptr_array(vals),
        _int_array([int(c.dtype == torch.float32) for c in cols]),
        kernels.stream(slot_ts[0]))


def _rank_in_slot(s: torch.Tensor) -> torch.Tensor:
    """Each lane's position among the lanes of its slot, in lane order."""
    n = s.numel()
    order = torch.sort(s, stable=True).indices
    ss = s[order]
    lane = torch.arange(n, dtype=torch.int64, device=s.device)
    head = torch.ones(n, dtype=torch.bool, device=s.device)
    head[1:] = ss[1:] != ss[:-1]
    pos = lane - torch.cummax(torch.where(head, lane, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos
    return rank


def _ptr_array(ts: list[torch.Tensor]) -> ctypes.c_void_p:
    """A host array of device pointers (the cast keeps it alive)."""
    arr = (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])
    return ctypes.cast(arr, ctypes.c_void_p)


def _int_array(xs: list[int]) -> ctypes.c_void_p:
    """A host array of ints (the cast keeps it alive)."""
    arr = (ctypes.c_int * max(len(xs), 1))(*xs)
    return ctypes.cast(arr, ctypes.c_void_p)


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


MAX_KERNEL_COLS = 16      # columns one K14c / K14d call takes per table
MAX_ADD_TABLES = 3        # tables one K14c launch takes (csrc kMaxTabs)
K14C_SCATTER_ADD = kernels.Kernel("dt_scatter_add", [
    kernels.I32, kernels.P, kernels.P, kernels.I32, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P, kernels.P])
K14D_APPEND = kernels.Kernel("dt_append", [
    kernels.P, kernels.I32, kernels.P, kernels.I32, kernels.I32, kernels.I32,
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.P, kernels.P])
# lanes a K14d block takes (csrc/table.cu kAppendTile, which refuses a
# scratch shorter than its tiles + 1)
APPEND_TILE = 2048

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
