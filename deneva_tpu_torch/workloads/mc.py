"""Partition-parallel execution over a mesh (port of ``deneva_tpu/workloads/mc.py``).

The reference's deployment model across devices, for every workload and
every backend: the epoch's batch and verdict are replicated, tables sit
in the owner-major layout (`storage.table.to_mc_layout`: block ``d``
holds the rows whose anchor is d mod D), and each shard runs the
workload's unchanged ``execute`` against a `McTableView` that turns
global slots into rows of its own block.  Non-owned lanes read 0 and
write nothing, so each shard does exactly its partition's work, and
the sum of the shards' read checksums is the one-device value.

The port runs the shard bodies one after another, in shard order, on
each shard's device.  The tables are written in place and every block
is a view of its stacked column, so a shard's writes land in the table;
shards write disjoint blocks, and replicated tables (ITEM, USES,
SUPPLIES) are only read.  The reference's contract for executors holds
here too: every gathered value reaches the stats through
``read_checksum`` (integer sums, exact across shards), every other
statistic derives from replicated inputs, and ring appends pass their
rows' ownership ``anchor``.
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.parallel.mesh import current_mesh
from deneva_tpu_torch.storage.table import DeviceTable


class McTableView:
    """A stacked `DeviceTable` seen from shard ``me``: global slots in,
    block-local rows out.  ``capacity`` stays the global trash id, so
    callers' sentinels and trash steering are unchanged; `_loc` folds
    the global trash, out-of-range and non-owned slots onto the block's
    trash row."""

    def __init__(self, tab: DeviceTable, me: int):
        self._tab = tab
        self.d_parts = tab.mc_parts
        self.anchor_rows = tab.anchor_rows
        self.me = me
        self.local = tab.block(me)

    @property
    def capacity(self) -> int:
        return self._tab.capacity

    def _loc(self, slots: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        slots = slots.to(torch.int32)
        a = slots // self.anchor_rows
        owned = ((slots >= 0) & (slots < self.capacity)
                 & (a % self.d_parts == self.me))
        loc = (a // self.d_parts) * self.anchor_rows \
            + slots % self.anchor_rows
        return torch.where(owned, loc, self.local.capacity), owned

    def gather(self, slots: torch.Tensor, cols: tuple[str, ...] | None = None
               ) -> dict[str, torch.Tensor]:
        """Rows of owned slots; 0 for every other lane (never the trash
        row), so the shards' contributions sum to the one-device gather."""
        loc, owned = self._loc(slots)
        out = self.local.gather(loc, cols)

        def zero(v):
            m = owned.reshape(owned.shape + (1,) * (v.ndim - owned.ndim))
            return torch.where(m, v, torch.zeros((), dtype=v.dtype,
                                                 device=v.device))
        return {n: zero(v) for n, v in out.items()}

    def scatter(self, slots, updates, mask=None) -> "McTableView":
        loc, _ = self._loc(slots)
        self.local.scatter(loc, updates, mask=mask)
        return self

    def scatter_add(self, slots, updates, mask=None) -> "McTableView":
        tab, loc = self.write_target(slots)
        tab.scatter_add(loc, updates, mask=mask)
        return self

    def write_target(self, slots) -> tuple[DeviceTable, torch.Tensor]:
        """(block, block-local rows) a write of ``slots`` lands at, as
        `storage.table.scatter_add_many` takes it."""
        loc, _ = self._loc(slots)
        return self.local, loc

    def append(self, rows, mask, anchor=None):
        """Rows whose ``anchor`` this shard owns, appended at its block's
        cursor; returns (view, block-local slots)."""
        if anchor is None:
            raise ValueError("an append under a mesh needs each row's "
                             "ownership anchor")
        m = mask & (anchor.to(torch.int32) % self.d_parts == self.me)
        _, slots = self.local.append(rows, m)
        return self, slots


def mc_execute(cfg, wl, db: dict, queries, commit: torch.Tensor,
               order: torch.Tensor, level: torch.Tensor, stats: dict,
               chained: bool, level_exec: bool = True,
               n_levels: int | None = None) -> dict:
    """One epoch's execution over the mesh
    (``deneva_tpu/workloads/mc.py:116``): each shard runs ``wl.execute``
    against its views, every level of a chained backend as a pass of its
    own (``n_levels`` passes, else ``exec_subrounds``), with
    ``level_exec`` as `engine.step._run_levels` takes it.  The read
    checksum is the ``psum`` of the shards'; the write count, computed
    from replicated masks, is shard 0's."""
    mesh = current_mesh()
    if mesh is None or mesh.size != cfg.device_parts:
        raise RuntimeError(f"mc_execute needs a use_mesh({cfg.device_parts})"
                           " context")
    cks, wcnt = [], None
    for me, dev in enumerate(mesh.devices):
        dbv = {n: (McTableView(t, me)
                   if isinstance(t, DeviceTable) and t.mc_parts > 1 else t)
               for n, t in db.items()}
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        st = {"read_checksum": zero, "write_cnt": zero}
        if chained:
            for lvl in range(cfg.exec_subrounds if n_levels is None
                             else n_levels):
                m = commit & (level == lvl)
                wl.execute(dbv, queries, m, order, st,
                           level_exec=level_exec)
        else:
            wl.execute(dbv, queries, commit, order, st)
        cks.append(st["read_checksum"])
        if wcnt is None:
            wcnt = st["write_cnt"]
    stats["read_checksum"] = mesh.psum([stats["read_checksum"]] + cks)
    stats["write_cnt"] = (stats["write_cnt"] + wcnt) & 0xFFFFFFFF
    return db
