"""Workload interface (reference `system/wl.{h,cpp}`, `benchmarks/*_wl.*`).

As in ``deneva_tpu/workloads/base.py``, a workload is four functions over
whole epochs: ``load`` builds the device tables, ``generate`` draws a
batch of queries on the device, ``plan`` declares the padded RW-sets and
``execute`` applies the committed txns.  ``DB`` maps table names to
`DeviceTable`s.
"""

from __future__ import annotations

from typing import Any, Protocol

import torch

DB = dict


def partition_owned(key: torch.Tensor, n_parts: int, me: int
                    ) -> torch.Tensor:
    """bool mask: does this node own ``key`` under modulo striping
    (``deneva_tpu/workloads/base.py:39``; reference GET_NODE_ID,
    `system/global.h:294`)?"""
    if n_parts == 1:
        return torch.ones_like(key, dtype=torch.bool)
    return key % n_parts == me


def partition_slot(key: torch.Tensor, n_parts: int, me: int,
                   n_local: int) -> torch.Tensor:
    """Local storage slot of a striped global key
    (``deneva_tpu/workloads/base.py:58``); a key this node does not own
    resolves to ``n_local``, the table's trash row.  The port's stores
    write nothing there, so a gather through it reads the loader's
    value (0)."""
    if n_parts == 1:
        return key
    return torch.where(partition_owned(key, n_parts, me),
                       key // n_parts, n_local).to(key.dtype)


class Workload(Protocol):
    def load(self) -> DB: ...

    def empty_query(self, n: int, device) -> Any:
        """An all-zero query batch with leading dim n (the pool's initial
        contents)."""
        ...

    def generate(self, rng: torch.Tensor, n: int) -> Any:
        """Return a query batch with leading dim n."""
        ...

    def plan(self, db: DB, queries: Any) -> dict:
        """Return dict(table_ids, keys, is_read, is_write, valid) [n, A]."""
        ...

    def execute(self, db: DB, queries: Any, mask, order: torch.Tensor,
                stats: dict, fwd_rank=None, level_exec: bool = False) -> DB:
        """Apply txns to ``db``; update the device stats dict."""
        ...
