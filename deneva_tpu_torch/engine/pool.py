"""Device-resident transaction pool (port of ``deneva_tpu/engine/pool.py``).

A fixed array of ``capacity`` slots replaces the reference's txn table,
work queue and abort queue.  Sequence numbers double as timestamps:
``next_seq`` advances by ``G + B`` per epoch, int32, guarded against wrap
by `engine.driver.run_simulation`.

Two modes, chosen once by ``batch == capacity``:

* **full pool** — one epoch spans the whole window, so refill, select
  and update are dense elementwise ops with no slot indexing;
* **partial pool** — refill admits up to G fresh queries into the free
  slots by a cumsum compaction, select takes the B runnable slots of
  lowest ``seq``, and update scatters the verdicts back to those slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

INT32_MAX = 2**31 - 1


@dataclass
class PoolState:
    queries: Any                # workload query batch, leaves [P, ...]
    ts: torch.Tensor            # int32[P]
    seq: torch.Tensor           # int32[P] arrival sequence (priority)
    abort_cnt: torch.Tensor     # int32[P]
    defer_cnt: torch.Tensor     # int32[P]
    ready_epoch: torch.Tensor   # int32[P]
    entry_epoch: torch.Tensor   # int32[P]
    occupied: torch.Tensor      # bool[P]
    next_seq: torch.Tensor      # int32 scalar


def _map_queries(q, fn):
    return type(q)(**{f: fn(getattr(q, f)) for f in q.__dataclass_fields__})


class TxnPool:
    """Static pool logic bound to (capacity P, epoch batch B, gen chunk G)."""

    def __init__(self, capacity: int, batch: int, gen_chunk: int,
                 backoff: bool, backoff_cap: int = 64):
        if capacity < batch:
            raise ValueError("pool capacity must cover the epoch batch")
        self.p = capacity
        self.b = batch
        self.g = gen_chunk
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        self.full_pool = batch == capacity
        if self.full_pool and gen_chunk != capacity:
            raise ValueError("full-pool mode requires batch == gen_chunk "
                             "== capacity")

    def create(self, empty_queries: Any, device) -> PoolState:
        def z(dtype=torch.int32):
            return torch.zeros(self.p, dtype=dtype, device=device)
        return PoolState(
            queries=empty_queries, ts=z(), seq=z(), abort_cnt=z(),
            defer_cnt=z(), ready_epoch=z(), entry_epoch=z(),
            occupied=z(torch.bool),
            # starts at 1: ts == 0 is reserved (the reference's MVCC
            # read-only serialization sentinel)
            next_seq=torch.ones((), dtype=torch.int32, device=device))

    def refill(self, pool: PoolState, new_queries: Any, epoch: torch.Tensor
               ) -> tuple[PoolState, torch.Tensor]:
        """Admit fresh queries into free slots.  Returns (pool, admitted)."""
        free = ~pool.occupied
        if self.full_pool:
            # one fresh query per slot: slot i admits new_queries[i]
            take = free
            pos = torch.arange(self.p, dtype=torch.int32, device=take.device)
            picked = new_queries
            occupied = torch.ones_like(pool.occupied)
        else:
            pos = torch.cumsum(free.to(torch.int32), 0,
                               dtype=torch.int32) - 1
            take = free & (pos < self.g)
            src = torch.clamp(pos, 0, self.g - 1).long()
            picked = _map_queries(new_queries, lambda t: t[src])
            occupied = pool.occupied | take

        def place(old, new):
            m = take.reshape((-1,) + (1,) * (old.ndim - 1))
            return torch.where(m, new, old)

        queries = type(pool.queries)(**{
            f: place(getattr(pool.queries, f), getattr(picked, f))
            for f in pool.queries.__dataclass_fields__})
        newseq = pool.next_seq + pos
        zero = torch.zeros_like(pool.abort_cnt)
        ep = epoch.expand_as(pool.ready_epoch)
        return PoolState(
            queries=queries,
            ts=torch.where(take, newseq, pool.ts),
            seq=torch.where(take, newseq, pool.seq),
            abort_cnt=torch.where(take, zero, pool.abort_cnt),
            defer_cnt=torch.where(take, zero, pool.defer_cnt),
            ready_epoch=torch.where(take, ep, pool.ready_epoch),
            entry_epoch=torch.where(take, ep, pool.entry_epoch),
            occupied=occupied,
            # static advance: G admissions + B potential restamps
            next_seq=pool.next_seq + (self.g + self.b),
        ), take.sum()

    def select(self, pool: PoolState, epoch: torch.Tensor):
        """The B runnable slots of lowest seq (oldest work first).
        Returns (slots, active, queries)."""
        runnable = pool.occupied & (pool.ready_epoch <= epoch)
        if self.full_pool:
            slots = torch.arange(self.p, dtype=torch.int32,
                                 device=runnable.device)
            return slots, runnable, pool.queries
        # the reference's lax.top_k(-key) orders ties by lower slot first;
        # torch.topk promises no tie order, a stable ascending sort does
        key = torch.where(runnable, pool.seq, INT32_MAX)
        idx = torch.sort(key, stable=True).indices[:self.b]
        return (idx.to(torch.int32), runnable[idx],
                _map_queries(pool.queries, lambda t: t[idx]))

    def update(self, pool: PoolState, slots: torch.Tensor,
               active: torch.Tensor, commit: torch.Tensor,
               abort: torch.Tensor, epoch: torch.Tensor,
               fresh_ts_on_restart: bool) -> PoolState:
        """Committed slots free; aborted slots back off exponentially;
        deferred slots stay runnable with their seq."""
        commit = commit & active
        abort = abort & active
        defer = active & ~commit & ~abort
        if self.full_pool:
            def sel(t):
                return t
        else:
            idx = slots.long()

            def sel(t):
                return t[idx]
        ac = sel(pool.abort_cnt) + abort.to(torch.int32)
        # an abort is a restart: the wait budget opens afresh
        dc = torch.where(abort, 0, sel(pool.defer_cnt)
                         + defer.to(torch.int32))
        if self.backoff:
            pen = torch.clamp_max(
                torch.ones_like(ac) << torch.clamp(ac - 1, 0, 30),
                self.backoff_cap)
        else:
            pen = torch.ones_like(ac)
        ready = torch.where(abort, epoch + 1 + pen,
                            sel(pool.ready_epoch)).to(torch.int32)
        ts = sel(pool.ts)
        if fresh_ts_on_restart:
            lane = torch.arange(self.b, dtype=torch.int32, device=ts.device)
            ts = torch.where(abort, pool.next_seq - self.b + lane, ts)
        occ = sel(pool.occupied) & ~commit
        if not self.full_pool:
            def put(t, v):
                t = t.clone()
                t[idx] = v
                return t
            ac, dc, ready, ts, occ = (
                put(pool.abort_cnt, ac), put(pool.defer_cnt, dc),
                put(pool.ready_epoch, ready), put(pool.ts, ts),
                put(pool.occupied, occ))
        return PoolState(
            queries=pool.queries, ts=ts, seq=pool.seq, abort_cnt=ac,
            defer_cnt=dc, ready_epoch=ready, entry_epoch=pool.entry_epoch,
            occupied=occ, next_seq=pool.next_seq)
