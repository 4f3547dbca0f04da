"""Transaction repair (port of ``deneva_tpu/engine/repair.py``).

A sweep backend's losers re-execute as chained sub-rounds inside the
same epoch instead of taking the retry queue.  Each of ``repair_rounds``
sub-rounds:

1. takes the backend's frontier (``CCBackend.repair_rule``: the losers'
   ordered reads of a bucket the committed set wrote, K13a; T/O adds the
   stale-read lanes);
2. re-runs the backend's own ``validate`` on the batch masked to the
   losers (fresh-ts backends restamp at ``repair_ts``; WAIT_DIE keeps its
   birth ts), on the cc state the previous round left;
3. re-executes the sub-round's winners through the workload's
   ``re_execute`` against the current tables, which hold every earlier
   wave's writes.

Serial order: the main round's winners, then round 1's, then round 2's,
each in its own verdict order. Salvaged txns move from abort to commit
before the pool update and the counters see them; after the last round
the leftovers fall back to the retry queue. Counters (uint32, wrapped as
ROADMAP.md watch item 1 says): ``rep_salvaged_cnt + rep_fallback_cnt``
is the epoch's repair-eligible losers and, without ``ycsb_abort_mode``,
aborts equal ``rep_fallback_cnt``.

The T/O watermarks and MVCC's ring are updated in place by K12b on the
card (watch item 16's in-place writes): a round's validate sees the main
round's and the earlier rounds' commits, and the next epoch sees all of
them. With ``repair=false`` nothing here runs.
"""

from __future__ import annotations

import dataclasses

import torch

MASK32 = 0xFFFFFFFF


def repair_ts(batch, ts_base=None) -> torch.Tensor:
    """Fresh per-lane stamps ``ts_base + lane`` (``repair.py:71``); without
    a base, one above every active stamp of the epoch."""
    lane = torch.arange(batch.ts.shape[0], dtype=torch.int32,
                        device=batch.ts.device)
    if ts_base is None:
        ts_base = torch.where(batch.active, batch.ts, 0).max() + 1
    return (ts_base + lane).to(torch.int32)


def run_repair(cfg, wl, be, db, queries, batch, inc, verdict, cc_state,
               stats, exec_commit, forced=None, ts_base=None,
               rounds_cap=None):
    """``cfg.repair_rounds`` sub-rounds over the epoch's losers
    (``repair.py:100``).  Returns ``(db, cc_state, verdict', salvaged,
    rounds)``: ``verdict'`` has the salvaged txns moved from abort to
    commit, ``rounds`` names each salvaged txn's sub-round (1-based).
    ``stats`` is updated in place; ``forced`` (ycsb_abort_mode) txns are
    final aborts and never salvaged.  ``rounds_cap`` is the control
    plane's knob, a host int: the rounds at or past it do nothing, as
    the reference's ``lax.cond`` skips them; None runs every round."""
    losers = verdict.abort & batch.active
    if forced is not None:
        losers = losers & ~forced
    committed = exec_commit & batch.active
    salvaged = torch.zeros_like(losers)
    rounds = torch.zeros_like(batch.rank)
    fresh = repair_ts(batch, ts_base)
    fcnt = stats["rep_frontier_cnt"]
    n_rounds = cfg.repair_rounds if rounds_cap is None \
        else max(0, min(cfg.repair_rounds, int(rounds_cap)))
    for rnd in range(n_rounds):
        frontier = be.repair_rule(cfg, cc_state, batch, inc, committed,
                                  losers)
        fcnt = (fcnt + frontier.sum()) & MASK32
        rb = dataclasses.replace(batch, active=losers)
        if be.fresh_ts_on_restart:
            rb = dataclasses.replace(rb, ts=torch.where(losers, fresh,
                                                        batch.ts))
        rv, cc_state = be.validate(cfg, cc_state, rb, inc)
        rep = rv.commit & losers
        db = wl.re_execute(db, queries, rep, rv.order, stats)
        salvaged = salvaged | rep
        rounds = torch.where(rep, rnd + 1, rounds)
        committed = committed | rep
        losers = losers & ~rep
    stats["rep_frontier_cnt"] = fcnt
    stats["rep_salvaged_cnt"] = (stats["rep_salvaged_cnt"]
                                 + salvaged.sum()) & MASK32
    stats["rep_fallback_cnt"] = (stats["rep_fallback_cnt"]
                                 + losers.sum()) & MASK32
    verdict = dataclasses.replace(verdict, commit=verdict.commit | salvaged,
                                  abort=verdict.abort & ~salvaged)
    return db, cc_state, verdict, salvaged, rounds
