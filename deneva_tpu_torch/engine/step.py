"""The epoch step and its loop (port of ``deneva_tpu/engine/step.py``).

One epoch, over a full pool (``epoch_batch == max_txn_in_flight``) or a
partial one:

    1. split the rng (K4a); generate fresh queries (K4b); refill the pool
    2. select the batch (identity over a full pool, else the B oldest
       runnable slots, whose pool fields the step gathers)
    3. plan the RW-sets
    4. validate, by one of three routes:
       - TPU_BATCH / CALVIN on YCSB under ``mode=NORMAL``:
         forward_verdict sorts the lanes (K1) and scans the plan (K2);
         everything commits;
       - the backend's validate (OCC, NO_WAIT, WAIT_DIE, TIMESTAMP,
         MVCC, MAAT; TPU_BATCH / CALVIN under SIMPLE and QRY_ONLY):
         hashed incidence (K5+K6), overlap (K7), then first-fit sweep
         (K8); T/O checks (K12a) and records (K12b) its watermarks,
         carried across epochs in ``cc_state``; MAAT adds the level gate
         (K9b), closure and peel (K11a, K11b); CALVIN / TPU_BATCH the
         wavefront levels (K9a); DGCC the lane sort (K15a), its census
         (K15b) and the wave relaxation (K16); then the defer budget;
       - NOCC (``cc_alg`` or ``mode``): everything commits
    5. execute: the forwarding plan (K3); TPU_BATCH / CALVIN on a
       workload whose writes read (TPC-C), and DGCC, through the chained
       executor, one masked pass per level; or the masked arm with the
       last-writer resolution (K10) and, under MVCC, the version ring
       (K12c reads, K12d pushes); nothing under SIMPLE and QRY_ONLY
    5b. with ``repair``: the sweep's losers re-validate and re-execute
       in ``repair_rounds`` sub-rounds (`engine.repair`, K13a)
    5c. with ``audit``: the committed set's dependency observations and
       the audit stamp tables (`cc.audit_observe`: K17, K15a, K15c)
    6. update the pool and the device counters (plain PyTorch)

Under ``device_parts > 1`` (inside `parallel.use_mesh`) step 5 runs over
the mesh: the forwarding path plans per shard in ``execute_mc`` (K18a,
K18b, then K1-K3 per shard), whose capacity defers give the verdict
after the execute (`ops.forward.mc_defer_verdict`); every other path
runs the workload's executor once per shard (`workloads.mc.mc_execute`)
on the replicated verdict.

Between 4 and 5, ``audit_mutate`` flips the window's clean OCC losers
(K13a's launch on the write lanes) and ``metrics`` adds the epoch's
per-partition conflict density (K13b) to its counter.

Under ``ctrl`` the driver steps with the contention router's knobs
(`cc.router.RouterKnobs`, `Engine.run_ctrl`): sections 4-5 become the
uniform branch of the backend every partition is assigned (NO_WAIT /
OCC through the sweep with repair under the knobs' cap, TPU_BATCH
forwarding or chained, DGCC under ``ctrl_dgcc``) or the mixed branch,
whose cross-group defers are K21; the branch is picked on the host.

The reference scans this step under ``lax.scan``; here `Engine.run` is a
Python loop that enqueues epochs on the device without a host sync.
Device counters are the reference's uint32 scalars, held as int64 in
[0, 2^32) and wrapped after every update.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.cc import (AUDIT_KEY, AccessBatch, audit_levels,
                                 audit_mutate_verdict, audit_observe,
                                 build_conflict_incidence, gate_order_free,
                                 get_backend)
from deneva_tpu_torch.cc import base as cc_base
from deneva_tpu_torch.config import CCAlg, Config, Mode
from deneva_tpu_torch.engine.pool import PoolState, TxnPool
from deneva_tpu_torch.engine.repair import run_repair
from deneva_tpu_torch.ops import (forward_verdict, forwarding_applies,
                                  mc_defer_verdict, prng)
from deneva_tpu_torch.workloads.mc import mc_execute

LAT_BUCKETS = 64
RETRY_BUCKETS = 8
MASK32 = 0xFFFFFFFF


def forced_sentinel_mask(batch) -> torch.Tensor:
    """YCSB_ABORT_MODE (reference `config.h:103`): a txn whose RW-set
    touches key 0 logically aborts once, leaving the batch before
    dependency resolution."""
    return ((batch.keys == 0) & batch.valid).any(dim=1) & batch.active


@dataclass
class EngineState:
    db: Any                 # dict[str, DeviceTable]
    cc_state: Any
    pool: PoolState
    rng: torch.Tensor       # int64[2]: the raw threefry key
    epoch: torch.Tensor     # int32 scalar
    stats: dict             # str -> int64 tensor of uint32 counts


def init_device_stats(n_txn_types: int = 1, n_parts: int = 1,
                      device=None) -> dict:
    """The reference's device counters (``step.py:75``), same keys and
    shapes; every entry int64 holding a uint32 count."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)
    stats = {"conflict_density": z(max(n_parts, 1))}
    for k in ("generated_cnt", "admitted_cnt", "total_txn_commit_cnt",
              "total_txn_abort_cnt", "unique_txn_abort_cnt", "defer_cnt",
              "write_cnt", "read_checksum"):
        stats[k] = z()
    stats["latency_hist"] = z(n_txn_types, LAT_BUCKETS)
    stats["retry_hist"] = z(RETRY_BUCKETS)
    stats["wait_hist"] = z(RETRY_BUCKETS)
    # transaction repair's, the audit plane's and DGCC's counters: they
    # stay 0 unless their plane is armed
    for k in ("rep_salvaged_cnt", "rep_frontier_cnt", "rep_fallback_cnt",
              "audit_edge_cnt", "audit_drop_cnt", "audit_wit_cnt",
              "dgcc_wave_cnt", "dgcc_wave_max", "dgcc_fallback_cnt",
              "dgcc_edge_cnt"):
        stats[k] = z()
    stats["commit_by_type"] = z(n_txn_types)
    stats["abort_by_type"] = z(n_txn_types)
    return stats


def _acc(stats: dict, key: str, delta) -> None:
    stats[key] = (stats[key] + delta) & MASK32


def _run_levels(cfg, wl, db, queries, exec_commit, verdict, stats,
                level_exec: bool = True, n_levels: int | None = None):
    """Chained sub-round execution (``deneva_tpu/engine/step.py:141``):
    level-l txns run after every write of levels < l, each pass gathering
    from the tables the previous passes wrote.

    The reference's ``lax.while_loop`` runs ``max committed level + 1``
    passes; learning that depth here would sync the host, so the port
    runs every level the backend can give: ``exec_subrounds`` for
    ``validate_calvin``, ``n_levels = dgcc_levels`` for DGCC (its waves go
    up to ``dgcc_levels - 1``; stopping at ``exec_subrounds`` would count
    the deeper waves as commits and drop their writes: ROADMAP.md watch
    item 24).  A pass above the deepest level has an empty
    mask, and an empty pass writes no table row and adds 0 to every
    counter, so the result is the reference's.  ``level_exec`` lets the
    executor take every valid write lane of a level as its final writer
    (no K10); DGCC's waves carry several writers of a key and pass
    False."""
    for lvl in range(cfg.exec_subrounds if n_levels is None else n_levels):
        m = exec_commit & (verdict.level == lvl)
        db = wl.execute(db, queries, m, verdict.order, stats,
                        level_exec=level_exec)
    return db, stats


def count_by_type(stats: dict, wl, queries, commit, abort) -> None:
    """Fold per-type commit/abort one-hots into the device stats."""
    tt = wl.txn_type_of(queries)
    n = stats["commit_by_type"].shape[0]
    onehot = tt[:, None] == torch.arange(n, dtype=torch.int32,
                                         device=tt.device)[None, :]
    _acc(stats, "commit_by_type", (onehot & commit[:, None]).sum(dim=0))
    _acc(stats, "abort_by_type", (onehot & abort[:, None]).sum(dim=0))


class Engine:
    """Binds (config, workload, backend) into the epoch step."""

    def __init__(self, cfg: Config, workload, device=None):
        self.cfg = cfg
        self.workload = workload
        self.device = kernels.resolve_device(
            workload.device if device is None else device)
        self.backend = get_backend(cfg.cc_alg)
        cap = max(cfg.max_txn_in_flight, cfg.epoch_batch)
        self.pool = TxnPool(capacity=cap, batch=cfg.epoch_batch,
                            gen_chunk=cfg.epoch_batch, backoff=cfg.backoff)

    def init_state(self, seed: int | None = None) -> EngineState:
        cfg, dev = self.cfg, self.device
        db = self.workload.load()
        empty_q = self.workload.empty_query(self.pool.p, dev)
        return EngineState(
            db=db, cc_state=self.backend.init_state(cfg, dev),
            pool=self.pool.create(empty_q, dev),
            rng=prng.key_from_seed(cfg.seed if seed is None else seed, dev),
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            stats=init_device_stats(len(self.workload.txn_type_names),
                                    max(cfg.part_cnt, 1), dev))

    def _front(self, state: EngineState):
        """Sections 1-3, shared by the static and the routed step: split
        the rng, admit fresh queries, select the batch and plan it."""
        cfg, wl, be = self.cfg, self.workload, self.backend
        rng, gen_key = prng.split(state.rng)
        stats = dict(state.stats)

        # 1. admit fresh queries
        newq = wl.generate(gen_key, self.pool.g)
        pool, admitted = self.pool.refill(state.pool, newq, state.epoch)
        _acc(stats, "generated_cnt", self.pool.g)
        _acc(stats, "admitted_cnt", admitted)

        # 2. select the batch (full pool: identity, no gathers)
        slots, active, queries = self.pool.select(pool, state.epoch)
        if self.pool.full_pool:
            def sel(t):
                return t
        else:
            idx = slots.long()

            def sel(t):
                return t[idx]

        # 3. plan RW-sets
        planned = wl.plan(state.db, queries)
        batch = AccessBatch(
            table_ids=planned["table_ids"], keys=planned["keys"],
            is_read=planned["is_read"], is_write=planned["is_write"],
            valid=planned["valid"], ts=sel(pool.ts), rank=sel(pool.seq),
            active=active,
            order_free=gate_order_free(cfg, be, planned.get("order_free")))

        return rng, stats, pool, slots, active, queries, sel, planned, batch

    def step(self, state: EngineState, knobs=None) -> EngineState:
        if knobs is not None:
            # the contention router (cfg.ctrl): the knobs pick the branch
            return self._routed_step(state, knobs)
        rng, stats, pool, slots, active, queries, sel, planned, batch = \
            self._front(state)
        db, cc_state, verdict, exec_commit, release, aborts = \
            self._validate_execute(state, stats, pool, active, queries, sel,
                                   planned, batch, self.backend)
        # 6. update pool + counters (forced txns release like commits)
        pool = self._update(state, pool, stats, slots, active, queries, sel,
                            exec_commit, release, verdict.abort, aborts,
                            verdict.defer, self.backend.fresh_ts_on_restart)
        return EngineState(db=db, cc_state=cc_state, pool=pool,
                           rng=rng, epoch=state.epoch + 1, stats=stats)

    def _validate_execute(self, state, stats, pool, active, queries, sel,
                          planned, batch, be, cbatch=None, rounds_cap=None,
                          cadence=None):
        """Sections 4-5 for one backend: validate, density, defer budget,
        execute, repair and audit.  The static step passes its own
        backend; a uniform routed epoch passes the assigned one with the
        coarsened conflict view ``cbatch`` (validate and the density read
        it, the executor and the audit the exact ``batch``), its knobs'
        repair cap and audit cadence.  Returns the tables, the cc state,
        the verdict, the executed commits, the released slots and the
        aborts counted (the CC's and the forced ones)."""
        cfg, wl = self.cfg, self.workload
        cbatch = batch if cbatch is None else cbatch

        # 4. validate
        forwarding = forwarding_applies(be, wl) and cfg.mode == Mode.NORMAL
        fwd = None
        inc = None
        forced = forced_sentinel_mask(batch) if cfg.ycsb_abort_mode else None
        if cfg.mode == Mode.NOCC:
            verdict, cc_state = get_backend("NOCC").validate(
                cfg, state.cc_state, batch, None)
        elif forwarding:
            # everything commits in rank order; the sort IS the
            # validation.  Forced sentinel txns leave the batch first, so
            # their never-applied writes are invisible to readers.
            fbatch = batch if forced is None else dataclasses.replace(
                batch, active=batch.active & ~forced)
            if cfg.device_parts > 1:
                # each shard plans inside execute_mc, which also decides
                # the capacity defers: the verdict follows the execute
                verdict = None
            else:
                verdict, fwd = forward_verdict(fbatch)
            cc_state = state.cc_state
        else:
            inc = build_conflict_incidence(cfg, be, cbatch, cbatch.order_free)
            if be.alg == CCAlg.DGCC:
                # DGCC's [dgcc] counters come from inside the wave
                # assignment, where the lane graph is in hand
                verdict, cc_state = be.validate(cfg, state.cc_state, cbatch,
                                                inc, stats=stats)
            else:
                verdict, cc_state = be.validate(cfg, state.cc_state, cbatch,
                                                inc)
            if cfg.audit_mutate:
                # the seeded edge-derivation fault: flipped losers execute
                # like any commit, a real violation the audit must see
                verdict = audit_mutate_verdict(cfg, batch, inc, verdict,
                                               state.epoch)
        if cfg.metrics:
            # the per-partition conflict density, folded by the plan's
            # owner map; the reference reads it off its incidence where
            # it built one, which gives the same integers as the scatter
            # arm but for the touch rule
            ref_inc = not (forwarding or cfg.mode == Mode.NOCC
                           or be.alg in (CCAlg.NOCC, CCAlg.DGCC))
            _acc(stats, "conflict_density", cc_base.conflict_density(
                cfg, cbatch, planned["owner"], ref_inc))
        # defer budget: a txn deferred past defer_rounds_max force-restarts
        # (deterministic chained backends are exempt)
        if not be.chained:
            verdict = self._defer_budget(pool, sel, active, verdict)

        def finalize(verdict, forced):
            # a forced txn completes-as-aborted only when the CC would not
            # retry it anyway; released slots are commits + forced
            # completions
            if forced is None:
                return None, verdict.commit, verdict.commit
            forced = forced & ~(verdict.abort | verdict.defer)
            return forced, verdict.commit & ~forced, verdict.commit | forced

        if verdict is not None:
            forced, exec_commit, release = finalize(verdict, forced)

        # 5. execute (SIMPLE / QRY_ONLY ack without touching the tables,
        # reference config.h:276-281)
        db = state.db
        if forwarding and cfg.device_parts > 1:
            db, dfr = wl.execute_mc(db, fbatch, stats)
            verdict = mc_defer_verdict(fbatch, dfr)
            forced, exec_commit, release = finalize(verdict, forced)
        elif forwarding:
            db = wl.execute(db, queries, None, verdict.order, stats,
                            fwd_rank=fwd)
        elif cfg.device_parts > 1 and cfg.mode in (Mode.NORMAL, Mode.NOCC):
            # the generic path over the mesh: the replicated verdict, each
            # shard's partition through the workload's own execute
            dgcc = be.alg == CCAlg.DGCC
            db = mc_execute(cfg, wl, db, queries, exec_commit,
                            verdict.order, verdict.level, stats,
                            chained=be.chained and cfg.mode == Mode.NORMAL,
                            level_exec=not dgcc,
                            n_levels=cfg.dgcc_levels if dgcc else None)
        elif be.chained and cfg.mode == Mode.NORMAL:
            dgcc = be.alg == CCAlg.DGCC
            db, stats = _run_levels(
                cfg, wl, db, queries, exec_commit, verdict, stats,
                level_exec=not dgcc,
                n_levels=cfg.dgcc_levels if dgcc else None)
        elif cfg.mode in (Mode.NORMAL, Mode.NOCC):
            db = wl.execute(db, queries, exec_commit, verdict.order, stats)

        # 5b. transaction repair (default off): the sweep's losers
        # re-validate and re-execute as sub-rounds against the post-winner
        # tables; salvaged txns commit and release their slot before the
        # pool update and the counters below see them.  ts_base is the
        # pool's reserved restamp space, above every stamp of the epoch.
        if cfg.repair and cfg.mode == Mode.NORMAL and not forwarding \
                and be.repair_rule is not None:
            db, cc_state, verdict, salvaged, srounds = run_repair(
                cfg, wl, be, db, queries, cbatch, inc, verdict, cc_state,
                stats, exec_commit, forced,
                ts_base=pool.next_seq - self.pool.b, rounds_cap=rounds_cap)
            exec_commit = exec_commit | salvaged
            release = release | salvaged
        else:
            srounds = None

        # 5c. isolation audit (default off)
        if cfg.audit and cfg.mode == Mode.NORMAL:
            if forwarding:
                lvl = torch.zeros_like(verdict.level)
            elif be.chained:
                lvl = verdict.level
            else:
                lvl = srounds if srounds is not None \
                    else torch.zeros_like(verdict.level)
            # edges between two level-0 commits of a sweep backend, whose
            # claim is a conflict-free committed set, are its witnesses
            db = self._audit(state, db, stats, batch, active, exec_commit,
                             verdict.order, lvl, forwarding,
                             audit_levels(cfg, be, forwarding),
                             claim_zero=not forwarding and not be.chained,
                             cadence=cadence)

        aborts = verdict.abort if forced is None else verdict.abort | forced
        return db, cc_state, verdict, exec_commit, release, aborts

    def _defer_budget(self, pool, sel, active, verdict, eligible=None):
        """A txn deferred past ``defer_rounds_max`` force-restarts;
        ``eligible`` narrows the rule (the mixed routed branch)."""
        cfg = self.cfg
        if cfg.defer_rounds_max <= 0:
            return verdict
        stuck = verdict.defer & active \
            & (sel(pool.defer_cnt) >= cfg.defer_rounds_max)
        if eligible is not None:
            stuck = stuck & eligible
        return dataclasses.replace(verdict, abort=verdict.abort | stuck,
                                   defer=verdict.defer & ~stuck)

    def _audit(self, state, db, stats, batch, active, commit, order, lvl,
               order_vis, n_levels, claim_zero, cadence=None):
        """Section 5c: the isolation audit (default off), an observation
        of the final committed set over the exact keys, never an input
        to a verdict or a table write."""
        if not self.cfg.audit:
            return db
        aud, _e, _bk, cnt, drop, _vd, _rd, wit = audit_observe(
            self.cfg, batch, commit & active, order, lvl, order_vis,
            db[AUDIT_KEY], state.epoch, n_levels, cadence=cadence)
        db = dict(db)
        db[AUDIT_KEY] = aud
        _acc(stats, "audit_edge_cnt", cnt)
        _acc(stats, "audit_drop_cnt", drop)
        if claim_zero:
            _acc(stats, "audit_wit_cnt", wit)
        return db

    def _routed_step(self, state: EngineState, knobs) -> EngineState:
        """One epoch under the contention router (``deneva_tpu/engine/
        step.py:476-800``): sections 1-3 and 6 are the static step's;
        sections 4-5 are picked on the host from the knobs (the
        reference's ``lax.switch``).  A uniform assignment runs the static
        step's sections 4-5 for the assigned backend over the coarsened
        conflict view, with the knobs' repair cap and audit cadence (the
        config's pins leave no forced, mutated or multi-device path
        there).  Any other assignment takes the mixed branch: each
        group's sub-batch validates against one shared incidence, with
        the cross-group conflicts deferred on both sides (K21), and the
        union runs through one level chain.  The cc state is returned as
        it came, as in the reference (every candidate is stateless)."""
        from deneva_tpu_torch.cc.router import (candidates, coarsen_keys,
                                                cross_group_defer,
                                                txn_backend)
        cfg, wl = self.cfg, self.workload
        rng, stats, pool, slots, active, queries, sel, planned, batch = \
            self._front(state)
        # the exact owners anchor the knob lookups and the density fold;
        # the coarsened keys feed only the conflict derivation
        owner = planned["owner"]
        cbatch = coarsen_keys(batch, owner, knobs)
        backends = [get_backend(a) for a in candidates(cfg)]

        a0 = knobs.assign[0]
        if all(a == a0 for a in knobs.assign):
            if not 0 <= a0 < len(backends):
                raise ValueError(f"router: no branch for assignment {a0} "
                                 f"among {len(backends)} candidates")
            db, _cc, verdict, exec_commit, release, _aborts = \
                self._validate_execute(
                    state, stats, pool, active, queries, sel, planned,
                    batch, backends[a0], cbatch=cbatch,
                    rounds_cap=knobs.repair_cap,
                    cadence=knobs.audit_cadence)
        else:
            # the mixed branch: one shared incidence with every
            # candidate's views; each group validates its sub-batch with
            # the cross-group conflict surface deferred; no repair
            views = ("u", "w") + tuple(v for be_g in backends
                                       for v in be_g.views(cfg))
            inc = cc_base.build_incidence(
                cbatch, cfg.conflict_buckets, cfg.conflict_exact,
                order_free=gate_order_free(cfg, backends[0],
                                           cbatch.order_free),
                views=tuple(dict.fromkeys(views)))
            group = txn_backend(knobs, owner)
            crossdef = cross_group_defer(inc, cbatch, group,
                                         n_groups=len(backends))
            commit = torch.zeros_like(active)
            abort = torch.zeros_like(active)
            defer = crossdef
            level = torch.zeros_like(batch.rank)
            nonchained = torch.zeros_like(active)
            for g, be_g in enumerate(backends):
                m = active & (group == g) & ~crossdef
                sb = dataclasses.replace(cbatch, active=m)
                if be_g.alg == CCAlg.DGCC:
                    v_g, _cc = be_g.validate(cfg, state.cc_state, sb, None,
                                             stats=stats)
                else:
                    v_g, _cc = be_g.validate(cfg, state.cc_state, sb, inc)
                commit = commit | (v_g.commit & m)
                abort = abort | (v_g.abort & m)
                defer = defer | (v_g.defer & m)
                if be_g.chained:
                    level = torch.where(m, v_g.level, level)
                else:
                    nonchained = nonchained | (group == g)
            _acc(stats, "conflict_density", cc_base.conflict_density(
                cfg, cbatch, owner, True))
            # the budget covers the sweep groups and the cross-group
            # defers; chained groups keep their exemption
            verdict = self._defer_budget(
                pool, sel, active,
                cc_base.Verdict(commit=commit, abort=abort, defer=defer,
                                order=batch.rank, level=level),
                eligible=nonchained | crossdef)
            # the union runs through one level chain; with DGCC armed, the
            # executor's order tournament (its waves carry several writers)
            n_levels = max(cfg.exec_subrounds,
                           cfg.dgcc_levels if cfg.ctrl_dgcc else 0)
            db, stats = _run_levels(cfg, wl, state.db, queries,
                                    verdict.commit, verdict, stats,
                                    level_exec=not cfg.ctrl_dgcc,
                                    n_levels=n_levels)
            db = self._audit(state, db, stats, batch, active, verdict.commit,
                             verdict.order, verdict.level, False, n_levels,
                             claim_zero=False, cadence=knobs.audit_cadence)
            exec_commit = release = verdict.commit

        # 6. (forced = None; every candidate restamps its aborts)
        pool = self._update(state, pool, stats, slots, active, queries, sel,
                            exec_commit, release, verdict.abort,
                            verdict.abort, verdict.defer, True)
        return EngineState(db=db, cc_state=state.cc_state, pool=pool,
                           rng=rng, epoch=state.epoch + 1, stats=stats)

    def run_ctrl(self, state: EngineState, knobs, n: int) -> EngineState:
        """``n`` routed epochs under one decision (the reference's
        ``jit_run_ctrl``)."""
        for _ in range(n):
            state = self.step(state, knobs)
        return state

    def _update(self, state, pool, stats, slots, active, queries, sel,
                exec_commit, release, retry, aborts, defers, fresh_ts):
        """Section 6, shared by the static and the routed step: the pool
        update (``retry``: the CC's aborts, which restart) and the device
        counters (``aborts``: those and the forced ones)."""
        wl = self.workload
        pre_abort_cnt = sel(pool.abort_cnt)
        pool = self.pool.update(pool, slots, active, release, retry,
                                state.epoch, fresh_ts)
        committed = exec_commit & active
        aborts = aborts & active
        _acc(stats, "total_txn_commit_cnt", committed.sum())
        _acc(stats, "total_txn_abort_cnt", aborts.sum())
        _acc(stats, "unique_txn_abort_cnt",
             (aborts & (pre_abort_cnt == 0)).sum())
        count_by_type(stats, wl, queries, committed, aborts)
        _acc(stats, "defer_cnt", (defers & active).sum())
        lat = torch.clamp(state.epoch - sel(pool.entry_epoch), 0,
                          LAT_BUCKETS - 1)
        buckets = torch.arange(LAT_BUCKETS, dtype=torch.int32,
                               device=lat.device)
        onehot = (lat[:, None] == buckets) & committed[:, None]
        n_types = stats["latency_hist"].shape[0]
        if len(wl.txn_type_names) > 1:
            ttype = wl.txn_type_of(queries)
            rows = [(onehot & (ttype == t)[:, None]).sum(dim=0)
                    for t in range(n_types)]
        else:
            rows = [onehot.sum(dim=0)]
        _acc(stats, "latency_hist", torch.stack(rows))
        rb = torch.arange(RETRY_BUCKETS, dtype=torch.int32, device=lat.device)
        retries = torch.clamp(pre_abort_cnt, 0, RETRY_BUCKETS - 1)
        waits = torch.clamp(sel(pool.defer_cnt), 0, RETRY_BUCKETS - 1)
        _acc(stats, "retry_hist",
             ((retries[:, None] == rb) & committed[:, None]).sum(dim=0))
        _acc(stats, "wait_hist",
             ((waits[:, None] == rb) & committed[:, None]).sum(dim=0))
        return pool

    def run(self, state: EngineState, n: int) -> EngineState:
        """``n`` epochs, enqueued back to back (the reference's
        ``jit_run`` scan)."""
        for _ in range(n):
            state = self.step(state)
        return state
