"""Run lifecycle: warmup / measure / summary (reference `system/sim_manager.*`).

The port of ``deneva_tpu/engine/driver.py``.  The unit of progress is a
chunk of epochs enqueued on the device; after each chunk one small
device->host copy (commit count, ``next_seq``, the latency histogram and
the overflow bit of every capacity-bounded index, in one tensor) is the
pacing barrier, so the host never runs more than a chunk ahead.  A run
whose index overflowed is refused at the first such chunk, and once more
at the end.  Chunks are sized to ``chunk_target_secs`` of work.  The
measured window's counter deltas become the reference-compatible
``[summary]`` line (with the ``rep_*`` fields under ``repair``, the
``mb_density_*`` fields under ``metrics``, the ``audit_*`` fields under
``audit``, the ``dgcc_*`` fields and one ``[dgcc]`` line under DGCC or
``ctrl_dgcc``, and ``ctrl_decisions`` / ``ctrl_trips`` under ``ctrl``);
latency buckets (in epochs) are scaled to seconds by the pace of the
chunk that produced them.  Under ``ctrl`` each chunk runs the routed
step under one decision; at each chunk boundary the controller
(`runtime.controller`) folds the counter deltas, which ride the same
copy, into the next decision and prints it as a ``[ctrl]`` line.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.config import CCAlg, Config
from deneva_tpu_torch.engine.step import Engine, EngineState
from deneva_tpu_torch.stats import Stats, make_prog_line, tagged_line
from deneva_tpu_torch.workloads import get_workload


def _counters(state: EngineState) -> dict:
    """Host copy of every device counter, as the reference's uint32."""
    return {k: v.cpu().numpy().astype(np.uint32)
            for k, v in state.stats.items()}


def _indexes(state: EngineState) -> dict:
    """The db entries with a capacity that can overflow (TPC-C's
    ``ORDER_IDX``)."""
    return {name: t for name, t in state.db.items()
            if hasattr(t, "overflowed")}


CTRL_SIGNALS = ("conflict_density", "rep_fallback_cnt", "rep_salvaged_cnt",
                "audit_wit_cnt")


def _sync(state: EngineState, ctrl: bool = False
          ) -> tuple[int, int, np.ndarray, bool, list | None]:
    """One device->host copy as the pacing barrier: returns (commit_cnt,
    next_seq, latency_hist, index_overflowed, ctrl_counters).  The
    overflow bits, and under ``ctrl`` the controller's four counters
    (`CTRL_SIGNALS`, as uint32), ride this copy rather than pay a second
    one per chunk (``deneva_tpu/engine/driver.py:33-55``)."""
    st = state.stats
    nh = st["latency_hist"].numel()
    sig = [st[k].reshape(-1) for k in CTRL_SIGNALS] if ctrl else []
    idx = [t.overflowed().reshape(1).to(torch.int64)
           for t in _indexes(state).values()]
    flat = torch.cat([st["total_txn_commit_cnt"].reshape(1),
                      state.pool.next_seq.reshape(1).to(torch.int64),
                      st["latency_hist"].reshape(-1)] + sig + idx
                     ).cpu().numpy()
    hist = flat[2:2 + nh].astype(np.uint32).reshape(
        st["latency_hist"].shape)
    at = 2 + nh
    counters = None
    if ctrl:
        counters = []
        for t in sig:
            counters.append(flat[at:at + t.numel()].astype(np.uint32))
            at += t.numel()
    return int(flat[0]), int(flat[1]), hist, bool(flat[at:].any()), \
        counters


def _guard_overflow(ovf: bool) -> None:
    # past overflow, probes may return slots of ring-overwritten rows:
    # refuse at the first overflowed chunk
    if ovf:
        raise RuntimeError(
            "a capacity-bounded index overflowed during the run "
            "(stale lookups possible); raise its capacity "
            "(insert_table_cap) or shorten the run")


def run_simulation(cfg: Config, device=None, chunk: int = 50,
                   quiet: bool = False) -> Stats:
    """Warmup for ``warmup_secs``, measure for ``done_secs``; returns Stats.
    Runs on CUDA unless ``device`` names the CPU.  ``Stats.epochs_run``
    holds every epoch the run executed, calibration chunks included.

    Under ``device_parts > 1`` the run takes the mesh of the enclosing
    `parallel.use_mesh`, or else ``make_mesh(device_parts)`` (the first
    ``device_parts`` CUDA devices); the state lives on the mesh's first
    device, which ``device``, when given, must name."""
    mesh = None
    if cfg.device_parts > 1:
        from deneva_tpu_torch.parallel import (current_mesh, make_mesh,
                                               make_sharded_run)
        mesh = current_mesh() or make_mesh(cfg.device_parts)
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != mesh.device.type or (
                want.index is not None and want != mesh.device)):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh.device}")
        device = mesh.device
    device = kernels.resolve_device(device)
    wl = get_workload(cfg, device=device)
    eng = Engine(cfg, wl, device=device)
    state = eng.init_state()
    run_n = eng.run
    ctl = None
    if cfg.ctrl:
        # the control plane: the routed step replaces run; each chunk
        # boundary folds the counter deltas into one decision and re-arms
        # the knobs for the next chunk
        from deneva_tpu_torch.cc.router import (knobs_from_decision,
                                                static_knobs)
        from deneva_tpu_torch.runtime.controller import (Controller,
                                                         CtrlSignals,
                                                         ctrl_line)
        ctl = Controller(cfg)
        knobs = [static_knobs(cfg, device)]
        ctrl_prev = [None]          # the previous tick's counters

        def run_n(state, n):
            return eng.run_ctrl(state, knobs[0], n)
    if mesh is not None:
        # tables owner-major over the mesh, the shards' executors in turn
        place, run_n = make_sharded_run(eng, mesh)
        state = place(state)

    run_t0 = time.monotonic()
    prog_next = [run_t0 + cfg.prog_timer_secs]
    epochs_total = [0]
    seq_per_chunk = [(eng.pool.g + eng.pool.b) * chunk]

    def prog_tick(state):
        # [prog] line every prog_timer_secs (reference PROG_TIMER)
        now = time.monotonic()
        if quiet or cfg.prog_timer_secs <= 0 or now < prog_next[0]:
            return
        prog_next[0] = now + cfg.prog_timer_secs
        print(make_prog_line(now - run_t0, _counters(state),
                             {"epoch_cnt": float(epochs_total[0])}),
              flush=True)

    def _guard_seq(head: int):
        # int32 seq/ts wrap guard: next_seq advances (G + B) per epoch;
        # refuse a chunk that could cross 2^31
        if head < 0 or head > 2**31 - 2 * seq_per_chunk[0]:
            raise RuntimeError(
                f"int32 txn-sequence space nearly exhausted (next_seq="
                f"{head}); shorten the run window or shrink epoch_batch "
                "(seq advances epoch_batch+gen_chunk per epoch)")

    chunk_log: list[tuple[int, float, np.ndarray]] = []
    last_t = [time.monotonic()]

    def _ctrl_tick(counters):
        """One decision per chunk boundary (``deneva_tpu/engine/driver.py:
        138-177``): the counter deltas since the previous tick, decided,
        the knobs re-armed.  The first tick only takes the baseline."""
        dens, fb, sv, wit = counters
        now = time.monotonic()
        cur = (dens.astype(np.int64), int(fb[0]), int(sv[0]), int(wit[0]),
               epochs_total[0], now)
        prev, ctrl_prev[0] = ctrl_prev[0], cur
        if prev is None:
            return
        sig = CtrlSignals(
            epoch=epochs_total[0], epochs=cur[4] - prev[4],
            dens=[int(x) for x in cur[0] - prev[0]],
            fallback=cur[1] - prev[1], salvaged=cur[2] - prev[2],
            witnesses=cur[3] - prev[3], breaches=0,
            gap_us=int((now - prev[5]) * 1e6))
        dec = ctl.decide(sig)
        knobs[0] = knobs_from_decision(cfg, dec.assign, dec.gshift,
                                       dec.repair_cap, dec.audit_cadence,
                                       device)
        if not quiet:
            print(ctrl_line(0, sig, dec), flush=True)

    def _after_chunk(state):
        _, head, hist, ovf, counters = _sync(state, ctl is not None)
        _guard_seq(head)
        _guard_overflow(ovf)
        if ctl is not None:
            _ctrl_tick(counters)
        now = time.monotonic()
        chunk_log.append((chunk, now - last_t[0], hist))
        epochs_total[0] += chunk
        prog_tick(state)
        last_t[0] = time.monotonic()

    def _retarget(state, epochs_per_sec: float, spread: int):
        # aim each chunk at chunk_target_secs of work (20k-epoch ceiling)
        nonlocal chunk
        target = max(1, min(int(epochs_per_sec * cfg.chunk_target_secs),
                            20_000))
        if target > chunk * spread or target < chunk // spread:
            chunk = target
            seq_per_chunk[0] = (eng.pool.g + eng.pool.b) * chunk
            state = run_n(state, chunk)
            _after_chunk(state)
        return state

    _guard_seq(int(state.pool.next_seq))
    # first chunk: kernel build and warm-up, outside both windows
    state = run_n(state, chunk)
    _guard_seq(_sync(state)[1])
    t1 = time.monotonic()
    state = run_n(state, chunk)
    _guard_seq(_sync(state)[1])
    last_t[0] = time.monotonic()
    per_chunk = max(last_t[0] - t1, 1e-4)
    state = _retarget(state, chunk / per_chunk, spread=2)

    def run_window(state, secs):
        t0 = time.monotonic()
        ep0 = epochs_total[0]
        while time.monotonic() - t0 < secs:
            state = run_n(state, chunk)
            _after_chunk(state)
        return state, epochs_total[0] - ep0, time.monotonic() - t0

    state, ep_w, el_w = run_window(state, cfg.warmup_secs)
    if ep_w:
        state = _retarget(state, ep_w / max(el_w, 1e-4), spread=3)
    before = _counters(state)
    chunk_log.clear()
    last_t[0] = time.monotonic()
    t_start = time.monotonic()
    state, epochs, elapsed = run_window(state, cfg.done_secs)
    after = _counters(state)

    st = Stats()
    st._t_start = t_start
    st._t_end = t_start + elapsed
    st.set("total_runtime", elapsed)
    st.set("epoch_cnt", float(epochs))
    for k in ("generated_cnt", "admitted_cnt", "total_txn_commit_cnt",
              "total_txn_abort_cnt", "unique_txn_abort_cnt", "defer_cnt",
              "write_cnt"):
        st.set(k, float(after[k] - before[k]))
    if cfg.repair:
        # salvaged commits, invalidated read lanes and retry-queue
        # fallbacks; only when armed, so every other line is unchanged
        for k in ("rep_salvaged_cnt", "rep_frontier_cnt",
                  "rep_fallback_cnt"):
            st.set(k, float(after[k] - before[k]))
    if cfg.metrics:
        # per-partition conflict density over the measured window
        dens = (after["conflict_density"]
                - before["conflict_density"]).astype(np.float64)
        for i, d in enumerate(dens):
            st.set(f"mb_density_p{i}", float(d))
        st.set("mb_density_total", float(dens.sum()))
    if cfg.audit:
        # dependency edge lanes among committed txns, export-cap
        # overflows and claim-violating edges over the measured window
        for k in ("audit_edge_cnt", "audit_drop_cnt", "audit_wit_cnt"):
            st.set(k, float(after[k] - before[k]))
    if cfg.ctrl:
        # decision ticks and governor trips over the whole run
        st.set("ctrl_decisions", float(ctl.seq))
        st.set("ctrl_trips", float(ctl.stale_trips))
    if cfg.cc_alg == CCAlg.DGCC or cfg.ctrl_dgcc:
        # waves over the window, the deepest epoch of the whole run (a
        # running max), deferred closures and the dependency edges
        for k in ("dgcc_wave_cnt", "dgcc_fallback_cnt", "dgcc_edge_cnt"):
            st.set(k, float(after[k] - before[k]))
        st.set("dgcc_wave_max", float(after["dgcc_wave_max"]))
        if not quiet:
            print(tagged_line("dgcc", {
                "node": 0,
                "waves": int(after["dgcc_wave_cnt"]
                             - before["dgcc_wave_cnt"]),
                "wave_max": int(after["dgcc_wave_max"]),
                "fallback": int(after["dgcc_fallback_cnt"]
                                - before["dgcc_fallback_cnt"]),
                "edges": int(after["dgcc_edge_cnt"]
                             - before["dgcc_edge_cnt"])}), flush=True)
    for i, nm in enumerate(wl.txn_type_names):
        for fam in ("commit", "abort"):
            key = f"{fam}_by_type"
            st.set(f"{nm}_{fam}_cnt", float(after[key][i] - before[key][i]))
    commits = after["total_txn_commit_cnt"] - before["total_txn_commit_cnt"]
    aborts = after["total_txn_abort_cnt"] - before["total_txn_abort_cnt"]
    type_names = list(wl.txn_type_names)
    lb = after["latency_hist"].shape[-1]
    prev = before["latency_hist"].astype(np.float64)
    for n_ep, secs, snap in chunk_log:
        cur = snap.astype(np.float64)
        delta = cur - prev
        prev = cur
        spe = secs / max(n_ep, 1)
        centers = (np.arange(lb) + 0.5) * spe
        for i, nm in enumerate(type_names):
            row = delta[i] if delta.ndim == 2 else delta
            if row.sum() > 0:
                st.arr(f"{nm}_latency").extend_weighted(centers, row)
                st.arr("client_client_latency").extend_weighted(
                    centers, row)
    for key, name in (("retry_hist", "txn_retries"),
                      ("wait_hist", "txn_waits")):
        d = (after[key] - before[key]).astype(np.float64)
        if d.sum() > 0:
            st.arr(name).extend_weighted(np.arange(len(d)), d)
    st.set("abort_rate", float(aborts) / max(float(commits + aborts), 1.0))
    # the backstop of the per-chunk guard
    for name, t in _indexes(state).items():
        if bool(t.overflowed()):
            raise RuntimeError(
                f"index {name!r} overflowed its capacity during the run "
                "(stale lookups possible); raise its capacity "
                "(insert_table_cap) or shorten the run")
    st.epochs_run = int(state.epoch)
    if not quiet:
        print(st.summary_line())
    return st
