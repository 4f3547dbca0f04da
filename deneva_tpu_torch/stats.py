"""Statistics: counters, percentile arrays and the ``[summary]`` line.

A copy of ``deneva_tpu/stats.py`` (the port imports nothing of the JAX
package), unchanged in behaviour so both packages print the same
``[summary]`` format that the reference's parsers read
(`statistics/stats.cpp:1470`, `scripts/parse_results.py:19-38`).
"""


from __future__ import annotations

import os
import re
import time
from collections import defaultdict
from typing import Any, Iterable

import numpy as np


def weighted_nearest_rank(values: np.ndarray, weights: np.ndarray | None,
                          p: float) -> float:
    """Weighted nearest-rank percentile over a (value, weight) multiset —
    THE one percentile definition in the repo (reference
    `stats_array.cpp:127-146` ``get_idx(pct)`` sorted-array indexing).
    ``StatsArr.percentile``, the admission controller's SLO quantile and
    the txntrace waterfall all delegate here so a boundary-rank fix can
    never fork the semantics.  p0 = min, p100 = max; empty/zero-weight
    input returns 0."""
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return 0.0
    order = np.argsort(values, kind="stable")
    vals = values[order]
    w = np.ones(len(vals)) if weights is None \
        else np.asarray(weights, np.float64)[order]
    cum = np.cumsum(w)
    total = cum[-1]
    if total <= 0:
        return 0.0
    # nearest-rank over the weighted multiset
    target = p / 100.0 * total
    idx = int(np.searchsorted(cum, target, side="left"))
    return float(vals[min(idx, len(vals) - 1)])


class StatsArr:
    """Percentile array (reference `statistics/stats_array.cpp:53-146`).

    The reference preallocates a fixed array and either sorts or histograms.
    Here: an amortized-growth (value, weight) buffer; ``extend`` appends
    unit-weight samples, ``extend_weighted`` appends a whole histogram
    exactly (a bucket of N txns contributes weight N — no synthesized
    per-sample expansion, no cap).  Percentiles are weighted nearest-rank
    over the full multiset, matching the reference's sorted-array indexing
    (`stats_array.cpp:127-146` ``get_idx(pct)``) at any sample count.
    """

    __slots__ = ("_buf", "_w", "_n")

    def __init__(self, cap: int = 4096):
        self._buf = np.empty(max(1, cap), dtype=np.float64)
        self._w = np.empty(max(1, cap), dtype=np.float64)
        self._n = 0

    def _grow(self, need: int) -> None:
        if need > len(self._buf):
            cap = len(self._buf)
            while cap < need:
                cap *= 2
            self._buf = np.resize(self._buf, cap)
            self._w = np.resize(self._w, cap)

    def insert(self, v: float) -> None:
        self._grow(self._n + 1)
        self._buf[self._n] = v
        self._w[self._n] = 1.0
        self._n += 1

    def extend(self, vs: Iterable[float], ws: Iterable[float] | None = None
               ) -> None:
        vs = np.asarray(list(vs) if not isinstance(vs, np.ndarray) else vs,
                        dtype=np.float64)
        need = self._n + len(vs)
        self._grow(need)
        self._buf[self._n:need] = vs
        self._w[self._n:need] = 1.0 if ws is None \
            else np.asarray(ws, dtype=np.float64)
        self._n = need

    def extend_weighted(self, values: np.ndarray, counts: np.ndarray) -> None:
        """Append a histogram: value[i] occurs counts[i] times (exact)."""
        values = np.asarray(values, np.float64)
        counts = np.asarray(counts, np.float64)
        keep = counts > 0
        self.extend(values[keep], counts[keep])

    def __len__(self) -> int:
        return int(self._w[: self._n].sum())

    def view(self) -> np.ndarray:
        """Materialized samples (tests / small series); weighted entries
        expand, so call only when the total count is modest."""
        return np.repeat(self._buf[: self._n],
                         self._w[: self._n].astype(np.int64))

    def percentile(self, p: float) -> float:
        return weighted_nearest_rank(self._buf[: self._n],
                                     self._w[: self._n], p)

    def percentiles(self, ps=(50, 90, 95, 99)) -> dict[str, float]:
        return {f"p{p}": self.percentile(p) for p in ps}

    def merge_from(self, other: "StatsArr") -> None:
        """Splice another array's weighted entries in (the one shared
        representation-aware merge; used by Stats.merge and the cluster
        client's per-type family rollup)."""
        self.extend(other._buf[: other._n], other._w[: other._n])

    def mean(self) -> float:
        w = self._w[: self._n]
        tot = w.sum()
        return float((self._buf[: self._n] * w).sum() / tot) if tot else 0.0


class Stats:
    """Counter/timer registry for one node (or one worker thread).

    ``incr``/``add`` replace the reference's ``INC_STATS(tid, name, v)``;
    per-thread instances are combined with ``merge`` exactly as
    ``Stats::print`` folds ``Stats_thd`` structs.
    """

    def __init__(self) -> None:
        self.counters: dict[str, float] = defaultdict(float)
        self.arrays: dict[str, StatsArr] = {}
        self._t_start: float | None = None
        self._t_end: float | None = None

    # -- accumulation ---------------------------------------------------
    def incr(self, name: str, v: float = 1.0) -> None:
        self.counters[name] += v

    add = incr

    def set(self, name: str, v: float) -> None:
        self.counters[name] = v

    def arr(self, name: str) -> StatsArr:
        a = self.arrays.get(name)
        if a is None:
            a = self.arrays[name] = StatsArr()
        return a

    def merge(self, other: "Stats") -> None:
        for k, v in other.counters.items():
            self.counters[k] += v
        for k, a in other.arrays.items():
            self.arr(k).merge_from(a)
        # Union of run windows: workers measure concurrently, so the
        # aggregate window spans min(start)..max(end), not the sum.
        if other._t_start is not None:
            if self._t_start is None or other._t_start < self._t_start:
                self._t_start = other._t_start
        if other._t_end is not None:
            if self._t_end is None or other._t_end > self._t_end:
                self._t_end = other._t_end

    # -- run window (reference SimManager warmup/done timers) -----------
    def start_window(self) -> None:
        self._t_start = time.monotonic()

    def end_window(self) -> None:
        self._t_end = time.monotonic()

    @property
    def runtime(self) -> float:
        if self._t_start is None:
            return 0.0
        end = self._t_end if self._t_end is not None else time.monotonic()
        return end - self._t_start

    # -- output ----------------------------------------------------------
    def summary_fields(self) -> dict[str, float]:
        c = self.counters
        runtime = c.get("total_runtime", 0.0) or self.runtime
        out = dict(c)
        out["total_runtime"] = runtime
        # servers: txn_cnt = committed; clients count their own responses
        # (the reference's client [summary] does the same, stats.cpp:1558)
        out.setdefault("txn_cnt", c.get("total_txn_commit_cnt", 0.0))
        out["tput"] = out["txn_cnt"] / runtime if runtime > 0 else 0.0
        for name, a in self.arrays.items():
            if len(a):
                for p, v in a.percentiles().items():
                    out[f"{name}_{p}"] = v
                out[f"{name}_mean"] = a.mean()
        return out

    def summary_line(self) -> str:
        """Reference `[summary]` line (`statistics/stats.cpp:1470`).  The
        reference's client variant (`:1558`) is just this emitter called on
        the client process's own Stats instance."""
        fields = self.summary_fields()
        head = ["total_runtime", "tput", "txn_cnt", "total_txn_commit_cnt",
                "total_txn_abort_cnt", "unique_txn_abort_cnt"]
        ordered = [(k, fields.get(k, 0.0)) for k in head]
        ordered += sorted((k, v) for k, v in fields.items() if k not in head)
        body = ",".join(f"{k}={_fmt(v)}" for k, v in ordered)
        return f"[summary] {body}"


    def prog_line(self, extra: dict[str, float] | None = None) -> str:
        """Reference ``[prog]`` progress tick (`system/thread.cpp:86-105`
        prints running stats every PROG_TIMER; `statistics/stats.h:311-316`
        appends process mem/cpu utilization from /proc/self)."""
        f = self.summary_fields()
        f.update(proc_utilization())
        keys = ("total_runtime", "tput", "txn_cnt", "total_txn_commit_cnt",
                "total_txn_abort_cnt", "mem_util", "cpu_util")
        body = ",".join(f"{k}={_fmt(f.get(k, 0.0))}" for k in keys)
        tail = ",".join(f"{k}={_fmt(v)}" for k, v in (extra or {}).items()
                        if k not in keys)
        return f"[prog] {body}" + (f",{tail}" if tail else "")


def tagged_line(tag: str, fields: dict) -> str:
    """``[tag] k=v k=v ...`` emitter for subsystem summary-line families
    (currently ``[repair]`` and ``[telemetry]``; the older
    ``[membership]``/``[replication]``/``[admission]`` lines predate it
    and keep their own per-family float formatting).  Every family
    shares the same space-separated k=v SHAPE, parsed by the matching
    `harness.parse` regex parsers — which by contract ignore every tag
    they do not know, so new families never break old tooling."""
    body = " ".join(
        f"{k}={_fmt(v) if isinstance(v, (int, float)) else v}"
        for k, v in fields.items())
    return f"[{tag}] {body}"


def repair_line(node: int, fields: dict) -> str:
    """Per-node ``[repair]`` summary line (``deneva_tpu/engine/repair.py:199``,
    parsed by ``harness.parse.parse_repair``)."""
    return tagged_line("repair", {"node": node, **fields})


def make_prog_line(runtime: float, counters: dict,
                   extra: dict[str, float] | None = None) -> str:
    """Shared [prog] emitter for the in-process driver and cluster servers:
    one format, one call site per consumer."""
    ps = Stats()
    ps.set("total_runtime", runtime)
    for k in ("total_txn_commit_cnt", "total_txn_abort_cnt"):
        ps.set(k, float(counters.get(k, 0.0)))
    return ps.prog_line(extra)


def proc_utilization() -> dict[str, float]:
    """{mem_util: RSS MiB, cpu_util: process CPU seconds} from /proc/self
    (reference `statistics/stats.h:311-316` reads VmRSS the same way)."""
    out = {"mem_util": 0.0, "cpu_util": 0.0}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["mem_util"] = float(line.split()[1]) / 1024.0
                    break
        with open("/proc/self/stat") as f:
            stat = f.read()
        # comm (field 2) may contain spaces; fields restart after last ')'
        parts = stat[stat.rindex(")") + 2:].split()
        tick = os.sysconf("SC_CLK_TCK")
        out["cpu_util"] = (int(parts[11]) + int(parts[12])) / tick
    except (OSError, IndexError, ValueError):
        pass  # non-Linux / restricted proc: report zeros
    return out


def _fmt(v: float) -> str:
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


def parse_summary(line: str) -> dict[str, float]:
    """Inverse of ``summary_line`` (reference `scripts/parse_results.py:19-38`)."""
    assert "[summary]" in line, line
    body = line.split("[summary]", 1)[1].strip()
    out: dict[str, float] = {}
    for kv in body.split(","):
        if not kv:
            continue
        k, v = kv.split("=", 1)
        out[k] = float(v)
    return out


_CTRL = re.compile(r"\[ctrl\] (.*)")


def _auto(v: str) -> Any:
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    return v


def _parse_tagged(lines, pattern: re.Pattern) -> list[dict[str, Any]]:
    """One tagged-line family -> [{k: v}], values auto-typed (a copy of
    ``deneva_tpu/harness/parse.py:116``)."""
    out = []
    for line in lines:
        m = pattern.search(line)
        if not m:
            continue
        d: dict[str, Any] = {}
        for kv in m.group(1).split():
            if "=" not in kv:
                continue
            k, v = kv.split("=", 1)
            d[k] = _auto(v)
        out.append(d)
    return out


def parse_ctrl(lines) -> list[dict[str, Any]]:
    """``[ctrl]`` decision lines (`runtime.controller.ctrl_line`) ->
    [{node, seq, epoch, epochs, dens, fb, sv, wit, slo, gap_us, gov, heal,
    trips, assign, gshift, cap, cad, qidx}], in emit order (a copy of
    ``deneva_tpu/harness/parse.py:285``).  ``dens``, ``assign`` and
    ``gshift`` of more than one partition stay colon-joined strings.
    Takes lines, not a path; `runtime.controller.replay_decisions`
    replays the rows."""
    return _parse_tagged(lines, _CTRL)
