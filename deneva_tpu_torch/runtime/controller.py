"""The control plane's decision half (a copy of
``deneva_tpu/runtime/controller.py``, which imports no JAX; the port
keeps its own copy).

One pure decision function per chunk boundary: the controller consumes
only recorded signals — the per-partition conflict-density deltas, the
repair ledger's salvage and fallback counts, the audit plane's witness
count, the admission breaches (0 on one node) and the host wall-clock
gap between ticks — and every tick prints as a ``[ctrl]`` line holding
the signals and the decision, so `replay_decisions` re-derives the
sequence from the log and compares it field by field.

Oscillation control: a hysteresis band (a partition's class SPARSE /
MID / HOT moves only when its normalized density crosses ``ctrl_lo`` /
``ctrl_hi``), a confirm streak (``ctrl_confirm`` ticks) and a per-knob
cooldown (``ctrl_cooldown`` ticks).  The fail-safe governor reverts
every knob to the static config on a stale tick (no epochs, or a gap
past ``ctrl_stale_s``) and re-engages after ``ctrl_heal`` healthy ones.
The mechanism half is `cc.router`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from deneva_tpu_torch.config import Config
from deneva_tpu_torch.stats import tagged_line

# contention classes (per partition)
SPARSE, MID, HOT = 0, 1, 2

# class -> candidate backend index (cc/router.CANDIDATES order:
# NO_WAIT, OCC, TPU_BATCH).  The mapping IS the paper's frontier made
# operational: at low contention the lock-sweep family's cheap epochs
# win and aborts are rare (NO_WAIT); in the mid band OCC's directed
# reads-vs-writes edges admit strictly more than NO_WAIT's symmetric
# refusals; under hot skew the deterministic batch (TPU_BATCH) orders
# conflicts instead of aborting them — the regime where every
# abort-based scheme collapses (Harding et al. figs. 6-9; calibrated
# against the static cells of results/router).
CLASS_BACKEND = (0, 1, 2)

# ctrl_dgcc variant: HOT partitions route to the DGCC wavefront branch
# (candidate index 3) instead of TPU_BATCH — dependency-graph waves
# commit what the deterministic batch would defer past its level budget
# and what every abort-based scheme would abort (results/dgcc cells).
CLASS_BACKEND_DGCC = (0, 1, 3)


def default_backend_map(cfg: Config) -> tuple:
    """The class->backend map this config's controller starts from
    (tools/router_frontier.py may still pass a CALIBRATED map; replay
    threads whichever map drove the run)."""
    return CLASS_BACKEND_DGCC if cfg.ctrl_dgcc else CLASS_BACKEND

GOV_ARMED, GOV_STATIC = "armed", "static"


@dataclass
class CtrlSignals:
    """One boundary tick's recorded inputs (host ints only — the line
    round-trips them exactly, which is what makes replay bit-exact).

    epoch    — first epoch the decision governs
    epochs   — epochs covered since the previous tick (0 = stalled)
    dens     — per-partition conflict-density delta over those epochs
    fallback / salvaged — repair ledger deltas (cyclic-fallback signal)
    witnesses — audit plane edge-lane delta (witness density)
    breaches — admission SLO-breach group delta (watchdog signal)
    gap_us   — host wall-clock gap since the previous tick
    """

    epoch: int
    epochs: int
    dens: list[int]
    fallback: int = 0
    salvaged: int = 0
    witnesses: int = 0
    breaches: int = 0
    gap_us: int = 0


@dataclass
class CtrlDecision:
    """One boundary tick's outputs (plain host values; the driver lifts
    them onto the device via `router.knobs_from_decision`)."""

    seq: int
    epoch: int
    gov: str
    assign: list[int]
    gshift: list[int]
    repair_cap: int
    audit_cadence: int
    quota_idx: int              # admission quota scale step (cluster)
    heal: int                   # governor heal streak at decision time
    stale_trips: int            # cumulative governor trips


@dataclass
class Controller:
    """Deterministic feedback controller; one instance per node.  All
    state is plain host ints, every transition a pure function of
    (state, CtrlSignals, cfg) — no wall clock, no randomness — so a
    replay over the recorded signal stream reproduces the decision
    stream exactly."""

    cfg: Config
    cls: list[int] = field(default_factory=list)     # confirmed class/part
    pend: list[int] = field(default_factory=list)    # pending class/part
    streak: list[int] = field(default_factory=list)  # confirm streak/part
    cool: dict = field(default_factory=dict)         # knob -> ticks left
    gov: str = GOV_ARMED
    heal: int = 0
    stale_trips: int = 0
    seq: int = 0
    repair_cap: int = 0
    audit_cadence: int = 0
    quota_idx: int = 0
    audit_quiet: int = 0        # consecutive witness-free ticks
    assign: list[int] = field(default_factory=list)  # last armed assign
    gshift: list[int] = field(default_factory=list)  # last armed gshift
    # class -> backend map; None resolves to default_backend_map(cfg)
    # (the paper's frontier; its DGCC variant under ctrl_dgcc).
    # tools/router_frontier.py passes the map it CALIBRATES from the
    # measured static cells instead — on a host whose cost model
    # differs from the chip (cpu capture: no MXU pricing the
    # deterministic batch) the measured frontier is the honest one.
    # Replay must use the same map (replay_decisions threads it).
    backend_map: tuple | None = None

    def __post_init__(self):
        from deneva_tpu_torch.cc.router import candidate_index
        if self.backend_map is None:
            self.backend_map = default_backend_map(self.cfg)
        p = max(self.cfg.part_cnt, 1)
        self.cls = [MID] * p
        self.pend = [MID] * p
        self.streak = [0] * p
        self.cool = {"assign": 0, "gshift": 0, "repair": 0,
                     "audit": 0, "quota": 0}
        self.repair_cap = self.cfg.repair_rounds
        self.audit_cadence = max(1, self.cfg.audit_cadence)
        self.assign = [candidate_index(self.cfg.cc_alg)] * p
        self.gshift = [0] * p

    # ---- static fail-safe --------------------------------------------
    def _static_decision(self, sig: CtrlSignals) -> CtrlDecision:
        from deneva_tpu_torch.cc.router import candidate_index
        p = max(self.cfg.part_cnt, 1)
        return CtrlDecision(
            seq=self.seq, epoch=sig.epoch, gov=self.gov,
            assign=[candidate_index(self.cfg.cc_alg)] * p,
            gshift=[0] * p, repair_cap=self.cfg.repair_rounds,
            audit_cadence=max(1, self.cfg.audit_cadence),
            quota_idx=0, heal=self.heal, stale_trips=self.stale_trips)

    # ---- one boundary tick -------------------------------------------
    def decide(self, sig: CtrlSignals) -> CtrlDecision:
        cfg = self.cfg
        self.seq += 1
        healthy = (sig.epochs > 0
                   and sig.gap_us <= int(cfg.ctrl_stale_s * 1e6))
        if not healthy:
            # fail-safe: revert NOW, hold until the heal streak clears
            if self.gov == GOV_ARMED:
                self.stale_trips += 1
            self.gov = GOV_STATIC
            self.heal = 0
            return self._static_decision(sig)
        if self.gov == GOV_STATIC:
            self.heal += 1
            if self.heal < cfg.ctrl_heal:
                return self._static_decision(sig)
            self.gov = GOV_ARMED      # re-engage on this very tick
        else:
            self.heal = 0

        # hysteresis classification: normalized per-partition density
        # (contended lanes per epoch per batch row, scaled by part_cnt
        # so thresholds mean "fraction of this partition's rows") with
        # lo/hi dead band + confirm streak
        p = max(cfg.part_cnt, 1)
        denom = max(sig.epochs, 1) * max(cfg.epoch_batch, 1)
        for i in range(p):
            d = sig.dens[i] * p / denom if i < len(sig.dens) else 0.0
            if d < cfg.ctrl_lo:
                c = SPARSE
            elif d > cfg.ctrl_hi:
                c = HOT
            else:
                c = self.cls[i]        # dead band: hold
            if c == self.pend[i]:
                self.streak[i] += 1
            else:
                self.pend[i] = c
                self.streak[i] = 1
            if c != self.cls[i] and self.streak[i] >= cfg.ctrl_confirm:
                self.cls[i] = c

        def tick(knob: str) -> bool:
            """A knob may move iff its cooldown expired; ticking charges
            nothing — only an actual MOVE rearms the cooldown."""
            self.cool[knob] = max(0, self.cool[knob] - 1)
            return self.cool[knob] == 0

        def moved(knob: str):
            self.cool[knob] = cfg.ctrl_cooldown

        # (a) backend + granularity per partition
        want_assign = [self.backend_map[c] for c in self.cls]
        want_gshift = [cfg.ctrl_gshift if c == SPARSE else 0
                       for c in self.cls]
        if tick("assign") and want_assign != self.assign:
            self.assign = want_assign
            moved("assign")
        if tick("gshift") and want_gshift != self.gshift:
            self.gshift = want_gshift
            moved("gshift")
        assign, gshift = list(self.assign), list(self.gshift)

        # (b) repair budget from the cyclic-fallback rate: fallback-
        # heavy epochs (winners keep re-invalidating the rest) earn
        # more sub-rounds, salvage-free ones shed them (integer cross-
        # multiplication — no float rate, replay-exact)
        if tick("repair") and cfg.repair:
            total = sig.fallback + sig.salvaged
            cap = self.repair_cap
            if 2 * sig.fallback > total and cap < cfg.repair_rounds:
                cap += 1
            elif total == 0 and cap > 1:
                cap -= 1
            if cap != self.repair_cap:
                self.repair_cap = cap
                moved("repair")

        # (d) audit cadence from witness density: any witness tightens
        # to full coverage; ctrl_confirm quiet ticks relax back
        if cfg.audit:
            self.audit_quiet = 0 if sig.witnesses > 0 \
                else self.audit_quiet + 1
            if tick("audit"):
                want = 1 if sig.witnesses > 0 else (
                    max(1, cfg.audit_cadence)
                    if self.audit_quiet >= cfg.ctrl_confirm
                    else self.audit_cadence)
                if want != self.audit_cadence:
                    self.audit_cadence = want
                    moved("audit")

        # (c) admission quota scale from the SLO-breach watchdog:
        # breaches shed a step (x0.8), a breach-free tick heals one
        if tick("quota"):
            if sig.breaches > 0 and self.quota_idx < cfg.ctrl_scale_max:
                self.quota_idx += 1
                moved("quota")
            elif sig.breaches == 0 and self.quota_idx > 0:
                self.quota_idx -= 1
                moved("quota")

        return CtrlDecision(
            seq=self.seq, epoch=sig.epoch, gov=self.gov, assign=assign,
            gshift=gshift, repair_cap=self.repair_cap,
            audit_cadence=self.audit_cadence, quota_idx=self.quota_idx,
            heal=self.heal, stale_trips=self.stale_trips)


def quota_scale(idx: int) -> float:
    """Admission quota multiplier of a scale step (0.8^idx; idx=0 is
    EXACTLY 1.0 so an idle controller never perturbs the token
    arithmetic)."""
    return 0.8 ** idx if idx > 0 else 1.0


def _ilist(vals) -> str:
    return ":".join(str(int(v)) for v in vals)


def ctrl_line(node: int, sig: CtrlSignals, dec: CtrlDecision) -> str:
    """``[ctrl]`` decision line: signals AND decision on one row, the
    replay contract's whole input (parsed by `stats.parse_ctrl`;
    same fwd/bwd-compat contract as the [repair]/[audit] families)."""
    return tagged_line("ctrl", {
        "node": node, "seq": dec.seq, "epoch": sig.epoch,
        "epochs": sig.epochs, "dens": _ilist(sig.dens) or "0",
        "fb": sig.fallback, "sv": sig.salvaged, "wit": sig.witnesses,
        "slo": sig.breaches, "gap_us": sig.gap_us, "gov": dec.gov,
        "heal": dec.heal, "trips": dec.stale_trips,
        "assign": _ilist(dec.assign), "gshift": _ilist(dec.gshift),
        "cap": dec.repair_cap, "cad": dec.audit_cadence,
        "qidx": dec.quota_idx})


def signals_of_row(row: dict) -> CtrlSignals:
    """Inverse of the signal half of `ctrl_line` (a parse_ctrl row)."""
    dens = str(row.get("dens", "0"))
    return CtrlSignals(
        epoch=int(row.get("epoch", 0)), epochs=int(row.get("epochs", 0)),
        dens=[int(x) for x in dens.split(":")],
        fallback=int(row.get("fb", 0)), salvaged=int(row.get("sv", 0)),
        witnesses=int(row.get("wit", 0)), breaches=int(row.get("slo", 0)),
        gap_us=int(row.get("gap_us", 0)))


def replay_decisions(cfg: Config, rows: list[dict],
                     backend_map: tuple | None = None) -> list[str]:
    """Decision-determinism check: re-run a fresh Controller over the
    RECORDED signals of one node's ``[ctrl]`` rows (parse_ctrl order =
    emit order = seq order) and compare every decision field against
    the recorded one.  Returns human-readable mismatch strings — empty
    list iff the log's decision stream is bit-for-bit reproducible,
    the replay oracle the ctrl chaos scenario enforces.  A run driven
    with a calibrated class->backend map replays with the SAME map."""
    ctl = Controller(cfg, backend_map=backend_map)
    bad: list[str] = []
    for row in rows:
        dec = ctl.decide(signals_of_row(row))
        for key, want in (("seq", dec.seq), ("gov", dec.gov),
                          ("assign", _ilist(dec.assign)),
                          ("gshift", _ilist(dec.gshift)),
                          ("cap", dec.repair_cap),
                          ("cad", dec.audit_cadence),
                          ("qidx", dec.quota_idx)):
            got = row.get(key)
            if str(got) != str(want):
                bad.append(f"seq={row.get('seq')} {key}: "
                           f"recorded={got!r} replayed={want!r}")
    return bad
