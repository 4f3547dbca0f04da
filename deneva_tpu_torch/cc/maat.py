"""MAAT — dynamic timestamp-range validation (port of ``deneva_tpu/cc/maat.py``).

Under epoch-snapshot execution every read saw the snapshot, so MAAT's
one ordering constraint is reader-before-writer: ``P[i, j]`` when i read
a key j writes (K7 over the read and write incidence).  P splits into:

* mutual pairs ``P & P.T`` — both ranges cannot stay open; the lex-first
  sweep over them (K8) admits the first validators, the losers abort and
  the sweep's leftovers defer;
* the residual digraph over the survivors (``live0``).  An acyclic txn
  commits however deep its chain.  The level sweep over P (K9b) gates
  the epoch: where no survivor is unstable the levels are the order.
  Otherwise the transitive closure of P over ``live0`` (K11a) marks the
  txns on a cycle; ``maat_peel_rounds`` peel rounds (K11b) abort the
  locally youngest of those still unstable both ways; a second closure
  over the survivors (K11a) defers the txns still on a cycle and gives
  the ancestor counts as the topological order.

The reference chooses the branch with ``lax.cond`` on the device.  The
port launches K11a twice and K11b once in every epoch; each kernel reads
the gate (the unstable flags) on the device and returns the fast branch's
result when it is all false, so the epoch never waits on the host and
its launch counts do not depend on the data.  K11b reads P's rows and
columns as K11a's first call packs them (over live0) and runs every peel
round in one launch of a thread-block cluster.  The plain versions
branch in Python.

Cross-epoch state is unnecessary (``()``).  The repair frontier is the
generic one (K13a, ``cc/base.py``).
"""

from __future__ import annotations

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.cc import base
from deneva_tpu_torch.cc.base import (AccessBatch, Incidence, Verdict,
                                      get_overlap)
from deneva_tpu_torch.ops import conflict

K11A_REACH = kernels.Kernel("dt_maat_reach", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.I32,
    kernels.P, kernels.I64, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P])
REACH_SMEM = 200 * 1024     # K11a's shared-memory budget (bits.cuh kSmemMax)
REACH_PIVOTS = 4            # K11a's candidates (csrc/maat.cu kPivots)
K11B_PEEL = kernels.Kernel("dt_maat_peel", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32,
    kernels.I32, kernels.I32, kernels.P, kernels.I64, kernels.P, kernels.P,
    kernels.P])


def views(cfg) -> tuple[str, ...]:
    """The incidence views `must_precede` reads (``ro`` aliases ``r``
    when no escrow exemption applies)."""
    return ("ro", "w")


def repair_frontier(cfg, state, batch, inc, committed, losers):
    """MAAT's transaction-repair rule (``deneva_tpu/cc/maat.py:107``):
    re-reading the keys on a loser's P-edges into the committed set
    re-opens its range, so the frontier is the generic one (K13a)."""
    return base.committed_write_frontier(cfg, batch, inc, committed,
                                         losers)


def must_precede(cfg, inc: Incidence, b: int) -> torch.Tensor:
    """P[i, j] = i must precede j (i read a key j writes), minus the
    diagonal (``deneva_tpu/cc/maat.py:83``)."""
    ov = get_overlap(cfg)
    ro1 = inc.r1 if inc.ro1 is None else inc.ro1
    ro2 = inc.r2 if inc.ro1 is None else inc.ro2
    p = ov(ro1, inc.w1, ro2, inc.w2)
    return p & ~torch.eye(b, dtype=torch.bool, device=p.device)


# -- K11a: closure, diagonal, ancestor counts ------------------------------

def reach_stats_plain(p: torch.Tensor, live: torch.Tensor,
                      gate: torch.Tensor, counts: bool = True):
    """``reach_of(live)`` of ``deneva_tpu/cc/maat.py:178-187`` with its
    two reductions (``:196``, ``:216-220``): (self-reachable & live
    bool[B], ancestor count int32[B], or None without ``counts``); zeros
    when ``gate`` has no set flag (the fast branch).  The closure is
    ``max(1, (B-1).bit_length())`` boolean squarings; f32 products of 0/1
    counts are exact."""
    b = p.shape[0]
    if not bool(gate.any()):
        return (torch.zeros_like(live),
                torch.zeros(b, dtype=torch.int32, device=p.device)
                if counts else None)
    r = p & live[:, None] & live[None, :]
    for _ in range(max(1, (b - 1).bit_length())):
        f = r.to(torch.float32)
        r = r | (torch.matmul(f, f) > 0)
    anc = r.sum(dim=0, dtype=torch.int32) if counts else None
    return torch.diagonal(r) & live, anc


def reach_group(b: int) -> int:
    """K11a's residual sources per block at B = ``b``: 32 where three
    32-bit words a txn fit its shared memory, else 16 (two txns a
    word)."""
    sets = 3 * -(-b // 32) * 4                    # live, C and F bits
    for s, per_word in ((32, 1), (16, 2)):
        # front, next and seen: three words of a txn's bits
        if 3 * -(-b // per_word) * 4 + sets <= REACH_SMEM:
            return s
    raise ValueError(f"K11a: B = {b} does not fit one block's shared "
                     "memory")


def reach_scratch(b: int, dev) -> torch.Tensor:
    """K11a's scratch at B = ``b`` (int32): P's live rows and columns as
    bits, ``[2, b, ceil(b / 32)]``, then the candidates' sets, txns and
    levels.  K11b reads the bits of the first call's."""
    words = -(-b // 32)
    return torch.empty(2 * b * words + 2 * REACH_PIVOTS * words
                       + 4 * REACH_PIVOTS, dtype=torch.int32, device=dev)


def reach_stats(p: torch.Tensor, live: torch.Tensor, gate: torch.Tensor,
                counts: bool = True, *, group: int | None = None,
                levels: torch.Tensor | None = None,
                stats: torch.Tensor | None = None,
                bits: torch.Tensor | None = None):
    """K11a: the transitive closure of ``P`` over ``live`` on bits: the
    largest strongly connected set C that one of `REACH_PIVOTS`
    candidates' two searches find, whose txns all reach the candidate's
    set F, and a multi-source search (a block per ``group`` of 32 or 16
    sources, `reach_group` by default) from every other live txn; then the
    diagonal and, with ``counts``, the column counts (else None).
    Skipped on the device when ``gate`` is all false.  ``levels`` (int32,
    one entry a group) gets the levels each group took; ``stats`` (int32
    [4]) the chosen candidate, |C|, the residual's size and the
    candidate's levels.  ``bits`` (`reach_scratch`; None for a new one)
    is the kernel's scratch, which a caller keeps for `peel`."""
    if kernels.on_cpu(p, live, gate):
        return reach_stats_plain(p, live, gate, counts)
    b = live.shape[0]
    dev = live.device
    kernels.check("p", p, torch.bool, (b, b), dev)
    kernels.check("live", live, torch.bool, (b,), dev)
    kernels.check("gate", gate, torch.bool, (b,), dev)
    group = reach_group(b) if group is None else group
    if levels is not None:
        kernels.check("levels", levels, torch.int32, (-(-b // group),), dev)
    if stats is not None:
        kernels.check("stats", stats, torch.int32, (4,), dev)
    scratch = reach_scratch(b, dev) if bits is None else bits
    kernels.check("bits", scratch, torch.int32, None, dev)
    self_reach = torch.empty(b, dtype=torch.bool, device=dev)
    anc = torch.empty(b, dtype=torch.int32, device=dev) if counts else None
    K11A_REACH.launch(kernels.ptr(p), kernels.ptr(live), kernels.ptr(gate),
                      b, group, int(counts), kernels.ptr(scratch),
                      scratch.numel(), kernels.ptr(self_reach),
                      None if anc is None else kernels.ptr(anc),
                      None if levels is None else kernels.ptr(levels),
                      None if stats is None else kernels.ptr(stats),
                      kernels.stream(live))
    return self_reach, anc


# -- K11b: the peel -----------------------------------------------------------

def younger(rank: torch.Tensor) -> torch.Tensor:
    """gt[i, j]: j validated after i — the higher rank, on equal rank the
    higher lane (``deneva_tpu/cc/maat.py:140-142``)."""
    lane = torch.arange(rank.shape[0], dtype=torch.int32, device=rank.device)
    return (rank[None, :] > rank[:, None]) | (
        (rank[None, :] == rank[:, None]) & (lane[None, :] > lane[:, None]))


def peel_plain(p, live0, on_cycle0, rank, rounds: int, peel_rounds: int,
               gate):
    """``peel`` of ``deneva_tpu/cc/maat.py:201-209`` for
    ``peel_rounds`` rounds: each aborts the members of the initial cycle
    set still unstable both ways that have no younger such neighbour in
    ``P | P.T``.  Returns the aborted mask (zeros when ``gate`` is all
    false)."""
    aborted = torch.zeros_like(live0)
    if not bool(gate.any()):
        return aborted
    gt = younger(rank)
    sym = p | p.T
    for _ in range(peel_rounds):
        live = live0 & ~aborted
        _, un_f = conflict.precedence_levels_plain(p, live, rounds)
        _, un_r = conflict.precedence_levels_plain(p.T, live, rounds)
        candr = un_f & un_r & on_cycle0
        nb = sym & candr[:, None] & candr[None, :]
        has_younger = (nb & gt).any(dim=1)
        aborted = aborted | (candr & ~has_younger)
    return aborted


def peel_layout(b: int, max_ctas: int = 0) -> tuple[int, bool, int]:
    """K11b's launch at B = ``b`` as the kernel library chooses it (CUDA
    only): (CTAs of its cluster, P's rows in shared memory rather than
    read from L2, int32 words of the bits it reads).  ``max_ctas`` (1, 2,
    4, 8 or 16) caps the cluster; 0 takes the library's choice."""
    ctas, shared, words = kernels.layout("dt_maat_peel_layout", b, max_ctas)
    return ctas, bool(shared), words


def peel(p, live0, on_cycle0, rank, rounds: int, peel_rounds: int, gate,
         *, bits: torch.Tensor | None):
    """K11b: every peel round in one launch of a thread-block cluster
    (`peel_layout`) over ``P`` and ``P.T`` as bit rows; skipped on the
    device when ``gate`` is all false.  ``bits`` is the scratch of
    `reach_stats`' call over ``(p, live0, gate)``, which holds them
    packed over ``live0`` (``validate_maat`` hands it over); on the CPU,
    where the plain version runs, it is None."""
    return _peel(p, live0, on_cycle0, rank, rounds, peel_rounds, gate,
                 bits=bits)


def _peel(p, live0, on_cycle0, rank, rounds: int, peel_rounds: int, gate,
          *, bits: torch.Tensor | None, stats: torch.Tensor | None = None,
          max_ctas: int = 0):
    """`peel`, and for measuring cluster sizes against each other:
    ``stats`` (int32 [4]) gets the peel rounds with candidates, the sweep
    exchanges, the victims and the cluster's CTAs; ``max_ctas`` caps the
    cluster (`peel_layout`)."""
    if kernels.on_cpu(p, live0, on_cycle0, rank, gate):
        return peel_plain(p, live0, on_cycle0, rank, rounds, peel_rounds,
                          gate)
    b = live0.shape[0]
    dev = live0.device
    if bits is None:
        raise ValueError("peel: the bits of reach_stats' call over live0 "
                         "are needed on the card")
    kernels.check("p", p, torch.bool, (b, b), dev)
    for name, t in (("live0", live0), ("on_cycle0", on_cycle0),
                    ("gate", gate)):
        kernels.check(name, t, torch.bool, (b,), dev)
    kernels.check("rank", rank, torch.int32, (b,), dev)
    if stats is not None:
        kernels.check("stats", stats, torch.int32, (4,), dev)
    kernels.check("bits", bits, torch.int32, None, dev)
    aborted = torch.empty(b, dtype=torch.bool, device=dev)
    K11B_PEEL.launch(kernels.ptr(live0), kernels.ptr(on_cycle0),
                     kernels.ptr(rank), kernels.ptr(gate), b, rounds,
                     peel_rounds, max_ctas, kernels.ptr(bits), bits.numel(),
                     kernels.ptr(aborted),
                     None if stats is None else kernels.ptr(stats),
                     kernels.stream(live0))
    return aborted


def validate_maat(cfg, state, batch: AccessBatch, inc: Incidence):
    b = batch.active.shape[0]
    p = must_precede(cfg, inc, b)
    lane = torch.arange(b, dtype=torch.int32, device=p.device)

    # stage 1: mutual pairs -> lex-first sweep, losers' ranges close
    win, lose, und = conflict.first_fit(p & p.T, batch.rank, batch.active,
                                        cfg.sweep_rounds)
    closed = lose & batch.active
    defer = und & batch.active

    # stage 2: the residual digraph over the survivors; the level gate,
    # then (on the device, where it is set) closure, peel, closure
    live0 = batch.active & ~closed & ~defer
    lv_f, un_f0 = conflict.precedence_levels(p, live0, cfg.sweep_rounds)
    # K11b reads the bits that K11a's first call packs over live0
    bits = None if kernels.on_cpu(p) else reach_scratch(b, p.device)
    on_cycle0, _ = reach_stats(p, live0, un_f0, counts=False, bits=bits)
    aborted = peel(p, live0, on_cycle0, batch.rank, cfg.sweep_rounds,
                   cfg.maat_peel_rounds, un_f0, bits=bits)
    defer2, anc = reach_stats(p, live0 & ~aborted, un_f0)
    ordkey = torch.where(un_f0.any(), anc, lv_f)

    defer = defer | (defer2 & live0)
    commit = live0 & ~aborted & ~defer2
    v = Verdict(commit=commit, abort=(closed | aborted) & batch.active,
                defer=defer, order=ordkey * b + lane,
                level=torch.zeros_like(batch.rank))
    return v, state
