"""Conflict incidence, overlap and the serialization sweep (port of ``deneva_tpu/ops/conflict.py``).

An epoch's padded RW-sets are hashed into K buckets and expanded into
bf16 incidence rows; ``(A @ B.T) > 0`` says which txn pairs touch a
common bucket; the lex-first maximal-independent-set sweep turns that
boolean matrix plus a priority order into win / lose / undecided.  A
bucket collision or an undecided leftover only adds conflicts or
deferrals, never hides one.

Three kernels carry it on the card (``csrc/conflict.cu``), each beside
its plain PyTorch version, written op for op from the reference:

* **K5+K6** `hashed_incidence` — replaces ``ops/hashing.py:25,37`` and
  ``ops/conflict.py:47`` `access_incidence` as ``cc/base.py:587``
  `build_incidence` calls them: one launch hashes every lane in each
  family and writes the requested count rows plus family 0's bucket ids.
* **K7** `overlap` — replaces ``ops/conflict.py:63``: on count rows the
  product is positive exactly where two rows share a positive bucket, so
  the kernel builds bitmaps of the B side's buckets and ORs, for each A
  row, the bitmaps of its positive buckets (each input read once), with
  the AND of the second family.
* **K8** `first_fit` — replaces ``ops/conflict.py:78`` `earlier_edges`
  fused into ``:96`` `greedy_first_fit`: the edges packed to bits, then
  the Jacobi rounds in one thread-block cluster whose CTAs share out the
  rows, read only the pending ones, and exchange each round's verdicts
  in distributed shared memory.

Two more carry the level sweeps (``csrc/levels.cu``), one max-plus
relaxation in two orientations:

* **K9a** `wavefront` — replaces ``ops/conflict.py:123``
  `wavefront_levels` with ``:78`` `earlier_edges` fused into its bit
  packing, as ``cc/calvin.py:62-65`` calls them on ``uw | uw.T``: the
  longest chain depth along the rows of the earlier-edge DAG, clamped,
  with the overflow flags (`validate_calvin`'s levels).
* **K9b** `precedence_levels` — replaces ``ops/conflict.py:141``: the
  same along the columns of a possibly cyclic digraph restricted to the
  active txns, with the instability flags (MAAT's gate).  One launch of a
  thread-block cluster whose CTAs each pack their txns' predecessor rows
  from P's column strip (into shared memory, or into L2 where they do
  not fit: `precedence_levels_layout`) and exchange each round's
  frontier words in distributed shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.ops.hashing import bucket_hash, combine_key

# incidence views of one hash family, in the kernel's output order:
# reads, writes, union, pure reads, then the ordered (non order_free)
# copies of each (cc/base.py Incidence)
VIEWS = ("r", "w", "u", "pr", "uo", "ro", "wo", "pro")
ORDERED = {"uo": "u", "ro": "r", "wo": "w", "pro": "pr"}

K56_INCIDENCE = kernels.Kernel("dt_build_incidence", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.I32, kernels.I32, kernels.I32, kernels.I32,
    kernels.P, kernels.P, kernels.P])
K7_OVERLAP = kernels.Kernel("dt_overlap", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32,
    kernels.I32, kernels.P, kernels.P, kernels.P])
K8_FIRST_FIT = kernels.Kernel("dt_first_fit", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.P,
    kernels.I64, kernels.P, kernels.P, kernels.P, kernels.P])
K9A_WAVEFRONT = kernels.Kernel("dt_wavefront_levels", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.P,
    kernels.P, kernels.P, kernels.P])
K9B_PRECEDENCE = kernels.Kernel("dt_precedence_levels", [
    kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.I32, kernels.I32,
    kernels.P, kernels.I64, kernels.P, kernels.P, kernels.P, kernels.P])


# -- K6: incidence ------------------------------------------------------

def access_incidence(bucket_ids: torch.Tensor, valid: torch.Tensor,
                     n_buckets: int) -> torch.Tensor:
    """bf16[B, K] access counts of the valid lanes (exact for A <= 256)."""
    b, a = bucket_ids.shape
    rows = torch.arange(b, dtype=torch.int64,
                        device=bucket_ids.device)[:, None].expand(b, a)
    cols = torch.where(valid, bucket_ids, 0).to(torch.int64)
    inc = torch.zeros((b, n_buckets), dtype=torch.bfloat16,
                      device=bucket_ids.device)
    return inc.index_put_((rows, cols), valid.to(torch.bfloat16),
                          accumulate=True)


def lane_masks(is_read, is_write, valid, active, order_free=None) -> dict:
    """Each view's lane mask (``cc/base.py:594-598``, ``:608-613``); the
    ordered views only when ``order_free`` is given."""
    v = valid & active[:, None]
    r, w = v & is_read, v & is_write
    pr = r & ~w
    m = {"r": r, "w": w, "u": r | w, "pr": pr}
    if order_free is not None:
        of = ~order_free
        m.update(uo=(r | w) & of, ro=r & of, wo=w & of, pro=pr & of)
    return m


def hashed_incidence_plain(table_ids, keys, is_read, is_write, valid,
                           active, order_free, n_buckets: int,
                           families: int, views: tuple[str, ...]):
    """Plain K5+K6.  Returns ([{view: bf16[B, K]} per family], bucket1)."""
    ident = combine_key(table_ids, keys)
    masks = lane_masks(is_read, is_write, valid, active, order_free)
    b1 = bucket_hash(ident, n_buckets, family=0)
    out = []
    for f in range(families):
        b = b1 if f == 0 else bucket_hash(ident, n_buckets, family=f)
        out.append({nm: access_incidence(b, masks[nm], n_buckets)
                    for nm in views})
    return out, b1


def hashed_incidence(table_ids, keys, is_read, is_write, valid, active,
                     order_free, n_buckets: int, families: int,
                     views: tuple[str, ...]):
    """K5+K6: hash every lane in ``families`` families and build the
    requested views' count rows in one launch.  ``views`` name entries of
    `VIEWS`; the ordered ones need ``order_free``."""
    for nm in views:
        if nm not in VIEWS or (nm in ORDERED and order_free is None):
            raise ValueError(f"incidence view {nm!r} not available")
    if kernels.on_cpu(keys, active):
        return hashed_incidence_plain(table_ids, keys, is_read, is_write,
                                      valid, active, order_free, n_buckets,
                                      families, views)
    b, a = keys.shape
    dev = keys.device
    for name, t, dt in (("table_ids", table_ids, torch.int32),
                        ("keys", keys, torch.int32),
                        ("is_read", is_read, torch.bool),
                        ("is_write", is_write, torch.bool),
                        ("valid", valid, torch.bool)):
        kernels.check(name, t, dt, (b, a), dev)
    kernels.check("active", active, torch.bool, (b,), dev)
    if order_free is not None:
        kernels.check("order_free", order_free, torch.bool, (b, a), dev)
    if a > 256 or n_buckets < 8 or n_buckets & (n_buckets - 1) \
            or families not in (1, 2):
        raise ValueError("K5+K6 takes A <= 256 lanes, a power-of-two "
                         "K >= 8 and one or two families")
    out = [{nm: torch.empty((b, n_buckets), dtype=torch.bfloat16,
                            device=dev) for nm in views}
           for _ in range(families)]
    ptrs = (ctypes.c_void_p * 16)()
    for f, fam in enumerate(out):
        for nm, t in fam.items():
            ptrs[8 * f + VIEWS.index(nm)] = t.data_ptr()
    b1 = torch.empty((b, a), dtype=torch.int32, device=dev)
    K56_INCIDENCE.launch(
        kernels.ptr(table_ids), kernels.ptr(keys), kernels.ptr(is_read),
        kernels.ptr(is_write), kernels.ptr(valid), kernels.ptr(active),
        None if order_free is None else kernels.ptr(order_free), b, a,
        n_buckets, families, ctypes.cast(ptrs, ctypes.c_void_p),
        kernels.ptr(b1), kernels.stream(keys))
    return out, b1


# -- K7: overlap --------------------------------------------------------

def overlap_plain(inc_a, inc_b, inc_a2=None, inc_b2=None) -> torch.Tensor:
    """bool[B, B]: does txn i's A-set share a bucket with txn j's B-set?
    f32 products of the integer counts are exact."""
    m = torch.matmul(inc_a.float(), inc_b.float().T) > 0
    if inc_a2 is not None:
        m &= torch.matmul(inc_a2.float(), inc_b2.float().T) > 0
    return m


def overlap(inc_a, inc_b, inc_a2=None, inc_b2=None) -> torch.Tensor:
    """K7: both families' overlaps and their AND, in two launches.

    Precondition: the rows are K5+K6 count rows, non-negative integers
    (as every caller passes).  Then ``(A @ B.T)[i, j] > 0`` holds exactly
    when some bucket k has ``A[i, k] > 0`` and ``B[j, k] > 0``, which is
    what the kernel computes: bitmaps of the B side's positive buckets
    (scratch allocated here), then each A row ORs the bitmaps of its
    positive buckets.  ``inc_a`` may be the same tensor as ``inc_b``."""
    two = inc_a2 is not None
    if kernels.on_cpu(inc_a, inc_b, *((inc_a2, inc_b2) if two else ())):
        return overlap_plain(inc_a, inc_b, inc_a2, inc_b2)
    m, k = inc_a.shape
    n = inc_b.shape[0]
    dev = inc_a.device
    kernels.check("inc_a", inc_a, torch.bfloat16, (m, k), dev)
    kernels.check("inc_b", inc_b, torch.bfloat16, (n, k), dev)
    if two:
        kernels.check("inc_a2", inc_a2, torch.bfloat16, (m, k), dev)
        kernels.check("inc_b2", inc_b2, torch.bfloat16, (n, k), dev)
    if k % 8:
        raise ValueError("K7 loads 16-byte rows: K must be a multiple of 8")
    out = torch.empty((m, n), dtype=torch.bool, device=dev)
    bits = torch.empty((2 if two else 1) * k * -(-n // 32),
                       dtype=torch.int32, device=dev)
    K7_OVERLAP.launch(kernels.ptr(inc_a), kernels.ptr(inc_b),
                      kernels.ptr(inc_a2) if two else None,
                      kernels.ptr(inc_b2) if two else None, m, n, k,
                      kernels.ptr(bits), kernels.ptr(out),
                      kernels.stream(inc_a))
    return out


# -- K8: the sweep ------------------------------------------------------

def earlier_edges(conflict: torch.Tensor, rank: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """E[i, j] = active j precedes active i by (rank, lane) and conflicts."""
    b = conflict.shape[0]
    lane = torch.arange(b, dtype=torch.int32, device=conflict.device)
    lt = rank[None, :] < rank[:, None]
    eq = rank[None, :] == rank[:, None]
    before = lt | (eq & (lane[None, :] < lane[:, None]))
    act = active[:, None] & active[None, :]
    return conflict & before & act


def greedy_first_fit(edges: torch.Tensor, active: torch.Tensor,
                     rounds: int = 24):
    """Lex-first maximal-independent-set sweep, ``rounds`` Jacobi rounds.
    Returns (win, lose, undecided) partitioning ``active``."""
    e = edges.to(torch.float32)
    win = torch.zeros_like(active)
    lose = torch.zeros_like(active)
    for _ in range(rounds):
        pending = active & ~win & ~lose
        blocked = (e @ (~lose).to(torch.float32)) > 0
        hit = (e @ win.to(torch.float32)) > 0
        new_win = pending & ~blocked
        new_lose = pending & hit
        win, lose = win | new_win, lose | (new_lose & ~new_win)
    return win, lose, active & ~win & ~lose


def first_fit_plain(conflict, rank, active, rounds: int):
    return greedy_first_fit(earlier_edges(conflict, rank, active), active,
                            rounds)


def first_fit_layout(b: int) -> tuple[int, bool, int]:
    """K8's launch at ``b`` txns as the kernel library chooses it (CUDA
    only): (CTAs of its cluster, edge rows in shared memory rather than
    L2, int32 words of scratch)."""
    ctas, in_smem, words = kernels.layout("dt_first_fit_layout", b)
    return ctas, bool(in_smem), words


def first_fit(conflict: torch.Tensor, rank: torch.Tensor,
              active: torch.Tensor, rounds: int):
    """K8: `earlier_edges` packed to bits with each row's edge count, then
    the sweep in one cluster of CTAs (`first_fit_layout`)."""
    if kernels.on_cpu(conflict, rank, active):
        return first_fit_plain(conflict, rank, active, rounds)
    b = active.shape[0]
    dev = active.device
    kernels.check("conflict", conflict, torch.bool, (b, b), dev)
    kernels.check("rank", rank, torch.int32, (b,), dev)
    kernels.check("active", active, torch.bool, (b,), dev)
    if 5 * -(-b // 32) * 4 > 200 * 1024:
        raise ValueError("K8 keeps five B-bit sets in shared memory: "
                         f"B = {b} is too large")
    words = first_fit_layout(b)[2]
    bits = torch.empty(words, dtype=torch.int32, device=dev)
    win, lose, und = (torch.empty(b, dtype=torch.bool, device=dev)
                      for _ in range(3))
    K8_FIRST_FIT.launch(kernels.ptr(conflict), kernels.ptr(rank),
                        kernels.ptr(active), b, rounds, kernels.ptr(bits),
                        words, kernels.ptr(win), kernels.ptr(lose),
                        kernels.ptr(und), kernels.stream(active))
    return win, lose, und


# -- K9: the level sweeps -------------------------------------------------

def wavefront_levels(edges: torch.Tensor, max_level: int):
    """Longest-chain depth per txn in the (DAG) earlier-edges graph,
    ``max_level + 1`` Jacobi rounds.  Returns (levels int32[B] clamped to
    ``max_level``, overflow bool[B])."""
    lv = torch.zeros(edges.shape[0], dtype=torch.int32, device=edges.device)
    for _ in range(max_level + 1):
        cand = torch.where(edges, lv[None, :] + 1, 0)
        lv = torch.maximum(lv, cand.amax(dim=1))
    return torch.clamp_max(lv, max_level), lv > max_level


def wavefront_plain(uw: torch.Tensor, rank: torch.Tensor,
                    active: torch.Tensor, max_level: int):
    """Plain K9a: the levels of the earlier edges of the symmetric
    conflicts ``uw | uw.T``."""
    return wavefront_levels(earlier_edges(uw | uw.T, rank, active),
                            max_level)


def precedence_levels_plain(prec: torch.Tensor, active: torch.Tensor,
                            rounds: int):
    """Longest-path levels of a possibly cyclic must-precede digraph
    (``P[i, j]``: i before j) over the active txns, ``rounds`` Jacobi
    rounds and one probe round.  Returns (levels int32[B], unstable
    bool[B]): a level still moving on the probe, or at the round cap."""
    p = prec & active[:, None] & active[None, :]

    def body(lv):
        cand = torch.where(p, lv[:, None] + 1, 0)
        return torch.maximum(lv, cand.amax(dim=0))
    lv = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    for _ in range(rounds):
        lv = body(lv)
    lv2 = body(lv)
    return lv, ((lv2 != lv) | (lv >= rounds)) & active


def wavefront(uw: torch.Tensor, rank: torch.Tensor, active: torch.Tensor,
              max_level: int):
    """K9a: the earlier edges of ``uw | uw.T`` built as they are packed to
    bits (``uw``'s columns by a tiled transpose, then its rows), then the
    rounds in one block."""
    if kernels.on_cpu(uw, rank, active):
        return wavefront_plain(uw, rank, active, max_level)
    b = active.shape[0]
    dev = active.device
    kernels.check("uw", uw, torch.bool, (b, b), dev)
    kernels.check("rank", rank, torch.int32, (b,), dev)
    kernels.check("active", active, torch.bool, (b,), dev)
    if max_level < 0:
        raise ValueError("K9a takes max_level >= 0")
    bits = torch.empty((2 * b + 1, -(-b // 32)), dtype=torch.int32,
                       device=dev)
    lv = torch.empty(b, dtype=torch.int32, device=dev)
    over = torch.empty(b, dtype=torch.bool, device=dev)
    K9A_WAVEFRONT.launch(kernels.ptr(uw), kernels.ptr(rank),
                         kernels.ptr(active), b, max_level, kernels.ptr(bits),
                         kernels.ptr(lv), kernels.ptr(over),
                         kernels.stream(active))
    return lv, over


def precedence_levels_layout(b: int, ctas: int = 0,
                             regime: int = -1) -> tuple[int, bool, int]:
    """K9b's launch at ``b`` txns as the kernel library chooses it (CUDA
    only), in exactly ``ctas`` CTAs (0: its choice) and in
    ``regime`` (-1: its choice, 0: staged, 1: L2): (CTAs of its cluster,
    whether the cluster packs P itself into shared memory, int32 words of
    scratch).  Raises where no layout fits."""
    c, staged, words = kernels.layout("dt_precedence_levels_layout", b,
                                      ctas, regime)
    return c, bool(staged), words


def precedence_levels(prec: torch.Tensor, active: torch.Tensor,
                      rounds: int, ctas: int = 0, regime: int = -1,
                      stamps: torch.Tensor | None = None):
    """K9b: one cluster launch whose CTAs pack their txns' predecessor
    rows from P's column strips, into shared memory or, where they do not
    fit, into an L2 scratch, and run the rounds from F_1
    (`precedence_levels_layout`; ``ctas`` and ``regime`` pin it).
    ``stamps`` (CUDA, int64[8], or None) receives CTA 0's phase clocks
    (``csrc/levels.cu``)."""
    if kernels.on_cpu(prec, active):
        return precedence_levels_plain(prec, active, rounds)
    b = active.shape[0]
    dev = active.device
    kernels.check("prec", prec, torch.bool, (b, b), dev)
    kernels.check("active", active, torch.bool, (b,), dev)
    if rounds < 0:
        raise ValueError("K9b takes rounds >= 0")
    lv = torch.empty(b, dtype=torch.int32, device=dev)
    unstable = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return lv, unstable
    words = precedence_levels_layout(b, ctas, regime)[2]
    bits = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
    K9B_PRECEDENCE.launch(kernels.ptr(prec), kernels.ptr(active), b, rounds,
                          ctas, regime, kernels.ptr(bits), words,
                          kernels.ptr(lv), kernels.ptr(unstable),
                          None if stamps is None else kernels.ptr(stamps),
                          kernels.stream(active))
    return lv, unstable
