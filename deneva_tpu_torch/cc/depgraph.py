"""Dependency-graph primitives (port of the part of ``deneva_tpu/cc/depgraph.py`` DGCC runs).

The epoch's exact-key conflict graph as one lane sort plus segmented
scans: every ordered access doubles into a read lane and a write lane,
the lanes sort by (combined key, position), and inside each key segment
the nearest preceding writer / reader of a lane names its dependency
edges.  Lane positions carry write-ness in their parity (write positions
odd, read positions even); dead lanes carry the key sentinel `LANE_PAD`
and sort to the tail.  The audit plane's edge codecs, ``next_writer``,
``compact_lanes``, ``version_select`` and ``witness_count`` come with
ROADMAP.md queue 1, item 16c.

Combined keys are held as int64 in ``[0, 2^32)`` (`ops.hashing`), so the
sort is on the UNSIGNED key and `LANE_PAD` (``0xFFFFFFFF``) sorts last.
One real key per table combines to that value; DGCC treats it as dead,
as the reference does (``live = sk != LANE_PAD``).

Two kernels carry it on the card (``csrc/depgraph.cu``), each beside its
plain version:

* **K15a** `lane_sort` — replaces ``depgraph.py:54``: an LSD radix sort of
  ``key << (P + T) | pos << T | tid`` words;
* **K15b** `census` — replaces ``:63`` `segment_bounds` and ``:70``
  `prev_writer` as ``cc/dgcc.py:106-122`` applies them: segment heads,
  the nearest preceding live writer and reader of each lane, and the
  count of dependency lanes.

`segment_bounds`, `prev_writer` and `seg_excl_max` (``:89``) are the
plain building blocks, op for op from the reference; the relaxation's
segmented maxima run inside K16 (`cc/dgcc.py`).
"""

from __future__ import annotations

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.ops.forward import SORT_TILE, _seg_scan, _shift1

# key sentinel for dead lanes (uint32 max: sorts after every real key)
LANE_PAD = 0xFFFFFFFF

K15A_SORT = kernels.Kernel("dt_lane_sort", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.I32,
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P])
K15B_SCANS = kernels.Kernel("dt_seg_scans", [
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P, kernels.P])

SCAN_TILE = 1024        # lanes per census block (csrc/depgraph.cu)


def _keep_last(va: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Last-write carry of the writer scans: the newest non-negative value."""
    return torch.where(v >= 0, v, va)


# -- K15a: the lane sort ------------------------------------------------------

def lane_sort_plain(keys: torch.Tensor, pos: torch.Tensor, tid: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K15a: lanes ordered by (key, pos), keys int64 in [0, 2^32) and
    pos in [0, 2^31), as one packed int64 sort key."""
    order = torch.argsort(keys * (1 << 31) + pos.to(torch.int64),
                          stable=True)
    return keys[order], pos[order], tid[order]


def lane_sort(keys: torch.Tensor, pos: torch.Tensor, tid: torch.Tensor,
              n_txn: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K15a: (sorted keys int64, positions int32, txn ids int32) of the
    lanes by (key, pos).  The caller guarantees ``pos < 2 * n_txn``, ``tid
    < n_txn`` and equal ``tid`` on equal (key, pos), as DGCC's doubled
    lanes have them; the kernel packs all three into one word."""
    if kernels.on_cpu(keys, pos, tid):
        return lane_sort_plain(keys, pos, tid)
    n = keys.shape[0]
    dev = keys.device
    kernels.check("keys", keys, torch.int64, (n,), dev)
    kernels.check("pos", pos, torch.int32, (n,), dev)
    kernels.check("tid", tid, torch.int32, (n,), dev)
    tid_bits = max(1, (n_txn - 1).bit_length())
    pos_bits = max(1, (2 * n_txn - 1).bit_length())
    if pos_bits + tid_bits > 32:
        raise ValueError("K15a packs pos and tid into 32 bits: n_txn must "
                         "be at most 2^15")
    words = torch.empty(n, dtype=torch.int64, device=dev)
    tmp = torch.empty_like(words)
    counts = torch.empty(256 * (-(-n // SORT_TILE) + 1), dtype=torch.int32,
                         device=dev)
    sk = torch.empty(n, dtype=torch.int64, device=dev)
    sp = torch.empty(n, dtype=torch.int32, device=dev)
    sid = torch.empty(n, dtype=torch.int32, device=dev)
    K15A_SORT.launch(kernels.ptr(keys), kernels.ptr(pos), kernels.ptr(tid),
                     n, pos_bits, tid_bits, kernels.ptr(words),
                     kernels.ptr(tmp), kernels.ptr(counts), kernels.ptr(sk),
                     kernels.ptr(sp), kernels.ptr(sid), kernels.stream(keys))
    return sk, sp, sid


# -- the reference's scan helpers (plain) -------------------------------------

def segment_bounds(sk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(head, tail) masks of the key segments of a sorted key array."""
    one = torch.ones(1, dtype=torch.bool, device=sk.device)
    diff = sk[1:] != sk[:-1]
    return torch.cat([one, diff]), torch.cat([diff, one])


def prev_writer(head: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Nearest PRECEDING writer within each key segment: ``cand`` holds
    the txn id on writer lanes, -1 elsewhere; exclusive, -1 when none."""
    p = _shift1(_seg_scan(head, cand, _keep_last), -1)
    return torch.where(head, -1, p)


def seg_excl_max(head: torch.Tensor, vals: torch.Tensor, neutral: int = -1
                 ) -> torch.Tensor:
    """Exclusive segmented running max (``neutral`` at segment heads)."""
    m = _shift1(_seg_scan(head, vals, torch.maximum), neutral)
    return torch.where(head, neutral, m)


# -- K15b: the edge census ----------------------------------------------------

def census_plain(sk: torch.Tensor, sp: torch.Tensor, sid: torch.Tensor):
    """Plain K15b, op for op from ``deneva_tpu/cc/dgcc.py:106-122``:
    (head bool, pw int32, pr int32, edge_cnt int32 scalar)."""
    sw = (sp & 1) == 1
    live = sk != LANE_PAD
    head, _tail = segment_bounds(sk)
    pw = prev_writer(head, torch.where(sw & live, sid, -1))
    pr = prev_writer(head, torch.where(~sw & live, sid, -1))
    dep = live & (((pw >= 0) & (pw != sid))
                  | (sw & (pr >= 0) & (pr != sid)))
    return head, pw, pr, dep.sum().to(torch.int32)


def census(sk: torch.Tensor, sp: torch.Tensor, sid: torch.Tensor):
    """K15b: segment heads, nearest preceding live writer / reader per
    lane and the dependency-lane count of sorted lanes, in one launch of
    three passes (tile maxima, the carries, the tiles)."""
    if kernels.on_cpu(sk, sp, sid):
        return census_plain(sk, sp, sid)
    n = sk.shape[0]
    dev = sk.device
    kernels.check("sk", sk, torch.int64, (n,), dev)
    kernels.check("sp", sp, torch.int32, (n,), dev)
    kernels.check("sid", sid, torch.int32, (n,), dev)
    head = torch.empty(n, dtype=torch.bool, device=dev)
    pw = torch.empty(n, dtype=torch.int32, device=dev)
    pr = torch.empty(n, dtype=torch.int32, device=dev)
    edge_cnt = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(6 * -(-n // SCAN_TILE), dtype=torch.int32,
                          device=dev)
    K15B_SCANS.launch(kernels.ptr(sk), kernels.ptr(sp), kernels.ptr(sid), n,
                      kernels.ptr(head), kernels.ptr(pw), kernels.ptr(pr),
                      kernels.ptr(edge_cnt), kernels.ptr(scratch),
                      kernels.stream(sk))
    return head, pw, pr, edge_cnt
