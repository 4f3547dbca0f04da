"""Dependency-graph primitives (port of ``deneva_tpu/cc/depgraph.py``).

The epoch's exact-key conflict graph as one lane sort plus segmented
scans: every ordered access doubles into a read lane and a write lane,
the lanes sort by (combined key, position), and inside each key segment
the nearest preceding writer / reader of a lane names its dependency
edges.  Lane positions carry write-ness in their parity (write positions
odd, read positions even); dead lanes carry the key sentinel `LANE_PAD`
and sort to the tail.  DGCC (`cc.dgcc`) and the isolation audit plane
(`cc.base.audit_observe`) share it.

Combined keys are held as int64 in ``[0, 2^32)`` (`ops.hashing`), so the
sort is on the UNSIGNED key and `LANE_PAD` (``0xFFFFFFFF``) sorts last.
One real key per table combines to that value; both consumers treat it
as dead, as the reference does (``live = sk != LANE_PAD``).

Four kernels carry it on the card, each beside its plain version:

* **K15a** `lane_sort` (``csrc/depgraph.cu``) — replaces
  ``depgraph.py:54``: an LSD radix sort of ``key << (P + T) | pos << T |
  tid`` words where ``P + T <= 32``, else (the audit's wide positions)
  of ``key << 32 | pos`` words with the txn id as payload;
* **K15b** `census` (``csrc/depgraph.cu``) — replaces ``:63``
  `segment_bounds` and ``:70`` `prev_writer` as ``cc/dgcc.py:106-122``
  applies them: segment heads, the nearest preceding live writer and
  reader of each lane, and the count of dependency lanes;
* **K15c-scan** `audit_scans` (``csrc/audit.cu``) — replaces the audit's
  use of ``:63``, ``:70``, ``:81`` `next_writer` and ``:97`` `pack_edge`
  (``cc/base.py:469-492``): the nearest preceding and following live
  writer of each lane, the flagged wr / ww / rw edges, the lane's audit
  bucket and the epoch-start observation mask;
* **K15c-compact** `compact_edges` (``csrc/audit.cu``) — replaces
  ``:115`` `compact_lanes` (cap ``audit_edges_max``, counted overflow)
  with ``:155`` `witness_count` fused over the kept edges.

`segment_bounds`, `prev_writer`, `next_writer`, `seg_excl_max` (``:89``),
the codecs, `compact_lanes`, `version_select` (``:136``) and
`witness_count` are the plain building blocks, op for op from the
reference; the relaxation's segmented maxima run inside K16
(`cc/dgcc.py`), and `version_select` inside K17 (`cc/base.py`).

Every audit kernel takes an optional device flag ``due`` (the cadence
gate): when it holds False the sort and the scans return at once and the
compaction writes the reference's skip outputs, so an epoch off the
cadence launches the same kernels and never syncs the host.
"""

from __future__ import annotations

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.ops.forward import _seg_scan, _shift1, sort_scratch
from deneva_tpu_torch.ops.hashing import bucket_hash

# key sentinel for dead lanes (uint32 max: sorts after every real key)
LANE_PAD = 0xFFFFFFFF
# exported edge kinds, packed as kind << 28 | src << 14 | dst
AUDIT_WW, AUDIT_WR, AUDIT_RW = 0, 1, 2

P, I32 = kernels.P, kernels.I32
K15A_SORT = kernels.Kernel("dt_lane_sort", [
    P, P, P, I32, I32, I32, I32, P, P, P, P, P, P, P, P, P, P])
K15B_SCANS = kernels.Kernel("dt_seg_scans", [
    P, P, P, I32, P, P, P, P, P, P])
K15C_SCAN = kernels.Kernel("dt_audit_scans", [
    P, P, P, I32, I32, P, P, P, P, P, P, P])
K15C_COMPACT = kernels.Kernel("dt_compact_edges", [
    P, P, P, I32, I32, P, I32, P, P, P, P, P, P, P, P])

SCAN_TILE = 1024        # lanes per census / scan block (csrc/*.cu)


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
              n_txn: int, pos_bound: int | None = None,
              due: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K15a: (sorted keys int64, positions int32, txn ids int32) of the
    lanes by (key, pos), ties in lane order.  The caller guarantees ``pos
    < pos_bound`` (default ``2 * n_txn``, DGCC's doubled lanes) and ``tid
    < n_txn``.  When the two fields fit 32 bits the kernel packs all three
    into one word; otherwise it sorts ``key << 32 | pos`` with the txn id
    as payload (the audit's positions at B = 16,384).  With ``due`` False
    on the device it returns at once and the outputs are undefined."""
    if kernels.on_cpu(keys, pos, tid):
        return lane_sort_plain(keys, pos, tid)
    n = keys.shape[0]
    dev = keys.device
    kernels.check("keys", keys, torch.int64, (n,), dev)
    kernels.check("pos", pos, torch.int32, (n,), dev)
    kernels.check("tid", tid, torch.int32, (n,), dev)
    if due is not None:
        kernels.check("due", due, torch.bool, (), dev)
    bound = 2 * n_txn if pos_bound is None else pos_bound
    tid_bits = max(1, (n_txn - 1).bit_length())
    pos_bits = max(1, (bound - 1).bit_length())
    if pos_bits > 31:
        raise ValueError("K15a: positions must fit int32")
    wide = pos_bits + tid_bits > 32
    words = torch.empty(n, dtype=torch.int64, device=dev)
    tmp = torch.empty_like(words)
    pay = torch.empty(n if wide else 0, dtype=torch.int32, device=dev)
    pay_tmp = torch.empty_like(pay)
    counts = sort_scratch(n, dev)
    sk = torch.empty(n, dtype=torch.int64, device=dev)
    sp = torch.empty(n, dtype=torch.int32, device=dev)
    sid = torch.empty(n, dtype=torch.int32, device=dev)
    K15A_SORT.launch(kernels.ptr(keys), kernels.ptr(pos), kernels.ptr(tid),
                     n, pos_bits, tid_bits, int(wide),
                     None if due is None else kernels.ptr(due),
                     kernels.ptr(words), kernels.ptr(tmp), kernels.ptr(pay),
                     kernels.ptr(pay_tmp), kernels.ptr(counts),
                     kernels.ptr(sk), kernels.ptr(sp), kernels.ptr(sid),
                     kernels.stream(keys))
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


def next_writer(tail: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Nearest FOLLOWING writer within each key segment (the reversed twin
    of `prev_writer`; -1 when none follows)."""
    rt = torch.flip(tail, (0,))
    n = _shift1(_seg_scan(rt, torch.flip(cand, (0,)), _keep_last), -1)
    return torch.flip(torch.where(rt, -1, n), (0,))


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


# -- the audit plane's codecs and helpers (plain) -----------------------------

def pack_edge(kind, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """kind << 28 | src << 14 | dst over batch ranks (14-bit fields:
    ``epoch_batch <= 16384``, `Config.validate`)."""
    return (torch.as_tensor(kind, dtype=torch.int32, device=src.device)
            << 28) | (src << 14) | dst


def edge_kind(e: torch.Tensor) -> torch.Tensor:
    return (e >> 28) & 0xF


def edge_src(e: torch.Tensor) -> torch.Tensor:
    return (e >> 14) & 0x3FFF


def edge_dst(e: torch.Tensor) -> torch.Tensor:
    return e & 0x3FFF


def compact_lanes(flags: torch.Tensor, payloads, cap: int):
    """Stable prefix-sum compaction of the flagged lanes into ``cap``
    slots (``:115``): (one int32[cap] per payload, -1 pad; the flagged
    count; the overflow count)."""
    cnt = flags.sum().to(torch.int32)
    slot = torch.cumsum(flags.to(torch.int32), 0) - 1
    tgt = torch.where(flags, torch.clamp(slot, max=cap), cap).long()
    outs = []
    for p in payloads:
        out = torch.full((cap + 1,), -1, dtype=torch.int32,
                         device=flags.device)
        keep = tgt < cap      # the overflow lanes land on the dropped slot
        out[tgt[keep]] = p[keep].to(torch.int32)
        outs.append(out[:cap])
    dropped = torch.clamp(cnt - cap, min=0)
    return tuple(outs), cnt, dropped


def version_select(vts: torch.Tensor, read_ts: torch.Tensor) -> torch.Tensor:
    """Index of the NEWEST ring entry whose boundary stamp is <= the
    reader's timestamp (the first of equal maxima), -1 when none is
    (``:136``)."""
    ok = (vts >= 0) & (vts <= read_ts[..., None])
    best = torch.where(ok, vts, -1)
    j = torch.argmax(best, dim=-1)
    found = torch.gather(best, -1, j[..., None])[..., 0] >= 0
    return torch.where(found, j.to(torch.int32), -1)


def witness_count(edges: torch.Tensor, lvl: torch.Tensor) -> torch.Tensor:
    """Packed edges whose both endpoints committed at level / round 0
    (``:155``): int32 scalar."""
    valid = edges >= 0
    hi = lvl.shape[0] - 1
    src = torch.clamp(edge_src(edges), 0, hi).long()
    dst = torch.clamp(edge_dst(edges), 0, hi).long()
    z = (lvl[src] == 0) & (lvl[dst] == 0)
    return (valid & z).sum().to(torch.int32)


# -- K15c-scan: the audit's lane scans ------------------------------------------

def audit_scans_plain(sk: torch.Tensor, sp: torch.Tensor, sid: torch.Tensor,
                      n_buckets: int, due: torch.Tensor | None = None):
    """Plain K15c-scan, op for op from ``deneva_tpu/cc/base.py:469-492,
    507``: (flags bool[2n] = f_prev ++ f_next, packed edges int32[2n] (-1
    where not flagged), audit bucket int32[n], epoch-start observation
    mask bool[n]).  ``due`` is the kernel's gate; the plain version's
    outputs feed only stages that apply it."""
    sw = (sp & 1) == 1
    sbk = bucket_hash(sk, n_buckets, family=0)
    live = sk != LANE_PAD
    head, tail = segment_bounds(sk)
    cand = torch.where(sw & live, sid, -1)
    prev = prev_writer(head, cand)
    nxt = next_writer(tail, cand)
    f_prev = live & (prev >= 0) & (prev != sid)
    e_prev = torch.where(
        f_prev, pack_edge(torch.where(sw, AUDIT_WW, AUDIT_WR), prev, sid),
        -1)
    f_next = live & ~sw & (nxt >= 0) & (nxt != sid)
    e_next = torch.where(f_next, pack_edge(AUDIT_RW, sid, nxt), -1)
    obs = live & ~sw & (prev < 0)
    return (torch.cat([f_prev, f_next]),
            torch.cat([e_prev, e_next]).to(torch.int32), sbk, obs)


def audit_scans(sk: torch.Tensor, sp: torch.Tensor, sid: torch.Tensor,
                n_buckets: int, due: torch.Tensor | None = None):
    """K15c-scan: one launch of multi-block lane-index scans (K15b's
    design): the nearest preceding live writer (a max-scan of writer lane
    indices) and the nearest following one (the same scan over the
    reversed lanes), then per lane the flags, packed edges, audit bucket
    and observation mask."""
    if kernels.on_cpu(sk, sp, sid):
        return audit_scans_plain(sk, sp, sid, n_buckets, due)
    n = sk.shape[0]
    dev = sk.device
    kernels.check("sk", sk, torch.int64, (n,), dev)
    kernels.check("sp", sp, torch.int32, (n,), dev)
    kernels.check("sid", sid, torch.int32, (n,), dev)
    if due is not None:
        kernels.check("due", due, torch.bool, (), dev)
    if n_buckets & (n_buckets - 1):
        raise ValueError("K15c: audit_buckets must be a power of two")
    flags = torch.empty(2 * n, dtype=torch.bool, device=dev)
    edges = torch.empty(2 * n, dtype=torch.int32, device=dev)
    sbk = torch.empty(n, dtype=torch.int32, device=dev)
    obs = torch.empty(n, dtype=torch.bool, device=dev)
    scratch = torch.empty(2 * n + 8 * -(-n // SCAN_TILE), dtype=torch.int32,
                          device=dev)
    K15C_SCAN.launch(kernels.ptr(sk), kernels.ptr(sp), kernels.ptr(sid), n,
                     n_buckets - 1, None if due is None else kernels.ptr(due),
                     kernels.ptr(flags), kernels.ptr(edges), kernels.ptr(sbk),
                     kernels.ptr(obs), kernels.ptr(scratch),
                     kernels.stream(sk))
    return flags, edges, sbk, obs


# -- K15c-compact: the edge export with the witness count -----------------------

def compact_edges_plain(flags: torch.Tensor, edges2: torch.Tensor,
                        sbk: torch.Tensor, lvl: torch.Tensor, cap: int,
                        due: torch.Tensor | None = None):
    """Plain K15c-compact: `compact_lanes` of the flagged edges and their
    audit buckets, then `witness_count` of the kept edges; off the cadence
    (``due`` False) the reference's skip outputs.  Returns (edges, ebkt,
    cnt, dropped, wit)."""
    (edges, ebkt), cnt, dropped = compact_lanes(
        flags, (edges2, torch.cat([sbk, sbk])), cap)
    wit = witness_count(edges, lvl)
    if due is not None:
        edges = torch.where(due, edges, -1)
        ebkt = torch.where(due, ebkt, -1)
        cnt, dropped, wit = (torch.where(due, x, 0)
                             for x in (cnt, dropped, wit))
    return edges, ebkt, cnt, dropped, wit


def compact_edges(flags: torch.Tensor, edges2: torch.Tensor,
                  sbk: torch.Tensor, lvl: torch.Tensor, cap: int,
                  due: torch.Tensor | None = None):
    """K15c-compact: tile counts of the ``2n`` flagged lanes, one block's
    scan of them, then each tile places its lanes at their global rank
    (below ``cap``) and counts the kept edges with both ends at level 0."""
    if kernels.on_cpu(flags, edges2, sbk, lvl):
        return compact_edges_plain(flags, edges2, sbk, lvl, cap, due)
    m = flags.shape[0]
    dev = flags.device
    kernels.check("flags", flags, torch.bool, (m,), dev)
    kernels.check("edges2", edges2, torch.int32, (m,), dev)
    kernels.check("sbk", sbk, torch.int32, (m // 2,), dev)
    kernels.check("lvl", lvl, torch.int32, None, dev)
    if due is not None:
        kernels.check("due", due, torch.bool, (), dev)
    b = lvl.shape[0]
    edges = torch.empty(cap, dtype=torch.int32, device=dev)
    ebkt = torch.empty(cap, dtype=torch.int32, device=dev)
    out = torch.empty(3, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * -(-m // SCAN_TILE) + 1, dtype=torch.int32,
                          device=dev)
    K15C_COMPACT.launch(kernels.ptr(flags), kernels.ptr(edges2),
                        kernels.ptr(sbk), m, cap, kernels.ptr(lvl), b,
                        None if due is None else kernels.ptr(due),
                        kernels.ptr(edges), kernels.ptr(ebkt),
                        kernels.ptr(out), kernels.ptr(out[1:]),
                        kernels.ptr(out[2:]), kernels.ptr(scratch),
                        kernels.stream(flags))
    return edges, ebkt, out[0], out[1], out[2]
