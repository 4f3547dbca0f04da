"""CC backend interface: batched epoch validation (port of ``deneva_tpu/cc/base.py``).

An algorithm is a pure function over one epoch's planned accesses,
``validate(cfg, state, batch, incidence) -> (Verdict, state)``.  The
port carries the records, the incidence construction of the sweep
backends, the ``get_overlap`` seam, transaction repair's frontier, the
metrics plane's conflict density and the isolation audit plane's
single-node half (``audit_init``, ``audit_observe``,
``audit_mutate_verdict``).

Three kernels live here, each beside its plain version:

* **K13a** `committed_write_frontier` (``csrc/frontier.cu``) — replaces
  ``cc/base.py:193``: the bf16 matvec ``committed[1, B] x w[B, K] > 0``
  of each hash family, gathered at every lane's bucket and masked to the
  losers' ordered reads.  The kernel ORs each column of ``w`` down the
  committed rows instead of multiplying: the views hold access counts
  (>= 0), so a column's f32 sum is positive exactly when one committed
  row holds a non-zero count, and the result is the matvec's bit for
  bit.  `audit_mutate_verdict` (``:548``) reuses its launch with the
  write lanes of every txn as the lane selector.
* **K13b** `conflict_density` (``csrc/audit.cu``) — replaces ``:228``:
  per-bucket write and touch counts of the epoch's lanes, then per lane
  the txn's own same-bucket lanes subtracted, the contention rule, and
  the fold by owner into int32[P].  The reference's two arms (column
  sums of the incidence, or two bucket scatter-adds) give the same
  integers, so one kernel from the lanes serves both.
* **K17** `audit_observe` (``csrc/audit.cu``) — replaces ``:414``
  `_audit_observe_impl` in two launches around K15a's sort and K15c's
  scans and compaction (`cc.depgraph`): ``dt_audit_lanes`` ranks the
  committed txns by ``order`` (`audit_rank`, a counting rank) and builds
  the doubled lanes; ``dt_audit_observe`` digests the epoch-start reads
  (``rdig``, with MVCC's ``version_select``), advances the stamp tables
  by two scatter-max passes, digests them (``vdig``) and, under MVCC,
  pushes the version-boundary rings.  The kernel route updates the
  stamp tables in place; the plain route returns new ones.  uint32 sums
  wrap as ``uint32_t`` (the plain route: int64 masked to 32 bits).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.cc import depgraph
from deneva_tpu_torch.cc.depgraph import (AUDIT_RW, AUDIT_WR,  # noqa: F401
                                          AUDIT_WW, LANE_PAD)
from deneva_tpu_torch.ops import conflict
from deneva_tpu_torch.ops.hashing import (MASK32, bucket_hash, combine_key,
                                          mul32, u32)

P, I32 = kernels.P, kernels.I32
K13A_FRONTIER = kernels.Kernel("dt_repair_frontier", [
    P, P, P, P, P, P, P, P, P, P, I32, I32, I32, P, P, P])
K13B_DENSITY = kernels.Kernel("dt_conflict_density", [
    P, P, P, P, P, P, P, I32, I32, I32, I32, I32, P, kernels.I64, P, P])
K17_LANES = kernels.Kernel("dt_audit_lanes", [
    P, P, P, P, P, P, P, P, P, I32, I32, I32, P, P, P, P, P, P])
# the rank alone (K17_LANES runs it first): for timing and the tests
K17_RANK = kernels.Kernel("dt_audit_rank", [P, P, I32, P, P, P])
K17_OBSERVE = kernels.Kernel("dt_audit_observe", [
    P, P, P, P, P, I32, P, P, P, P, P, P, P, P, I32, I32, P, P, P, P])

AUDIT_KEY = "__audit__"     # db entry of the audit stamp tables
INT32_MAX = 2**31 - 1
# the digests' odd multipliers (uint32)
DIG_M1, DIG_M2, DIG_M3, DIG_M4 = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35,
                                  0x27D4EB2F)


def get_overlap(cfg):
    """Per-config overlap op: the one seam every sweep backend calls
    (``deneva_tpu/cc/base.py:54``).  K7 behind it."""
    return conflict.overlap


@dataclass
class AccessBatch:
    """One epoch's planned accesses, [B, A] / [B] tensors."""

    table_ids: torch.Tensor   # int32[B, A]
    keys: torch.Tensor        # int32[B, A]
    is_read: torch.Tensor     # bool[B, A]
    is_write: torch.Tensor    # bool[B, A]
    valid: torch.Tensor       # bool[B, A]
    ts: torch.Tensor          # int32[B]
    rank: torch.Tensor        # int32[B]
    active: torch.Tensor      # bool[B]
    ro_hint: torch.Tensor | None = None
    order_free: torch.Tensor | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.keys.shape)


@dataclass
class Verdict:
    commit: torch.Tensor      # bool[B]
    abort: torch.Tensor       # bool[B]
    defer: torch.Tensor       # bool[B]
    order: torch.Tensor       # int32[B] serialization order
    level: torch.Tensor       # int32[B] execution sub-round


@dataclass
class Incidence:
    """Bucket-space incidence of one epoch, both hash families: bf16[B, K]
    reads / writes / union / pure reads, and the ordered copies (accesses
    not marked order_free), which alias the plain views when no exemption
    applies.  A view no backend reads is None; family-2 views are None
    unless ``conflict_exact``."""

    r1: torch.Tensor | None
    w1: torch.Tensor | None
    u1: torch.Tensor | None
    pr1: torch.Tensor | None
    r2: torch.Tensor | None
    w2: torch.Tensor | None
    u2: torch.Tensor | None
    pr2: torch.Tensor | None
    bucket1: torch.Tensor     # int32[B, A] family-0 bucket per lane
    uo1: torch.Tensor | None = None
    uo2: torch.Tensor | None = None
    ro1: torch.Tensor | None = None
    ro2: torch.Tensor | None = None
    wo1: torch.Tensor | None = None
    wo2: torch.Tensor | None = None
    pro1: torch.Tensor | None = None
    pro2: torch.Tensor | None = None


def gate_order_free(cfg, be, order_free: torch.Tensor | None
                    ) -> torch.Tensor | None:
    """The one escrow gate: the workload's ``order_free`` mask iff this
    backend may consume it, else None (``deneva_tpu/cc/base.py:163``)."""
    if order_free is None or not be.exempt_order_free \
            or not cfg.escrow_order_free:
        return None
    if not be.chained and not cfg.escrow_sweep:
        return None
    return order_free


def build_conflict_incidence(cfg, be, batch: AccessBatch,
                             order_free: torch.Tensor | None):
    """`build_incidence` honoring the backend's order_free exemption,
    building only the views the backend reads (``be.views(cfg)``); None
    when it reads none."""
    views = be.views(cfg)
    if (cfg.repair or cfg.audit_mutate) and "w" not in views:
        # the repair frontier and the audit mutation read the plain write
        # view of both families; 2PL under NOLOCK validates without any
        # view, and an incidence of None would leave them nothing to read
        # (ROADMAP.md watch item 25)
        views = views + ("w",)
    if not views:
        return None
    order_free = gate_order_free(cfg, be, order_free)
    return build_incidence(batch, cfg.conflict_buckets, cfg.conflict_exact,
                           order_free=order_free, views=views)


def build_incidence(batch: AccessBatch, n_buckets: int, exact: bool,
                    order_free: torch.Tensor | None = None,
                    views: tuple[str, ...] = conflict.VIEWS) -> Incidence:
    """The requested views of both families, through K5+K6.  Without
    ``order_free`` an ordered view aliases its plain one, as in the
    reference (``deneva_tpu/cc/base.py:587``)."""
    src = {}
    for v in views:
        base = conflict.ORDERED.get(v, v) if order_free is None else v
        src[v] = base
        src.setdefault(base, base)
    built = tuple(dict.fromkeys(src.values()))
    fams, b1 = conflict.hashed_incidence(
        batch.table_ids, batch.keys, batch.is_read, batch.is_write,
        batch.valid, batch.active, order_free, n_buckets,
        2 if exact else 1, built)
    kw = {}
    for f in (1, 2):
        fam = fams[f - 1] if f <= len(fams) else {}
        for v in conflict.VIEWS:
            kw[f"{v}{f}"] = fam.get(src[v]) if v in src else None
    return Incidence(bucket1=b1, **kw)


def committed_write_frontier_plain(cfg, batch: AccessBatch, inc: Incidence,
                                   committed: torch.Tensor,
                                   losers: torch.Tensor,
                                   lanes: str = "read") -> torch.Tensor:
    """Plain K13a, op for op from ``deneva_tpu/cc/base.py:193``: bool[B, A]
    marking each loser's ordered read lanes whose bucket a committed txn
    wrote (in both families under ``conflict_exact``).  The f32 products
    of the integer counts are exact.  ``lanes="write"`` selects the write
    lanes instead (`audit_mutate_verdict`'s use, ``:560-572``)."""
    wrote = torch.matmul(committed.float()[None, :], inc.w1.float())[0] > 0
    hit = wrote[inc.bucket1.long()]
    if inc.w2 is not None:
        ident = combine_key(batch.table_ids, batch.keys)
        b2 = bucket_hash(ident, inc.w2.shape[1], family=1)
        wrote2 = torch.matmul(committed.float()[None, :],
                              inc.w2.float())[0] > 0
        hit = hit & wrote2[b2.long()]
    sel = batch.is_write if lanes == "write" else batch.is_read
    rmask = batch.valid & losers[:, None] & sel
    if batch.order_free is not None:
        rmask = rmask & ~batch.order_free
    return rmask & hit


def committed_write_frontier(cfg, batch: AccessBatch, inc: Incidence,
                             committed: torch.Tensor,
                             losers: torch.Tensor,
                             lanes: str = "read") -> torch.Tensor:
    """K13a: the invalidated-read frontier of transaction repair.  One
    launch: the committed rows' column OR of ``w1`` (and ``w2``) into
    per-bucket flags, then one thread per lane gathers its flags (family
    2 hashed in the kernel) and applies the loser / lane / order_free
    mask; ``lanes`` picks the read (default) or the write lanes."""
    if inc is None or inc.w1 is None:
        raise ValueError("the repair frontier needs the incidence's write "
                         "view (build_conflict_incidence adds it under "
                         "cfg.repair)")
    if lanes not in ("read", "write"):
        raise ValueError(f"K13a: lanes must be 'read' or 'write', got "
                         f"{lanes!r}")
    if kernels.on_cpu(batch.keys, committed, inc.w1):
        return committed_write_frontier_plain(cfg, batch, inc, committed,
                                              losers, lanes)
    sel = batch.is_write if lanes == "write" else batch.is_read
    b, a = batch.keys.shape
    k = inc.w1.shape[1]
    dev = batch.keys.device
    for name, t, dt in (("table_ids", batch.table_ids, torch.int32),
                        ("keys", batch.keys, torch.int32),
                        ("valid", batch.valid, torch.bool),
                        ("lanes", sel, torch.bool),
                        ("bucket1", inc.bucket1, torch.int32)):
        kernels.check(name, t, dt, (b, a), dev)
    kernels.check("committed", committed, torch.bool, (b,), dev)
    kernels.check("losers", losers, torch.bool, (b,), dev)
    kernels.check("w1", inc.w1, torch.bfloat16, (b, k), dev)
    two = inc.w2 is not None
    if two:
        kernels.check("w2", inc.w2, torch.bfloat16, (b, k), dev)
    if batch.order_free is not None:
        kernels.check("order_free", batch.order_free, torch.bool, (b, a),
                      dev)
    if k % 8 or k & (k - 1):
        raise ValueError("K13a reads 16-byte rows: K must be a power of "
                         "two and a multiple of 8")
    wrote = torch.zeros((2 if two else 1) * k, dtype=torch.uint8,
                        device=dev)
    out = torch.empty((b, a), dtype=torch.bool, device=dev)
    K13A_FRONTIER.launch(
        kernels.ptr(committed), kernels.ptr(inc.w1),
        kernels.ptr(inc.w2) if two else None, kernels.ptr(inc.bucket1),
        kernels.ptr(batch.table_ids), kernels.ptr(batch.keys),
        kernels.ptr(batch.valid), kernels.ptr(sel), kernels.ptr(losers),
        None if batch.order_free is None else kernels.ptr(batch.order_free),
        b, a, k, kernels.ptr(wrote), kernels.ptr(out),
        kernels.stream(batch.keys))
    return out


# -- K13b: the metrics plane's conflict density -------------------------------

def conflict_density_plain(cfg, batch: AccessBatch, owner: torch.Tensor,
                           from_incidence: bool = False) -> torch.Tensor:
    """Plain K13b, op for op from ``deneva_tpu/cc/base.py:228``: int32[P]
    counting the lanes that contend — another txn writes their bucket, or
    they write and another txn touches it — folded by ``owner``.  The
    reference's incidence arm sums the columns of the ``w1`` / ``u1``
    views, which count a lane's touch only when it reads or writes;
    ``from_incidence`` takes that arm's touch rule, here as the same
    bucket scatter-adds the views are made of."""
    p = max(cfg.part_cnt, 1)
    v = batch.valid & batch.active[:, None]
    w = v & batch.is_write
    k = cfg.conflict_buckets
    bucket = bucket_hash(combine_key(batch.table_ids, batch.keys), k,
                         family=0)
    u = v & (batch.is_read | batch.is_write) if from_incidence else v
    cols = torch.where(v, bucket, 0).reshape(-1).long()
    wcol = torch.zeros(k, dtype=torch.int64, device=cols.device)
    ucol = torch.zeros_like(wcol)
    wcol.index_add_(0, cols, w.reshape(-1).to(torch.int64))
    ucol.index_add_(0, cols, u.reshape(-1).to(torch.int64))
    same = bucket[:, :, None] == bucket[:, None, :]
    own_w = (same & w[:, None, :]).sum(dim=-1)
    own_u = (same & v[:, None, :]).sum(dim=-1)
    w_oth = wcol[bucket.long()] - own_w
    u_oth = ucol[bucket.long()] - own_u
    conf = v & ((w_oth > 0) | (w & (u_oth > 0)))
    parts = torch.arange(p, dtype=torch.int32, device=owner.device)
    onehot = (owner[:, :, None] == parts) & conf[:, :, None]
    return onehot.sum(dim=(0, 1)).to(torch.int32)


def conflict_density_layout(b: int, a: int, k: int) -> tuple[int, bool, int]:
    """K13b's launch at ``b`` x ``a`` lanes and ``k`` buckets as the kernel
    library chooses it (CUDA only): (uint64 words of scratch, the dense
    regime rather than the direct one, blocks of its grid)."""
    words, dense, grid = kernels.layout("dt_conflict_density_layout", b, a,
                                        k)
    return words, bool(dense), grid


def conflict_density(cfg, batch: AccessBatch, owner: torch.Tensor,
                     from_incidence: bool = False) -> torch.Tensor:
    """K13b: one cooperative launch of three phases over warps that hold
    whole txn rows (``conflict_density_layout`` picks the regime).  Count:
    int32[P] and the histogram's words are zeroed (by the grid in the
    dense regime, by each bucket's warp-groups in the direct one); a
    lane's own row's same-bucket writes and lanes come from a shuffle walk
    of the row and stay in registers; dense, each lane also adds into its
    block's shared table.  Add, after a grid barrier: each block's table
    entry (dense) or each warp-group (direct) adds (writes << 32 |
    touches) to its bucket's uint64 word with one atomic.  Verdict, after
    another: each lane applies the contention rule less its own row's
    counts and folds by owner into int32[P].  No memset, no N-sized
    scratch."""
    if kernels.on_cpu(batch.keys, owner):
        return conflict_density_plain(cfg, batch, owner, from_incidence)
    b, a = batch.keys.shape
    dev = batch.keys.device
    for name, t, dt in (("table_ids", batch.table_ids, torch.int32),
                        ("keys", batch.keys, torch.int32),
                        ("valid", batch.valid, torch.bool),
                        ("is_read", batch.is_read, torch.bool),
                        ("is_write", batch.is_write, torch.bool),
                        ("owner", owner, torch.int32)):
        kernels.check(name, t, dt, (b, a), dev)
    kernels.check("active", batch.active, torch.bool, (b,), dev)
    k = cfg.conflict_buckets
    p = max(cfg.part_cnt, 1)
    if k & (k - 1) or k > 2**30 or p > 1024:
        raise ValueError("K13b: conflict_buckets must be a power of two "
                         "up to 2^30 and part_cnt at most 1024")
    if b * a >= 2**31:
        # a bucket's touches stay below 2^31 in the low word of its count
        raise ValueError(f"K13b: {b} x {a} lanes, at most 2^31 - 1")
    words = conflict_density_layout(b, a, k)[0]
    hist = torch.empty(words, dtype=torch.int64, device=dev)
    out = torch.empty(p, dtype=torch.int32, device=dev)
    K13B_DENSITY.launch(
        kernels.ptr(batch.table_ids), kernels.ptr(batch.keys),
        kernels.ptr(batch.valid), kernels.ptr(batch.is_read),
        kernels.ptr(batch.is_write), kernels.ptr(batch.active),
        kernels.ptr(owner), b, a, k, p, int(from_incidence),
        kernels.ptr(hist), words, kernels.ptr(out),
        kernels.stream(batch.keys))
    return out


# -- the isolation audit plane -------------------------------------------------

def audit_init(cfg, device=None) -> dict:
    """Fresh audit state (``deneva_tpu/cc/base.py:300``): per-bucket
    last-writer stamps (epoch, writer rank; -1 = never written) and, under
    MVCC, the version-boundary rings of depth ``mvcc_his_len`` with their
    cursor."""
    from deneva_tpu_torch.config import CCAlg

    def full(*shape, v=-1):
        return torch.full(shape, v, dtype=torch.int32, device=device)
    k = cfg.audit_buckets
    aud = {"epoch": full(k), "writer": full(k)}
    if cfg.cc_alg == CCAlg.MVCC:
        h = max(1, cfg.mvcc_his_len)
        aud.update(vts=full(k, h), vepoch=full(k, h), vwriter=full(k, h),
                   vpos=full(k, v=0))
    return aud


def audit_levels(cfg, be, forwarding: bool) -> int:
    """How many bands the committed txns' ``lvl`` can take on this path:
    the static bound of the audit's lane positions (K15a's packing)."""
    from deneva_tpu_torch.config import CCAlg
    if forwarding:
        return 1
    if be.chained:
        return cfg.dgcc_levels if be.alg == CCAlg.DGCC \
            else cfg.exec_subrounds
    return cfg.repair_rounds + 1 if cfg.repair else 1


def audit_rank_plain(committed: torch.Tensor, order: torch.Tensor
                     ) -> torch.Tensor:
    """Plain K17 rank, op for op from ``cc/base.py:434-437``: the dense
    serialization rank ``opos`` of ``order`` over the committed txns, the
    others (key ``INT32_MAX``) after them, ties by index."""
    b = order.shape[0]
    dev = order.device
    okey = torch.where(committed, order, INT32_MAX)
    perm = torch.argsort(okey, stable=True)
    opos = torch.zeros(b, dtype=torch.int32, device=dev)
    opos[perm] = torch.arange(b, dtype=torch.int32, device=dev)
    return opos


def audit_rank(committed: torch.Tensor, order: torch.Tensor,
               due: torch.Tensor | None = None) -> torch.Tensor:
    """K17's rank alone (``dt_audit_rank``, the first kernel of
    `audit_lanes`): int32[B] opos.  With ``due`` False it returns at once
    and opos is undefined."""
    if kernels.on_cpu(committed, order):
        return audit_rank_plain(committed, order)
    b = order.shape[0]
    dev = order.device
    kernels.check("committed", committed, torch.bool, (b,), dev)
    kernels.check("order", order, torch.int32, (b,), dev)
    if due is not None:
        kernels.check("due", due, torch.bool, (), dev)
    opos = torch.empty(b, dtype=torch.int32, device=dev)
    K17_RANK.launch(kernels.ptr(committed), kernels.ptr(order), b,
                    None if due is None else kernels.ptr(due),
                    kernels.ptr(opos), kernels.stream(order))
    return opos


def audit_lanes_plain(batch: AccessBatch, committed: torch.Tensor,
                      order: torch.Tensor, lvl: torch.Tensor,
                      order_vis: bool, due: torch.Tensor | None = None):
    """Plain K17 lane build, op for op from ``cc/base.py:421-461``: the
    dense serialization rank ``opos`` of ``order`` over the committed
    txns (`audit_rank_plain`), banded by ``lvl``, and the doubled lanes
    (keys int64, positions int32, txn ids int32), read lanes first.
    ``due`` is the kernel's gate; these lanes feed only stages that
    apply it."""
    b, a = batch.shape
    dev = batch.keys.device
    cm = batch.valid & committed[:, None]
    if batch.order_free is not None:
        cm = cm & ~batch.order_free
    rm = cm & batch.is_read
    wm = cm & batch.is_write
    ident = combine_key(batch.table_ids, batch.keys)
    opos = audit_rank_plain(committed, order)
    band = lvl * (b + 2)
    wpos = (band + 1 + opos) * 2 + 1
    rpos = (band + 1 + opos) * 2 if order_vis else band * 2
    tid = torch.arange(b, dtype=torch.int32, device=dev)[:, None].expand(b, a)
    keys2 = torch.cat([torch.where(rm, ident, LANE_PAD).reshape(-1),
                       torch.where(wm, ident, LANE_PAD).reshape(-1)])
    pos2 = torch.cat([rpos[:, None].expand(b, a).reshape(-1),
                      wpos[:, None].expand(b, a).reshape(-1)])
    tid2 = torch.cat([tid.reshape(-1), tid.reshape(-1)])
    return keys2, pos2.to(torch.int32), tid2


def audit_lanes(batch: AccessBatch, committed: torch.Tensor,
                order: torch.Tensor, lvl: torch.Tensor, order_vis: bool,
                due: torch.Tensor | None = None):
    """K17, first launch (``dt_audit_lanes``): the counting rank of the
    committed txns' ``order`` (as `audit_rank`), then one thread per
    access writes its read and write lane.  Dead lanes take position 0,
    which no output reads; with ``due`` False it returns at once."""
    if kernels.on_cpu(batch.keys, committed, order, lvl):
        return audit_lanes_plain(batch, committed, order, lvl, order_vis,
                                 due)
    b, a = batch.keys.shape
    dev = batch.keys.device
    for name, t, dt in (("table_ids", batch.table_ids, torch.int32),
                        ("keys", batch.keys, torch.int32),
                        ("valid", batch.valid, torch.bool),
                        ("is_read", batch.is_read, torch.bool),
                        ("is_write", batch.is_write, torch.bool)):
        kernels.check(name, t, dt, (b, a), dev)
    kernels.check("committed", committed, torch.bool, (b,), dev)
    kernels.check("order", order, torch.int32, (b,), dev)
    kernels.check("lvl", lvl, torch.int32, (b,), dev)
    of = batch.order_free
    if of is not None:
        kernels.check("order_free", of, torch.bool, (b, a), dev)
    if due is not None:
        kernels.check("due", due, torch.bool, (), dev)
    n = b * a
    keys2 = torch.empty(2 * n, dtype=torch.int64, device=dev)
    pos2 = torch.empty(2 * n, dtype=torch.int32, device=dev)
    tid2 = torch.empty(2 * n, dtype=torch.int32, device=dev)
    opos = torch.empty(b, dtype=torch.int32, device=dev)
    K17_LANES.launch(
        kernels.ptr(committed), kernels.ptr(order), kernels.ptr(lvl),
        kernels.ptr(batch.table_ids), kernels.ptr(batch.keys),
        kernels.ptr(batch.valid), kernels.ptr(batch.is_read),
        kernels.ptr(batch.is_write), None if of is None else kernels.ptr(of),
        b, a, int(order_vis), None if due is None else kernels.ptr(due),
        kernels.ptr(opos), kernels.ptr(keys2), kernels.ptr(pos2),
        kernels.ptr(tid2), kernels.stream(batch.keys))
    return keys2, pos2, tid2


def _digest_mix(*pairs) -> torch.Tensor:
    """XOR of uint32 products, as int64 in [0, 2^32)."""
    out = None
    for x, m in pairs:
        t = mul32(u32(x), m)
        out = t if out is None else out ^ t
    return out


def audit_stamps_plain(stamps: dict, sk: torch.Tensor, sp: torch.Tensor,
                       sid: torch.Tensor, sbk: torch.Tensor,
                       obs: torch.Tensor, ts: torch.Tensor,
                       epoch: torch.Tensor, due: torch.Tensor | None = None):
    """Plain K17 stamp pass, op for op from ``cc/base.py:494-546``: the
    epoch-start reads' digest ``rdig`` against the PRE-update stamps (under
    MVCC the ring entry `version_select` picks by the reader's ts), the
    last committed writer of each audit bucket by two scatter-max passes,
    the new stamps and their digest ``vdig``, and the MVCC ring push.
    Returns (new stamps, vdig, rdig), digests int64 in [0, 2^32); off the
    cadence the stamps unchanged and zeros."""
    k = stamps["epoch"].shape[0]
    dev = sk.device
    live = sk != LANE_PAD
    sw = (sp & 1) == 1
    sbl = sbk.long()
    if "vts" in stamps:
        sts = ts[sid.long()]

        def ring(f):
            return stamps[f][sbl]
        sel = depgraph.version_select(ring("vts"), sts)

        def pick(f):
            j = torch.clamp(sel, min=0).long()[:, None]
            return torch.gather(ring(f), -1, j)[:, 0]
        oe = torch.where(sel >= 0, pick("vepoch"), -1)
        ow = torch.where(sel >= 0, pick("vwriter"), -1)
    else:
        oe = stamps["epoch"][sbl]
        ow = stamps["writer"][sbl]
    mix = _digest_mix((sid, DIG_M1), (sbk, DIG_M2), (oe, DIG_M3),
                      (ow, DIG_M4))
    rdig = torch.where(obs, mix, 0).sum() & MASK32
    wl_mask = live & sw
    sbk_safe = torch.where(wl_mask, sbk, 0).long()
    top = torch.zeros(k, dtype=torch.int32, device=dev).scatter_reduce_(
        0, sbk_safe, torch.where(wl_mask, sp + 1, 0), "amax")
    upd = top > 0
    match = wl_mask & (sp + 1 == top[sbl])
    wid = torch.zeros(k, dtype=torch.int32, device=dev).scatter_reduce_(
        0, torch.where(match, sbk, 0).long(), torch.where(match, sid + 1, 0),
        "amax")
    ep = epoch.to(torch.int32)
    new_e = torch.where(upd, ep, stamps["epoch"])
    new_w = torch.where(upd, wid - 1, stamps["writer"])
    vdig = _digest_mix((new_e, DIG_M1), (new_w, DIG_M2)).sum() & MASK32
    out = {"epoch": new_e, "writer": new_w}
    if "vts" in stamps:
        hlen = stamps["vts"].shape[1]
        slot = (stamps["vpos"] % hlen).long()
        rows = torch.arange(k, device=dev)
        wts = ts[torch.clamp(wid - 1, min=0).long()]

        def push(ring_arr, val):
            cur = ring_arr[rows, slot]
            new = ring_arr.clone()
            new[rows, slot] = torch.where(upd, val, cur)
            return new
        out.update(vts=push(stamps["vts"], wts),
                   vepoch=push(stamps["vepoch"], ep.expand(k)),
                   vwriter=push(stamps["vwriter"], wid - 1),
                   vpos=stamps["vpos"] + upd.to(torch.int32))
    if due is not None:
        out = {f: torch.where(due, v, stamps[f]) for f, v in out.items()}
        vdig, rdig = torch.where(due, vdig, 0), torch.where(due, rdig, 0)
    return out, vdig, rdig


def audit_stamps(stamps: dict, sk: torch.Tensor, sp: torch.Tensor,
                 sid: torch.Tensor, sbk: torch.Tensor, obs: torch.Tensor,
                 ts: torch.Tensor, epoch: torch.Tensor,
                 due: torch.Tensor | None = None):
    """K17, second launch (``dt_audit_observe``): one pass over the sorted
    lanes digests the observations and scatter-maxes the writers'
    positions, a second scatter-maxes the winners' ids, a third over the
    buckets writes the stamps and rings IN PLACE and digests them.  With
    ``due`` False the stamps stay and both digests are 0."""
    if kernels.on_cpu(sk, sp, sid, stamps["epoch"]):
        return audit_stamps_plain(stamps, sk, sp, sid, sbk, obs, ts, epoch,
                                  due)
    n = sk.shape[0]
    dev = sk.device
    kernels.check("sk", sk, torch.int64, (n,), dev)
    for name, t in (("sp", sp), ("sid", sid), ("sbk", sbk)):
        kernels.check(name, t, torch.int32, (n,), dev)
    kernels.check("obs", obs, torch.bool, (n,), dev)
    kernels.check("ts", ts, torch.int32, None, dev)
    kernels.check("epoch", epoch, torch.int32, (), dev)
    k = stamps["epoch"].shape[0]
    for f in ("epoch", "writer"):
        kernels.check(f, stamps[f], torch.int32, (k,), dev)
    mv = "vts" in stamps
    h = stamps["vts"].shape[1] if mv else 0
    if mv:
        for f in ("vts", "vepoch", "vwriter"):
            kernels.check(f, stamps[f], torch.int32, (k, h), dev)
        kernels.check("vpos", stamps["vpos"], torch.int32, (k,), dev)
    if due is not None:
        kernels.check("due", due, torch.bool, (), dev)
    scratch = torch.empty(2 * k + 2, dtype=torch.int32, device=dev)

    def ring(f):
        return kernels.ptr(stamps[f]) if mv else None
    K17_OBSERVE.launch(
        kernels.ptr(sk), kernels.ptr(sp), kernels.ptr(sid), kernels.ptr(sbk),
        kernels.ptr(obs), n, kernels.ptr(ts), kernels.ptr(epoch),
        kernels.ptr(stamps["epoch"]), kernels.ptr(stamps["writer"]),
        ring("vts"), ring("vepoch"), ring("vwriter"), ring("vpos"), h, k,
        None if due is None else kernels.ptr(due), kernels.ptr(scratch),
        kernels.ptr(scratch[2 * k:]), kernels.stream(sk))
    dig = scratch[2 * k:].to(torch.int64) & MASK32
    return stamps, dig[0], dig[1]


def audit_observe(cfg, batch: AccessBatch, committed: torch.Tensor,
                  order: torch.Tensor, lvl: torch.Tensor, order_vis: bool,
                  stamps: dict, epoch: torch.Tensor, n_levels: int = 1,
                  cadence: int | None = None):
    """Per-epoch committed-txn dependency observations under the backend's
    visibility rule (``deneva_tpu/cc/base.py:336``): forwarding
    (``order_vis``) reads observe the latest committed writer of lower
    serialization order; otherwise the latest of strictly lower ``lvl``.
    Epochs off ``audit_cadence`` take the reference's skip outputs, gated
    on the device (``due``), so no epoch syncs the host.  ``n_levels``
    bounds ``lvl`` of the committed txns (`audit_levels`).  ``cadence``
    (the control plane's knob, a host int) replaces ``cfg.audit_cadence``;
    the epoch's ``due`` flag stays a device test of the epoch counter.

    Returns ``(stamps', edges, ebkt, cnt, dropped, vdig, rdig, wit)``: the
    reference's seven outputs (digests int64 in [0, 2^32)) and the
    witness count of the kept edges (`depgraph.witness_count`)."""
    cad = max(1, cfg.audit_cadence if cadence is None else int(cadence))
    due = None if cad == 1 else (epoch % cad) == 0
    b, _a = batch.shape
    keys2, pos2, tid2 = audit_lanes(batch, committed, order, lvl, order_vis,
                                    due)
    sk, sp, sid = depgraph.lane_sort(keys2, pos2, tid2, b,
                                     pos_bound=2 * n_levels * (b + 2),
                                     due=due)
    flags, edges2, sbk, obs = depgraph.audit_scans(sk, sp, sid,
                                                   cfg.audit_buckets, due)
    edges, ebkt, cnt, dropped, wit = depgraph.compact_edges(
        flags, edges2, sbk, lvl, cfg.audit_edges_max, due)
    stamps, vdig, rdig = audit_stamps(stamps, sk, sp, sid, sbk, obs,
                                      batch.ts, epoch, due)
    return stamps, edges, ebkt, cnt, dropped, vdig, rdig, wit


def audit_mutate_verdict(cfg, batch: AccessBatch, inc: Incidence,
                         verdict: Verdict, epoch: torch.Tensor) -> Verdict:
    """The seeded edge-derivation fault (``deneva_tpu/cc/base.py:548``):
    on epochs of the ``audit_mutate`` window, an OCC loser whose write
    lanes miss every winner-written bucket commits.  The write-lane hits
    are K13a's launch with the write lanes selected; the window test and
    the flip are glue on the device."""
    import dataclasses
    _, start, count = cfg.audit_mutate_spec()
    committed = verdict.commit & batch.active
    every = torch.ones_like(committed)
    hit = committed_write_frontier(cfg, batch, inc, committed, every,
                                   lanes="write")
    dirty_writes = hit.any(dim=1)
    in_window = (epoch >= start) & (epoch < start + count)
    flip = verdict.abort & batch.active & ~dirty_writes & in_window
    return dataclasses.replace(verdict, commit=verdict.commit | flip,
                               abort=verdict.abort & ~flip)
