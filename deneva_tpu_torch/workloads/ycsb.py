"""YCSB (reference `benchmarks/ycsb_wl.cpp`, `ycsb_query.cpp`, `ycsb_txn.cpp`).

The port of ``deneva_tpu/workloads/ycsb.py``: one table of
``synth_table_size`` rows (under ``part_cnt > 1``, node ``node_id``'s
``synth_table_size / part_cnt`` rows: key ``node_id + s * part_cnt`` at
slot s, every other key at the trash slot) with ``field_per_tuple`` string
fields; a query is ``req_per_query`` zipfian or HOT keys, each read
(field F0) or blindly overwritten with a pure function of (key, writer
rank).

Three kernels carry it on the card:

* **K3** `_forward_execute_f0` (``csrc/ycsb.cu``) — replaces
  ``deneva_tpu/workloads/ycsb.py:78``: read lanes gather F0 (forwarded
  reads take ``f(key, fwd)``), a wrapping uint32 checksum folds over
  them, and each key's final writer stores ``f(key, rank)``.  One
  cooperative launch: every gather, a grid barrier, then the winners'
  stores, so no read sees a value written in its own epoch.
* **K4b** `YCSBWorkload.generate` (``csrc/ycsb.cu``) — replaces
  ``deneva_tpu/workloads/ycsb.py:277`` with ``ops/sampling.py:54,70``:
  the threefry draws, the zipfian quantile or the HOT draw (a Bernoulli
  and two ``randint``), the Bernoulli write flags and, under
  ``txn_write_perc < 1``, the per-txn write gate in one elementwise
  pass; under ``key_order`` a second launch sorts each txn's keys.
* **K12c** `_versioned_read_f0` (``csrc/version.cu``) — replaces
  ``deneva_tpu/storage/table.py:230,241`` `VersionRing.rows` and
  `version_from` as the MVCC read arm (``deneva_tpu/workloads/ycsb.py:
  552-579``) uses them: each committed read gathers F0 and its row's
  version ring, and a read that a retained overwrite postdates takes
  ``f(key, v*)``, the version current at its ts; then the checksum.

Under ``index_struct=IDX_BTREE`` the key -> slot probe is the ordered
index's (`storage.index.SortedIndex`, kernel K14b) instead of the affine
map; both give the same slots.

The sweep backends take the masked arm of `execute` instead: a plain
gather and checksum of the committed reads (K12c under MVCC), then the
committed writes through K10 (`ops.scatter.last_writer`), under MVCC
the winners' ring push (K12d, `storage.table.VersionRing.push`), and a
masked scatter.

Under ``device_parts > 1`` the table is owner-major over the mesh
(block d holds the keys = d mod D) and MVCC keeps no version ring, as
in the reference.  The forwarding path runs `execute_mc`: K18a and K18b
(`ops.forward`) cut each source shard's slice into owner blocks, and
each shard plans (K1, K2) and executes (K3) its own keys on its block;
the other backends run `execute` per shard through
`workloads.mc.McTableView`.

Fingerprint columns are uint32 words held as int32 bit patterns; the
value law is computed in int64 masked to 32 bits (`_mul32` keeps every
product below 2^49, so no signed overflow occurs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.config import CCAlg, Config
from deneva_tpu_torch.ops import prng, scatter
from deneva_tpu_torch.ops.forward import seg_first
from deneva_tpu_torch.ops.hashing import mul32 as _mul32
from deneva_tpu_torch.ops.hashing import u32 as _u32
from deneva_tpu_torch.ops.sampling import HotSet, Zipfian
from deneva_tpu_torch.storage.catalog import parse_schema
from deneva_tpu_torch.storage.index import DenseIndex, SortedIndex
from deneva_tpu_torch.storage.table import (DeviceTable, VersionRing,
                                            to_mc_layout)

TABLE = "MAIN_TABLE"
VER_TABLE = "MAIN_TABLE.F0.ver"   # MVCC per-row overwrite-ts ring
INT32_MAX = 2**31 - 1
MASK32 = 0xFFFFFFFF
FP_MUL_KEY = 2654435761
FP_MUL_VER = 0x9E3779B9

K3_EXEC = kernels.Kernel("dt_forward_execute", [
    kernels.P, kernels.I32, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.P,
    kernels.I32, kernels.P])
# K3's int64 scratch: the two totals, then a block's (checksum, write
# count) pair in a word each; the library sizes its grid to the card and
# to this room
K3_SCRATCH = 2 + 2048
K12C_READ = kernels.Kernel("dt_version_read", [
    kernels.P, kernels.I32, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.I32, kernels.P, kernels.I32, kernels.I32, kernels.P, kernels.P])
K4_GEN = kernels.Kernel("dt_ycsb_generate", [
    kernels.P, kernels.I32, kernels.I32, kernels.I32, kernels.I32,
    kernels.F32, kernels.F32, kernels.F32, kernels.F32, kernels.F32,
    kernels.I32, kernels.F32, kernels.U32, kernels.U32, kernels.U64,
    kernels.U32, kernels.U32, kernels.U64, kernels.F32, kernels.I32,
    kernels.F32, kernels.I32, kernels.P, kernels.P, kernels.P])


@dataclass
class YCSBQuery:
    """One epoch's queries with leading dim n."""

    keys: torch.Tensor      # int32[n, R]
    is_write: torch.Tensor  # bool[n, R]


def _field_fingerprint(key, version) -> torch.Tensor:
    """Field value f(key, version) as int64 in [0, 2^32)
    (``deneva_tpu/workloads/ycsb.py:57``)."""
    return (_mul32(_u32(key), FP_MUL_KEY)
            ^ _mul32(_u32(version), FP_MUL_VER)) | 1


def _field_bytes(key, version, nbytes: int) -> torch.Tensor:
    """SIM_FULL_ROW payload uint8[..., nbytes], a pure function of
    (key, version) (``deneva_tpu/workloads/ycsb.py:65``)."""
    fp = _field_fingerprint(key, version)
    i = torch.arange(nbytes, dtype=torch.int64, device=fp.device)
    coef = (i * FP_MUL_KEY + FP_MUL_VER) & MASK32
    mixed = _mul32(fp[..., None], coef)
    return ((mixed >> 13) & 0xFF).to(torch.uint8)


def _forward_execute_f0_plain(f0, p, slots, trash, mono: bool = False):
    """Plain K3, op for op from ``deneva_tpu/workloads/ycsb.py:78``;
    writes ``f0`` in place.  Returns (f0, checksum, write_cnt), the two
    scalars int64 in [0, 2^32).

    ``mono`` drops the lanes before the first winner (index -1).  The
    reference's ``.at[-1].set(mode="drop")`` wraps -1 to the last padded
    row first, leaving an XLA-unspecified duplicate there, and without
    ``mono`` it steers losers and the winners of keys another partition
    owns onto the trash row; the port stores only winners below
    ``trash`` and leaves the trash and padded rows untouched."""
    gidx = torch.where(p.is_read, slots, torch.full_like(slots, trash)).long()
    vals = f0[gidx]
    if f0.ndim == 2:
        nbytes = f0.shape[1]
        vals = torch.where((p.fwd >= 0)[:, None],
                           _field_bytes(p.keys, p.fwd, nbytes), vals)
        cks = torch.where(p.is_read[:, None], vals.to(torch.int64), 0).sum()
    else:
        vals = torch.where(p.fwd >= 0, _field_fingerprint(p.keys, p.fwd),
                           _u32(vals))
        cks = torch.where(p.is_read, vals, 0).sum()

    def law(k, v):
        if f0.ndim == 2:
            return _field_bytes(k, v, f0.shape[1])
        return _field_fingerprint(k, v).to(torch.int32)
    if mono:
        neg = torch.full_like(slots, -1)
        wslot = torch.cummax(torch.where(p.win, slots, neg), 0).values
        wvals = law(seg_first(p.win, p.keys), seg_first(p.win, p.rank))
        keep = (wslot >= 0) & (wslot < trash)
        f0[wslot[keep].long()] = wvals[keep]
    else:
        keep = p.win & (slots < trash)
        f0[slots[keep].long()] = law(p.keys[keep], p.rank[keep])
    return f0, cks & MASK32, p.is_write.sum() & MASK32


def _forward_execute_f0(f0, p, slots, trash, mono: bool = False):
    """K3: the forwarding executor's data path over a sorted plan.

    On CUDA the kernel stores winners only, and only below ``trash``:
    the result of the reference's ``mono`` scatter.  (Under ``mono=False``,
    the striped layout of ``part_cnt > 1``, the reference also fills the
    trash row with losers' values and the winners of keys another
    partition owns, a row it leaves unspecified.)"""
    if kernels.on_cpu(f0, p.keys, slots):
        return _forward_execute_f0_plain(f0, p, slots, trash, mono)
    n = p.keys.shape[0]
    dev = f0.device
    if f0.ndim == 2:
        kernels.check("f0", f0, torch.uint8, device=dev)
        tup = f0.shape[1]
        if tup % 4:
            raise ValueError("K3 moves full rows as 4-byte words: "
                             "tup_size must be a multiple of 4")
    else:
        kernels.check("f0", f0, torch.int32, device=dev)
        tup = 0
    for name, t, dt in (("keys", p.keys, torch.int32),
                        ("rank", p.rank, torch.int32),
                        ("is_read", p.is_read, torch.bool),
                        ("is_write", p.is_write, torch.bool),
                        ("fwd", p.fwd, torch.int32),
                        ("win", p.win, torch.bool),
                        ("slots", slots, torch.int32)):
        kernels.check(name, t, dt, (n,), dev)
    acc = torch.empty(K3_SCRATCH, dtype=torch.int64, device=dev)
    K3_EXEC.launch(kernels.ptr(f0), tup, kernels.ptr(p.keys),
                   kernels.ptr(p.rank), kernels.ptr(p.is_read),
                   kernels.ptr(p.is_write), kernels.ptr(p.fwd),
                   kernels.ptr(p.win), kernels.ptr(slots), n, int(trash),
                   kernels.ptr(acc), K3_SCRATCH, kernels.stream(f0))
    return f0, acc[0], acc[1]


def _versioned_read_f0_plain(f0, ring: VersionRing, keys, slots, rmask,
                             ver_ts, capacity: int):
    """Plain K12c, op for op from ``deneva_tpu/workloads/ycsb.py:548-583``:
    the committed reads' checksum (int64 in [0, 2^32)) under MVCC, stale
    reads served the version current at ``ver_ts`` (int32[n], one per
    txn; read-only txns pass INT32_MAX and read the live row)."""
    rslots = torch.where(rmask, slots, capacity)
    vals = f0[rslots.long()]
    vstar, has = ring.version_from(ring.rows(slots),
                                   ver_ts[:, None].expand(slots.shape))
    if f0.ndim == 2:
        vals = torch.where(has[..., None],
                           _field_bytes(keys, vstar, f0.shape[1]), vals)
        cks = torch.where(rmask[..., None], vals.to(torch.int64), 0).sum()
    else:
        vals = torch.where(has, _field_fingerprint(keys, vstar), _u32(vals))
        cks = torch.where(rmask, vals, 0).sum()
    return cks & MASK32


def _versioned_read_f0(f0, ring: VersionRing, keys, slots, rmask, ver_ts,
                       capacity: int):
    """K12c: one thread per read lane gathers F0 and the lane's ring row
    and folds ``f(key, v*)`` or the live value into the checksum.  It
    reads the epoch-start table, so it runs before the epoch's stores."""
    if kernels.on_cpu(f0, keys, ring.wts):
        return _versioned_read_f0_plain(f0, ring, keys, slots, rmask,
                                        ver_ts, capacity)
    n, a = keys.shape
    dev = f0.device
    if f0.ndim == 2:
        kernels.check("f0", f0, torch.uint8, device=dev)
        tup = f0.shape[1]
        if tup % 4:
            raise ValueError("K12c moves full rows as 4-byte words: "
                             "tup_size must be a multiple of 4")
    else:
        kernels.check("f0", f0, torch.int32, device=dev)
        tup = 0
    kernels.check("ring", ring.wts, torch.int32, device=dev)
    kernels.check("keys", keys, torch.int32, (n, a), dev)
    kernels.check("slots", slots, torch.int32, (n, a), dev)
    kernels.check("rmask", rmask, torch.bool, (n, a), dev)
    kernels.check("ver_ts", ver_ts, torch.int32, (n,), dev)
    acc = torch.empty(1, dtype=torch.int32, device=dev)
    K12C_READ.launch(kernels.ptr(f0), tup, kernels.ptr(keys),
                     kernels.ptr(slots), kernels.ptr(rmask),
                     kernels.ptr(ver_ts), a, kernels.ptr(ring.wts),
                     ring.depth, n * a, kernels.ptr(acc), kernels.stream(f0))
    return acc[0].to(torch.int64) & MASK32


class YCSBWorkload:
    # writes overwrite a field with f(key, order) — independent of any
    # read — so the single-pass forwarding executor applies
    blind_writes = True
    txn_type_names = ("ycsb_ro", "ycsb_rw")

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = kernels.resolve_device(device)
        self.catalog = parse_schema(
            "TABLE=MAIN_TABLE\n"
            + "".join(f"\t{cfg.tup_size},string,F{i}\n"
                      for i in range(cfg.field_per_tuple))
            + "INDEX=MAIN_INDEX\n\tMAIN_TABLE,0\n")
        self.n_rows = cfg.synth_table_size
        # partitioned deployment (reference `key % g_part_cnt` ownership,
        # ycsb_wl.cpp:70-74): this node stores only the keys = node_id
        # (mod part_cnt); the strided index steers every other key to
        # the trash slot, so execution is local only
        self.n_parts = max(cfg.part_cnt, 1)
        if cfg.elastic:
            raise NotImplementedError(
                "deneva_tpu_torch's YCSB has no elastic membership "
                "(ROADMAP.md queue 1, item 18: cluster runtime)")
        if self.n_parts > 1:
            if self.n_rows % self.n_parts != 0:
                raise AssertionError(
                    "synth_table_size must divide evenly over part_cnt")
            self.n_local = self.n_rows // self.n_parts
            self.index = DenseIndex(base=cfg.node_id, stride=self.n_parts,
                                    size=self.n_local,
                                    miss_slot=self.n_local)
        else:
            self.n_local = self.n_rows
            self.index = DenseIndex(base=0, stride=1, size=self.n_rows,
                                    miss_slot=self.n_rows)
        if cfg.index_struct == "IDX_BTREE":
            # the ordered index on the primary path: the same key -> slot
            # map through a binary search (global.h:320-324)
            self.index = SortedIndex.build(
                self._owned_keys(0, self.n_local),
                torch.arange(self.n_local, dtype=torch.int32,
                             device=self.device), miss_slot=self.n_local)
        # key sampler: Gray zipfian or HOT two-tier uniform
        # (SKEW_METHOD, config.h:162-167)
        if cfg.skew_method == "HOT":
            self.sampler = HotSet(self.n_rows, int(cfg.data_perc),
                                  cfg.access_perc)
        else:
            self.sampler = Zipfian(self.n_rows, cfg.zipf_theta)
        self.n_req = cfg.req_per_query

    def txn_type_of(self, q: YCSBQuery) -> torch.Tensor:
        return q.is_write.any(dim=1).to(torch.int32)

    def empty_query(self, n: int, device) -> YCSBQuery:
        """An all-zero query batch of ``n`` rows (the pool's initial
        contents)."""
        shape = (n, self.n_req)
        return YCSBQuery(
            keys=torch.zeros(shape, dtype=torch.int32, device=device),
            is_write=torch.zeros(shape, dtype=torch.bool, device=device))

    def _owned_keys(self, lo: int, hi: int) -> torch.Tensor:
        """Global keys owned by this node in slots [lo, hi): slot s holds
        key ``node_id + s * part_cnt`` (``ycsb.py:203``, the one
        definition of the striped layout)."""
        base = self.cfg.node_id if self.n_parts > 1 else 0
        return (base + torch.arange(lo, hi, dtype=torch.int64,
                                    device=self.device)
                * self.n_parts).to(torch.int32)

    # -- loader (ycsb_wl.cpp:125-203) ----------------------------------
    def load(self, chunk: int = 1 << 18) -> dict:
        full = self.cfg.sim_full_row
        tab = DeviceTable.create(self.catalog.table(TABLE), self.n_local,
                                 self.device, full_row=full,
                                 striped=self.n_parts > 1)
        for lo in range(0, self.n_local, chunk):
            hi = min(lo + chunk, self.n_local)
            keys = self._owned_keys(lo, hi)
            if full:
                # SIM_FULL_ROW: every field holds real payload bytes
                init = _field_bytes(keys, 0, self.cfg.tup_size)
                for col in tab.columns.values():
                    col[lo:hi] = init
            else:
                # only F0 is touched by queries (ycsb_txn.cpp)
                tab.columns["F0"][lo:hi] = \
                    _field_fingerprint(keys, 0).to(torch.int32)
        if self.cfg.device_parts > 1:
            # the owner-major layout of a mesh: block d holds the keys
            # = d (mod D), the reference's strided node partition
            # (ycsb_wl.cpp:70-74) across devices
            tab = to_mc_layout(tab, self.cfg.device_parts)
        db = {TABLE: tab}
        if self.cfg.cc_alg == CCAlg.MVCC and self.cfg.device_parts == 1:
            # per-row overwrite-ts ring of F0 (row_mvcc.cpp:172-196), at
            # the full mvcc_his_len: a servable read may have H-1 newer
            # overwrites and needs one more entry, its own version.  A
            # mesh keeps none (ycsb.py:248): its reads take the live row
            db[VER_TABLE] = VersionRing.create(
                tab.columns["F0"].shape[0], self.cfg.mvcc_his_len,
                self.device)
        if self.cfg.audit:
            # the isolation audit's stamp tables ride the db, installed by
            # the loader as in the reference (cc/base.audit_observe)
            from deneva_tpu_torch.cc.base import AUDIT_KEY, audit_init
            db[AUDIT_KEY] = audit_init(self.cfg, self.device)
        return db

    # -- query generation (ycsb_query.cpp:303-376) ---------------------
    def generate_plain(self, rng: torch.Tensor, n: int) -> YCSBQuery:
        """Plain K4b, op for op from the reference."""
        cfg = self.cfg
        shape = (n, self.n_req)
        k1, k2, k3 = prng.split_plain(rng, 3)
        keys = self.sampler.sample(k1, shape)
        if cfg.key_order:
            # KEY_ORDER (config.h:106): each txn's keys ascending; the
            # write flags are iid per slot and stay where they are
            keys = torch.sort(keys, dim=1).values
        is_write = prng.bernoulli(k2, cfg.write_perc, shape)
        if cfg.txn_write_perc < 1.0:
            # TXN_WRITE_PERC: one draw per txn gates all its writes
            # (ycsb_query.cpp:313,331)
            is_write = is_write & prng.bernoulli(k3, cfg.txn_write_perc,
                                                 (n, 1))
        return YCSBQuery(keys=keys, is_write=is_write)

    def generate(self, rng: torch.Tensor, n: int) -> YCSBQuery:
        """K4b: ``n`` fresh queries from the raw key ``rng``, in one
        launch for every option (HOT, ``txn_write_perc``, ``key_order``
        sorting each row inside it)."""
        if kernels.on_cpu(rng):
            return self.generate_plain(rng, n)
        cfg = self.cfg
        shape = (n, self.n_req)
        kernels.check("rng", rng, torch.int64, (2,))
        keys = torch.empty(shape, dtype=torch.int32, device=rng.device)
        is_write = torch.empty(shape, dtype=torch.bool, device=rng.device)
        # key_order sorts a row in shared memory: the kernel refuses rows
        # of more than 64 keys
        K4_GEN.launch(kernels.ptr(rng), n, self.n_req, self.n_rows,
                      *self.sampler.kernel_params(),
                      np.float32(cfg.write_perc),
                      int(cfg.txn_write_perc < 1.0),
                      np.float32(cfg.txn_write_perc), int(cfg.key_order),
                      kernels.ptr(keys), kernels.ptr(is_write),
                      kernels.stream(rng))
        return YCSBQuery(keys=keys, is_write=is_write)

    # -- RW-set planning ------------------------------------------------
    def plan(self, db, q: YCSBQuery) -> dict:
        zeros = torch.zeros_like(q.keys)
        return dict(table_ids=zeros, keys=q.keys,
                    is_read=~q.is_write, is_write=q.is_write,
                    valid=torch.ones_like(q.is_write),
                    # the access's owner under modulo striping
                    owner=q.keys % self.n_parts if self.n_parts > 1
                    else zeros)

    def _local_slots(self, db, keys: torch.Tensor) -> torch.Tensor:
        return self.index.lookup(keys)

    # -- execution over a mesh (partition-parallel forwarding) ---------
    def execute_mc(self, db, batch, stats: dict):
        """The forwarding epoch over a mesh (``deneva_tpu/workloads/
        ycsb.py:330``): every shard plans and executes only the keys it
        owns, against its block of the owner-major F0.  Returns (db,
        bool[B] the txns the capacity rule deferred).

        With ``pair_cap = mc_pair_cap(...) > 0`` (the sharded plan) source
        shard s takes the balanced slice of txns ``[s * bD, (s + 1) *
        bD)``: K18a decides its defers and K18b packs its surviving lanes
        into one block per owner; the ``all_to_all`` hands each shard its
        ``[D, pair_cap]`` received lanes, which it masks to the keys it
        owns and plans with K1 and K2.  With ``pair_cap = 0`` (the
        replicated plan) every shard plans the whole batch restricted to
        its keys and nothing defers.  Then K3 executes each shard's plan
        on its block (slot ``key // D``; the block's last row is its
        trash), and the read checksums and write counts ``psum``."""
        from deneva_tpu_torch.ops.forward import (forward_plan,
                                                  forward_plan_flat,
                                                  mc_pack_blocks,
                                                  mc_pair_cap,
                                                  mc_slice_defer)
        from deneva_tpu_torch.parallel.mesh import current_mesh

        d_parts = self.cfg.device_parts
        mesh = current_mesh()
        if mesh is None or mesh.size != d_parts:
            raise RuntimeError(f"execute_mc needs a use_mesh({d_parts}) "
                               "context")
        tab: DeviceTable = db[TABLE]
        f0 = tab.columns["F0"]
        lb, _, trash = tab.mc_block_rows()
        valid = batch.valid & batch.active[:, None]
        b, a = batch.keys.shape
        pair_cap = mc_pair_cap(b, a, d_parts, self.cfg.mc_plan_capacity)
        plans = []
        if pair_cap:
            bd = b // d_parts
            w = batch.is_write & valid
            blocks, dfrs = [], []
            for s in range(d_parts):
                rows = slice(s * bd, (s + 1) * bd)
                k, v, ts = batch.keys[rows], valid[rows], batch.ts[rows]
                dfr, order = mc_slice_defer(k, v, ts, d_parts, pair_cap)
                blocks.append(mc_pack_blocks(
                    k, v, ts, batch.rank[rows], w[rows], dfr, order,
                    d_parts, pair_cap))
                dfrs.append(dfr)
            for me, (bk, br, bw) in enumerate(mesh.all_to_all(blocks)):
                mine = (bk % d_parts == me) & (bk != INT32_MAX)
                plans.append(forward_plan_flat(
                    torch.where(mine, bk, INT32_MAX), br, bw & mine))
            dfr = mesh.concat(dfrs)
        else:
            dfr = torch.zeros(b, dtype=torch.bool, device=mesh.device)
            for me in range(d_parts):
                owned = valid & (batch.keys % d_parts == me)
                plans.append(forward_plan(batch.keys, batch.rank,
                                          batch.is_write, owned))
        cks, wcnt = [], []
        for me, p in enumerate(plans):
            blk = f0[me * lb:(me + 1) * lb]
            slots = torch.where(p.keys != INT32_MAX, p.keys // d_parts,
                                trash)
            # slots ascend with the plan's sorted keys toward the trash
            _, c, n = _forward_execute_f0(blk, p, slots, trash, mono=True)
            cks.append(c)
            wcnt.append(n)
        stats["read_checksum"] = mesh.psum([stats["read_checksum"]] + cks)
        stats["write_cnt"] = mesh.psum([stats["write_cnt"]] + wcnt)
        return db, dfr

    def re_execute(self, db, q: YCSBQuery, mask: torch.Tensor,
                   order: torch.Tensor, stats: dict):
        """Transaction repair's re-execution (``ycsb.py:491``): `execute` of
        the salvaged rows against the current tables.  Lanes outside the
        frontier re-read values nothing overwrote, so the full re-gather
        is the masked re-read."""
        return self.execute(db, q, mask, order, stats)

    # -- execution (ycsb_txn.cpp:177-209 collapsed to one batch) -------
    def execute(self, db, q: YCSBQuery, mask, order: torch.Tensor,
                stats: dict, fwd_rank=None, level_exec: bool = False):
        """Apply the epoch: the forwarding arm over a sorted plan
        (``fwd_rank``, K3), or the masked arm over the committed ``mask``
        (``deneva_tpu/workloads/ycsb.py:544-606``)."""
        tab: DeviceTable = db[TABLE]
        if fwd_rank is not None:
            if self.cfg.device_parts > 1:
                raise ValueError("device_parts > 1 forwards through "
                                 "execute_mc under a mesh")
            if mask is not None:
                raise ValueError("ForwardPlan embodies the commit set; "
                                 "pass mask=None")
            p = fwd_rank
            slots = self._local_slots(db, p.keys)
            # one partition: slots follow the plan's sorted keys; striped,
            # the misses sit between the owned slots
            _, cks, wcnt = _forward_execute_f0(tab.columns["F0"], p, slots,
                                               tab.capacity,
                                               mono=self.n_parts == 1)
        else:
            cks, wcnt = self._execute_masked(tab, db.get(VER_TABLE), q,
                                             mask, order, level_exec)
        stats["read_checksum"] = (stats["read_checksum"] + cks) & MASK32
        stats["write_cnt"] = (stats["write_cnt"] + wcnt) & MASK32
        return db

    def _execute_masked(self, tab: DeviceTable, ver: VersionRing | None,
                        q: YCSBQuery, mask: torch.Tensor,
                        order: torch.Tensor, level_exec: bool = False):
        """Masked arm: committed reads gather F0 into the checksum (from
        the epoch-start rows: the gather precedes every write; under MVCC
        through K12c, stale reads served their version); committed
        writes store f(key, order), the last writer per slot by (order,
        lane) through K10 (in a chained level, ``level_exec``, every
        write lane), whose winners MVCC records in the version ring
        (K12d); losers steer to the trash row.  Returns (checksum,
        write_cnt) as int64 in [0, 2^32)."""
        full = self.cfg.sim_full_row
        slots = self._local_slots(None, q.keys)                 # [n, R]
        act = mask[:, None] & torch.ones_like(q.is_write)
        rmask = act & ~q.is_write
        if ver is not None:
            # order is the serialization ts; read-only txns carry 0 and
            # read the live snapshot (real ts are >= 1: next_seq starts
            # at 1), so they read "at +inf"
            ver_ts = torch.where(order > 0, order, INT32_MAX)
            cks = _versioned_read_f0(tab.columns["F0"], ver, q.keys, slots,
                                     rmask, ver_ts, tab.capacity)
        else:
            rslots = torch.where(rmask, slots, tab.capacity)
            vals = tab.gather(rslots, ("F0",))["F0"]
            if full:
                cks = torch.where(rmask[..., None], vals.to(torch.int64),
                                  0).sum()
            else:
                cks = torch.where(rmask, _u32(vals), 0).sum()
        wm = act & q.is_write
        wmask = wm.reshape(-1)
        wslots = torch.where(wm, slots, tab.capacity).reshape(-1)
        worder = order[:, None].expand(slots.shape).reshape(-1)
        # a chained level's committed set is write-conflict-free and a
        # txn's own duplicate lanes write one value: every lane is final
        win = wmask if level_exec else scatter.last_writer(
            wslots, worder, wmask, tab.capacity)
        keys = q.keys.reshape(-1)
        wvals = _field_bytes(keys, worder, self.cfg.tup_size) if full \
            else _field_fingerprint(keys, worder).to(torch.int32)
        if ver is not None:
            # one winner per row per epoch: each row advances one entry;
            # a winner of a key another partition owns pushes nothing
            ver.push(wslots, worder,
                     win & (wslots < tab.capacity) if tab.striped else win)
        tab.scatter(wslots, {"F0": wvals}, mask=win)
        return cks & MASK32, wmask.sum() & MASK32
