"""PPS — Product-Parts-Suppliers (reference `benchmarks/pps_wl.cpp`,
`pps_query.cpp`, `pps_txn.cpp`).

The port of ``deneva_tpu/workloads/pps.py``; under ``part_cnt > 1``
PARTS, PRODUCTS and SUPPLIERS hold node ``node_id``'s keys (key mod
part_cnt) and the mapping tables stay whole.  Five
tables (`benchmarks/PPS_schema.txt`): PARTS, PRODUCTS, SUPPLIERS and the
two mapping tables USES (product -> ``pps_parts_per`` parts) and
SUPPLIES (supplier -> parts), every primary key dense.  Eight txn types
mixed by the ``perc_*`` fields (`config.h:235-242`): three one-row
reads, two mapping walks (the anchor row, its mapping rows, then the
parts they name), ORDERPRODUCT (the walk, then PART_AMOUNT -= 1 on each
part), UPDATEPRODUCTPART (the product's part field) and UPDATEPART
(PART_AMOUNT += 100).  An epoch is four functions:

* ``load`` — the tables from numpy (the mapping through a copy of the
  reference's ``_map_part``), moved to the device;
* ``generate`` — the type against the cumulative mix and three uniform
  keys on the reference's threefry stream.  On the card it is kernel
  **K20** (``csrc/pps.cu``), which replaces ``deneva_tpu/workloads/
  pps.py:184`` `generate`: every draw of an epoch in one launch;
* ``plan`` — the RW-set with the reference's on-device reconnaissance:
  one gather of the USES / SUPPLIES rows names the parts a walk touches
  (the reference's sequencer runs a recon txn and restarts instead,
  `system/sequencer.cpp:88-115`); the mapping tables are never written,
  so the snapshot plan is exact.  The part escrow lanes are
  ``order_free``;
* ``execute`` — the GETPART checksum read, the PART_AMOUNT adds of
  ORDERPRODUCT and UPDATEPART through K14c's int32 path
  (`DeviceTable.scatter_add`), and UPDATEPRODUCTPART's write through the
  last writer (K10), or every writer of a chained level.

UPDATE* txns write fields other txns read in the same epoch, so
``blind_writes`` is False: TPU_BATCH and CALVIN take the chained
executor, as on TPC-C.  Under ``device_parts > 1`` PARTS, PRODUCTS and
SUPPLIERS are owner-major over the mesh and USES and SUPPLIES stay whole
(`workloads.mc`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.ops import prng, scatter
from deneva_tpu_torch.storage.catalog import parse_schema
from deneva_tpu_torch.storage.table import (DeviceTable, fill_columns,
                                            to_mc_layout)
from deneva_tpu_torch.workloads.base import partition_owned, partition_slot

MASK32 = 0xFFFFFFFF

_FIELDS = "".join(f"\t10,string,FIELD{i}\n" for i in range(1, 11))
PPS_SCHEMA = (
    "TABLE=PARTS\n\t8,int64_t,PART_KEY\n\t8,int64_t,PART_AMOUNT\n" + _FIELDS
    + "TABLE=PRODUCTS\n\t8,int64_t,PRODUCT_KEY\n\t8,int64_t,PRODUCT_PART\n"
    + _FIELDS
    + "TABLE=SUPPLIERS\n\t8,int64_t,SUPPLIER_KEY\n" + _FIELDS
    + "TABLE=USES\n\t8,int64_t,PRODUCT_KEY\n\t8,int64_t,PART_KEY\n"
    + "TABLE=SUPPLIES\n\t8,int64_t,SUPPLIER_KEY\n\t8,int64_t,PART_KEY\n")

TID = {"PARTS": 20, "PRODUCTS": 21, "SUPPLIERS": 22, "USES": 23,
       "SUPPLIES": 24}

(GETPART, GETPRODUCT, GETSUPPLIER, GETPARTBYPRODUCT, GETPARTBYSUPPLIER,
 ORDERPRODUCT, UPDATEPRODUCTPART, UPDATEPART) = range(8)

K20_GEN = kernels.Kernel("dt_pps_generate", [
    kernels.P, kernels.I32, kernels.P, kernels.I32, kernels.I32, kernels.I32,
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P])


@dataclass
class PPSQuery:
    """One epoch of PPS queries (reference `PPSQuery`, `benchmarks/
    pps_query.cpp:40-120`); the parts behind a walk resolve in ``plan``."""

    txn_type: torch.Tensor      # int32[n] 0..7
    part_key: torch.Tensor      # int32[n]
    product_key: torch.Tensor   # int32[n]
    supplier_key: torch.Tensor  # int32[n]


class PPSWorkload:
    """Product-Parts-Suppliers over five device tables."""

    txn_type_names = ("pps_getpart", "pps_getproduct", "pps_getsupplier",
                      "pps_getpartbyproduct", "pps_getpartbysupplier",
                      "pps_orderproduct", "pps_updateproductpart",
                      "pps_updatepart")
    # UPDATE* txns rewrite fields read in the same epoch, so the
    # single-pass forwarding executor does not apply
    blind_writes = False

    def txn_type_of(self, q: PPSQuery) -> torch.Tensor:
        return q.txn_type

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = kernels.resolve_device(device)
        self.catalog = parse_schema(PPS_SCHEMA)
        self.n_parts = cfg.pps_parts_cnt
        self.n_products = cfg.pps_products_cnt
        self.n_suppliers = cfg.pps_suppliers_cnt
        self.per = cfg.pps_parts_per     # MAX_PPS_PART_PER_PRODUCT
        # partitioned deployment: PARTS / PRODUCTS / SUPPLIERS stripe by
        # key % part_cnt; the immutable USES / SUPPLIES maps stay whole on
        # every node, which keeps the recon plan local
        self.n_pt = max(cfg.part_cnt, 1)
        self.me = cfg.node_id if self.n_pt > 1 else 0
        for nm, n in (("pps_parts_cnt", self.n_parts),
                      ("pps_products_cnt", self.n_products),
                      ("pps_suppliers_cnt", self.n_suppliers)):
            if n % self.n_pt != 0:
                raise ValueError(f"{nm} must divide evenly over part_cnt")
        self.n_parts_loc = self.n_parts // self.n_pt
        self.n_products_loc = self.n_products // self.n_pt
        self.n_suppliers_loc = self.n_suppliers // self.n_pt
        need = 1 + 2 * self.per
        if cfg.max_accesses < need:
            raise ValueError(f"PPS needs max_accesses >= {need}")
        # txn-type mix (config.h:235-242); order matches the enum
        self.mix = np.array([
            cfg.perc_getparts, cfg.perc_getproducts, cfg.perc_getsuppliers,
            cfg.perc_getpartbyproduct, cfg.perc_getpartbysupplier,
            cfg.perc_orderproduct, cfg.perc_updateproductpart,
            cfg.perc_updatepart], np.float64)
        if abs(self.mix.sum() - 1.0) >= 1e-6:
            raise ValueError("PPS txn mix must sum to 1")
        self.cum = torch.from_numpy(
            np.cumsum(self.mix).astype(np.float32)).to(self.device)

    # local slots: a key another node owns resolves to the trash row
    def _owned(self, key):
        return partition_owned(key, self.n_pt, self.me)

    def part_slot(self, key):
        return partition_slot(key, self.n_pt, self.me, self.n_parts_loc)

    def product_slot(self, key):
        return partition_slot(key, self.n_pt, self.me, self.n_products_loc)

    # -- loader (pps_wl.cpp:71-111 threadInit*) -------------------------
    def load(self) -> dict:
        """The initial database (``deneva_tpu/workloads/pps.py:141``)."""
        db = {}

        def fill(name, cap, cols):
            t = DeviceTable.create(self.catalog.table(name), cap,
                                   self.device, striped=self.n_pt > 1)
            db[name] = fill_columns(t, cap, {
                c: torch.from_numpy(v) for c, v in cols.items()})

        p, me = self.n_pt, self.me
        p_ids = me + p * np.arange(self.n_parts_loc, dtype=np.int32)
        fill("PARTS", self.n_parts_loc,
             {"PART_KEY": p_ids,
              "PART_AMOUNT": np.full(self.n_parts_loc, 10000, np.int32)})
        pr_ids = me + p * np.arange(self.n_products_loc, dtype=np.int32)
        fill("PRODUCTS", self.n_products_loc,
             {"PRODUCT_KEY": pr_ids,
              "PRODUCT_PART": _map_part(pr_ids, 0, 0, self.n_parts)})
        s_ids = me + p * np.arange(self.n_suppliers_loc, dtype=np.int32)
        fill("SUPPLIERS", self.n_suppliers_loc, {"SUPPLIER_KEY": s_ids})
        # mapping tables: row (anchor * per + j) -> part
        u = np.arange(self.n_products * self.per, dtype=np.int32)
        fill("USES", len(u),
             {"PRODUCT_KEY": u // self.per,
              "PART_KEY": _map_part(u // self.per, u % self.per, 1,
                                    self.n_parts)})
        s = np.arange(self.n_suppliers * self.per, dtype=np.int32)
        fill("SUPPLIES", len(s),
             {"SUPPLIER_KEY": s // self.per,
              "PART_KEY": _map_part(s // self.per, s % self.per, 2,
                                    self.n_parts)})
        d_parts = self.cfg.device_parts
        if d_parts > 1:
            # the owner-major layout of a mesh (``pps.py:172-179``): the
            # anchor keys stripe over the shards; the read-only mapping
            # tables stay whole for every shard, which keeps the recon
            # plan local
            for name in ("PARTS", "PRODUCTS", "SUPPLIERS"):
                db[name] = to_mc_layout(db[name], d_parts)
            for name in ("USES", "SUPPLIES"):
                db[name].mc_replicated = True
        return db

    def empty_query(self, n: int, device) -> PPSQuery:
        """An all-zero query batch of ``n`` rows (the pool's initial
        contents)."""
        def z():
            return torch.zeros(n, dtype=torch.int32, device=device)
        return PPSQuery(txn_type=z(), part_key=z(), product_key=z(),
                        supplier_key=z())

    # -- generation (pps_query.cpp:40-120) ------------------------------
    def generate_plain(self, rng: torch.Tensor, n: int) -> PPSQuery:
        """Plain K20, op for op from ``deneva_tpu/workloads/pps.py:184``."""
        k = prng.split_plain(rng, 4)
        r = prng.uniform(k[0], (n,))
        cum = self.cum.to(rng.device)
        txn_type = (r[:, None] >= cum[None, :]).sum(dim=1).to(torch.int32)
        return PPSQuery(
            txn_type=torch.clamp(txn_type, 0, 7),
            part_key=prng.randint(k[1], (n,), 0, self.n_parts),
            product_key=prng.randint(k[2], (n,), 0, self.n_products),
            supplier_key=prng.randint(k[3], (n,), 0, self.n_suppliers))

    def generate(self, rng: torch.Tensor, n: int) -> PPSQuery:
        """K20: ``n`` fresh queries from the raw key ``rng``."""
        if kernels.on_cpu(rng):
            return self.generate_plain(rng, n)
        dev = rng.device
        kernels.check("rng", rng, torch.int64, (2,), dev)
        kernels.check("cum", self.cum, torch.float32, (8,), dev)
        q = self.empty_query(n, dev)
        K20_GEN.launch(kernels.ptr(rng), n, kernels.ptr(self.cum),
                       self.n_parts, self.n_products, self.n_suppliers,
                       kernels.ptr(q.txn_type), kernels.ptr(q.part_key),
                       kernels.ptr(q.product_key),
                       kernels.ptr(q.supplier_key), kernels.stream(rng))
        return q

    # -- RW-set planning with on-device recon ---------------------------
    def plan(self, db, q: PPSQuery) -> dict:
        """``deneva_tpu/workloads/pps.py:221``: access 0 the anchor row,
        accesses 1..per the mapping rows of a walk, 1+per..1+2*per the
        parts they name (one gather of the snapshot's mapping)."""
        n = q.txn_type.shape[0]
        dev = q.txn_type.device
        a = self.cfg.max_accesses
        t = q.txn_type
        per = self.per

        anchor_is_part = (t == GETPART) | (t == UPDATEPART)
        anchor_is_supp = (t == GETSUPPLIER) | (t == GETPARTBYSUPPLIER)
        by_prod = (t == GETPARTBYPRODUCT) | (t == ORDERPRODUCT)
        walks = by_prod | (t == GETPARTBYSUPPLIER)

        def zi():
            return torch.zeros((n, a), dtype=torch.int32, device=dev)

        def zb():
            return torch.zeros((n, a), dtype=torch.bool, device=dev)
        tables, keys, owner = zi(), zi(), zi()
        is_read, is_write, valid, order_free = zb(), zb(), zb(), zb()

        # access 0: the anchor row
        tables[:, 0] = torch.where(
            anchor_is_part, TID["PARTS"],
            torch.where(anchor_is_supp, TID["SUPPLIERS"], TID["PRODUCTS"]))
        keys[:, 0] = torch.where(
            anchor_is_part, q.part_key,
            torch.where(anchor_is_supp, q.supplier_key, q.product_key))
        is_read[:, 0] = True
        is_write[:, 0] = (t == UPDATEPRODUCTPART) | (t == UPDATEPART)
        valid[:, 0] = True
        # UPDATEPART is a pure escrow add; GETPART's read stays ordered
        order_free[:, 0] = t == UPDATEPART

        # accesses 1..per: the mapping rows (reads); recon: gather the
        # part keys they name from the snapshot
        lane = torch.arange(per, dtype=torch.int32, device=dev)
        anchor = torch.where(by_prod, q.product_key, q.supplier_key)
        map_key = anchor[:, None] * per + lane[None, :]
        map_tid = torch.where(by_prod, TID["USES"], TID["SUPPLIES"])
        uses = db["USES"].columns["PART_KEY"]
        supp = db["SUPPLIES"].columns["PART_KEY"]
        # each branch reads inside its own table (the other branch's
        # index may not be, and the select drops it)
        part_keys = torch.where(
            by_prod[:, None],
            uses[torch.clamp(map_key, 0, db["USES"].capacity - 1).long()],
            supp[torch.clamp(map_key, 0,
                             db["SUPPLIES"].capacity - 1).long()])
        wmask = walks[:, None].expand(n, per)
        tables[:, 1:1 + per] = map_tid[:, None]
        keys[:, 1:1 + per] = map_key
        is_read[:, 1:1 + per] = wmask
        valid[:, 1:1 + per] = wmask

        # accesses 1+per..1+2*per: the resolved part rows;
        # ORDERPRODUCT's are pure escrow decrements
        pw = (t == ORDERPRODUCT)[:, None] & wmask
        tables[:, 1 + per:1 + 2 * per] = TID["PARTS"]
        keys[:, 1 + per:1 + 2 * per] = part_keys
        is_read[:, 1 + per:1 + 2 * per] = wmask
        is_write[:, 1 + per:1 + 2 * per] = pw
        valid[:, 1 + per:1 + 2 * per] = wmask
        order_free[:, 1 + per:1 + 2 * per] = pw
        if self.n_pt > 1:
            # each access's owner (0 on one partition): the anchor row's
            # node, which the replicated maps' reads belong to as well,
            # and each part row's
            owner[:, 0] = keys[:, 0] % self.n_pt
            owner[:, 1:1 + per] = (anchor % self.n_pt)[:, None]
            owner[:, 1 + per:1 + 2 * per] = part_keys % self.n_pt
        return dict(table_ids=tables, keys=keys, is_read=is_read,
                    is_write=is_write, valid=valid, order_free=order_free,
                    owner=owner)

    # -- execution ------------------------------------------------------
    def execute(self, db, q: PPSQuery, mask: torch.Tensor,
                order: torch.Tensor, stats: dict, fwd_rank=None,
                level_exec: bool = False):
        """Apply the committed ``mask`` (``pps.py:302``); in place."""
        if fwd_rank is not None:
            raise ValueError("PPS has no forwarding executor")
        t = q.txn_type
        per = self.per
        n = t.shape[0]
        dev = t.device
        parts = db["PARTS"]

        # GETPART's read feeds the checksum (the int32 sum, as uint32)
        anchor_amt = parts.gather(self.part_slot(q.part_key),
                                  ("PART_AMOUNT",))["PART_AMOUNT"]
        got = mask & (t == GETPART) & self._owned(q.part_key)
        _acc(stats, "read_checksum",
             torch.where(got, anchor_amt, 0).to(torch.int64).sum())

        # ORDERPRODUCT: PART_AMOUNT -= 1 on each part of the product
        om = mask & (t == ORDERPRODUCT)
        lane = torch.arange(per, dtype=torch.int32, device=dev)
        ukey = q.product_key[:, None] * per + lane[None, :]
        used = db["USES"].columns["PART_KEY"][ukey.long()]
        m2 = om[:, None].expand(n, per).reshape(-1)
        parts.scatter_add(
            self.part_slot(used).reshape(-1).contiguous(),
            {"PART_AMOUNT": torch.where(m2, -1, 0).to(torch.int32)},
            mask=m2)

        # UPDATEPART: PART_AMOUNT += 100 (run_updatepart_1)
        um = mask & (t == UPDATEPART)
        parts.scatter_add(
            self.part_slot(q.part_key),
            {"PART_AMOUNT": torch.where(um, 100, 0).to(torch.int32)},
            mask=um)

        # UPDATEPRODUCTPART: the product's part field = part_key
        pm = mask & (t == UPDATEPRODUCTPART)
        prod = db["PRODUCTS"]
        pslot = self.product_slot(q.product_key)
        if level_exec:
            # a chained level's committed set is write-conflict-free:
            # each product has at most one writer in the call
            win = pm
        else:
            win = scatter.last_writer(
                torch.where(pm, pslot, prod.capacity).to(torch.int32),
                order, pm, prod.capacity)
        prod.scatter(pslot, {"PRODUCT_PART": q.part_key}, mask=win)

        _acc(stats, "write_cnt", om.sum() * per + um.sum() + pm.sum())
        return db


def _acc(stats: dict, key: str, delta) -> None:
    stats[key] = (stats[key] + delta) & MASK32


def _map_part(anchor, j, salt, n_parts) -> np.ndarray:
    """Deterministic anchor -> part mapping for USES / SUPPLIES (a copy of
    ``deneva_tpu/workloads/pps.py:356``; the reference's C++ loader draws
    URand parts, `pps_wl.cpp` threadInitUses)."""
    h = (np.asarray(anchor).astype(np.int64) * 1000003 + np.asarray(j) * 7919
         + salt * 104729) % 2654435761
    return (h % n_parts).astype(np.int32)
