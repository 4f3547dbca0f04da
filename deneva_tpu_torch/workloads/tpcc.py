"""TPC-C (reference `benchmarks/tpcc_wl.cpp`, `tpcc_query.cpp`, `tpcc_txn.cpp`).

The port of ``deneva_tpu/workloads/tpcc.py`` (under ``part_cnt > 1``
node ``node_id`` stores the warehouses = node_id mod part_cnt, and ITEM
whole): Payment + NewOrder over nine device tables (`benchmarks/
TPCC_short_schema.txt`, or the full schema's extra columns), composite
keys flattened to dense int32 slots.  An epoch is four functions:

* ``load`` — every initial value is arithmetic on the row index, built
  on the device;
* ``generate`` — one epoch's queries with the reference's distributions
  on its threefry stream (remote payment customer 15%, by-last-name 60%,
  NURand customers and items, 5-15 items, remote supply 1% under
  ``mpr_neworder``).  On the card it is kernel **K19** (``csrc/
  tpcc.cu``), which replaces ``deneva_tpu/workloads/tpcc.py:470``
  `generate` with ``:174`` `_nurand`: every draw of an epoch, the
  in-txn item dedup and the by-last-name probe key in one launch.  The
  probe itself is K14a (`storage.index.HashIndex.lookup`) on the
  CUSTOMER_LAST index; the postings gather and the final select stay
  torch glue;
* ``plan`` — the RW-set declared up front: warehouse, district and
  customer rows (escrow, ``order_free``) and up to ``max_items_per_txn``
  stock rows; ITEM reads are left out (the table is never written);
* ``execute`` — payments add into W_YTD / D_YTD / the customer through
  K14c (`DeviceTable.scatter_add`, exact and in lane order; Payment's
  three tables in one `storage.table.scatter_add_many` launch), NewOrders
  take ``D_NEXT_O_ID + rank`` (the rank among the district's committed
  NewOrders in serialization order: three stable sorts and a cummax of
  glue), apply the stock quantity rule through the last writer (K10, or
  every valid lane in a chained level) and append ORDER, NEW-ORDER,
  ORDER-LINE and HISTORY rows through K14d (`DeviceTable.append`).  With
  ``tpcc_order_index`` each pass merges its new orders into the dynamic
  ORDER index (``db["ORDER_IDX"]``, keyed district-major by
  ``order_index_key``) through K14e (`DynamicSortedIndex.insert`).

Under ``device_parts > 1`` the tables are owner-major over the mesh,
anchored by warehouse (ITEM stays whole), and the ring appends pass
``anchor=w_id`` so each row lands on its warehouse's block
(`workloads.mc`).

Tables are written in place, so ``D_NEXT_O_ID`` and ``S_QUANTITY`` are
gathered before they are scattered, in the reference's program order.
uint32 words (fingerprints, the loader's hashes, the read checksum's
cast) are computed in int64 masked to 32 bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.ops import prng, scatter
from deneva_tpu_torch.ops.hashing import mul32, u32
from deneva_tpu_torch.storage import table
from deneva_tpu_torch.storage.catalog import parse_schema
from deneva_tpu_torch.storage.index import DynamicSortedIndex, HashIndex
from deneva_tpu_torch.storage.table import (DeviceTable, fill_columns,
                                            to_mc_layout)
from deneva_tpu_torch.workloads.base import (partition_owned,
                                              partition_slot)

MASK32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# schema (column set of benchmarks/TPCC_short_schema.txt)

_SCHEMA_COLS = {
    "WAREHOUSE": [("W_ID", "int64_t"), ("W_TAX", "double"),
                  ("W_YTD", "double")],
    "DISTRICT": [("D_ID", "int64_t"), ("D_W_ID", "int64_t"),
                 ("D_TAX", "double"), ("D_YTD", "double"),
                 ("D_NEXT_O_ID", "int64_t")],
    "CUSTOMER": [("C_ID", "int64_t"), ("C_D_ID", "int64_t"),
                 ("C_W_ID", "int64_t"), ("C_LAST", "int64_t"),
                 ("C_DISCOUNT", "double"), ("C_BALANCE", "double"),
                 ("C_YTD_PAYMENT", "double"), ("C_PAYMENT_CNT", "int64_t")],
    "HISTORY": [("H_C_ID", "int64_t"), ("H_C_D_ID", "int64_t"),
                ("H_C_W_ID", "int64_t"), ("H_D_ID", "int64_t"),
                ("H_W_ID", "int64_t"), ("H_AMOUNT", "double")],
    "NEW-ORDER": [("NO_O_ID", "int64_t"), ("NO_D_ID", "int64_t"),
                  ("NO_W_ID", "int64_t")],
    "ORDER": [("O_ID", "int64_t"), ("O_C_ID", "int64_t"),
              ("O_D_ID", "int64_t"), ("O_W_ID", "int64_t"),
              ("O_ENTRY_D", "int64_t"), ("O_OL_CNT", "int64_t"),
              ("O_ALL_LOCAL", "int64_t")],
    "ORDER-LINE": [("OL_O_ID", "int64_t"), ("OL_D_ID", "int64_t"),
                   ("OL_W_ID", "int64_t"), ("OL_NUMBER", "int64_t"),
                   ("OL_I_ID", "int64_t"), ("OL_QUANTITY", "int64_t")],
    "ITEM": [("I_ID", "int64_t"), ("I_IM_ID", "int64_t"),
             ("I_PRICE", "int64_t")],
    "STOCK": [("S_I_ID", "int64_t"), ("S_W_ID", "int64_t"),
              ("S_QUANTITY", "int64_t"), ("S_REMOTE_CNT", "int64_t")],
}

TPCC_SCHEMA = "".join(
    f"TABLE={t}\n" + "".join(f"\t8,{ct},{cn}\n" for cn, ct in cols)
    for t, cols in _SCHEMA_COLS.items())

# TPCC_FULL_SCHEMA extras (reference `benchmarks/TPCC_full_schema.txt`):
# the columns the short schema drops, strings as fingerprint words
_FULL_EXTRA = {
    "WAREHOUSE": [("W_NAME", "string", 10), ("W_STREET_1", "string", 20),
                  ("W_STREET_2", "string", 20), ("W_CITY", "string", 20),
                  ("W_STATE", "string", 2), ("W_ZIP", "string", 9)],
    "DISTRICT": [("D_NAME", "string", 10), ("D_STREET_1", "string", 20),
                 ("D_STREET_2", "string", 20), ("D_CITY", "string", 20),
                 ("D_STATE", "string", 2), ("D_ZIP", "string", 9)],
    "CUSTOMER": [("C_FIRST", "string", 16), ("C_MIDDLE", "string", 2),
                 ("C_STREET_1", "string", 20), ("C_STREET_2", "string", 20),
                 ("C_CITY", "string", 20), ("C_STATE", "string", 2),
                 ("C_ZIP", "string", 9), ("C_PHONE", "string", 16),
                 ("C_SINCE", "int64_t", 8), ("C_CREDIT", "string", 2),
                 ("C_CREDIT_LIM", "int64_t", 8),
                 ("C_DELIVERY_CNT", "uint64_t", 8),
                 ("C_DATA", "string", 500)],
    "HISTORY": [("H_DATE", "int64_t", 8), ("H_DATA", "string", 24)],
    "ORDER": [("O_CARRIER_ID", "int64_t", 8)],
    "ORDER-LINE": [("OL_SUPPLY_W_ID", "int64_t", 8),
                   ("OL_DELIVERY_D", "int64_t", 8),
                   ("OL_AMOUNT", "double", 8),
                   ("OL_DIST_INFO", "string", 24)],
    "ITEM": [("I_NAME", "string", 24), ("I_DATA", "string", 50)],
    "STOCK": [(f"S_DIST_{i:02d}", "string", 24) for i in range(1, 11)]
             + [("S_YTD", "int64_t", 8), ("S_ORDER_CNT", "int64_t", 8),
                ("S_DATA", "string", 50)],
}


def tpcc_schema(full: bool) -> str:
    if not full:
        return TPCC_SCHEMA
    out = []
    for t, cols in _SCHEMA_COLS.items():
        out.append(f"TABLE={t}\n")
        out.extend(f"\t8,{ct},{cn}\n" for cn, ct in cols)
        out.extend(f"\t{sz},{ct},{cn}\n"
                   for cn, ct, sz in _FULL_EXTRA.get(t, ()))
    return "".join(out)


# table ids for CC access identity (order matters: stable across runs)
TID = {name: i for i, name in enumerate(_SCHEMA_COLS)}

TPCC_PAYMENT = 0
TPCC_NEW_ORDER = 1

_LASTNAMES = 1000          # Lastname(NURand(255,0,999)), tpcc_helper.cpp
_MAX_KERNEL_ITEMS = 32     # K19 holds a txn's item lanes in one warp

K19_GEN = kernels.Kernel("dt_tpcc_generate", [
    kernels.P, kernels.I32, kernels.I32, kernels.I32, kernels.I32,
    kernels.I32, kernels.I32, kernels.F32, kernels.F32, kernels.I32,
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.P, kernels.P, kernels.P])


@dataclass
class TPCCQuery:
    """One epoch's TPC-C queries with leading dim n (`benchmarks/
    tpcc_query.h`), the item list padded to ``max_items_per_txn``."""

    txn_type: torch.Tensor     # int32[n]  TPCC_PAYMENT | TPCC_NEW_ORDER
    w_id: torch.Tensor         # int32[n]  home warehouse (0-based)
    d_id: torch.Tensor         # int32[n]
    c_id: torch.Tensor         # int32[n]  resolved customer
    c_w_id: torch.Tensor       # int32[n]  payment customer warehouse
    c_d_id: torch.Tensor       # int32[n]
    h_amount: torch.Tensor     # float32[n]
    ol_cnt: torch.Tensor       # int32[n]
    items: torch.Tensor        # int32[n, I]; duplicates invalidated
    item_valid: torch.Tensor   # bool[n, I]
    supply_w: torch.Tensor     # int32[n, I]
    quantity: torch.Tensor     # int32[n, I]


def _f32(x: float, device) -> torch.Tensor:
    """A float32 constant: a reference Python float meeting a float32
    array rounds to float32 first."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _nurand(key: torch.Tensor, a: int, n: int, shape) -> torch.Tensor:
    """TPC-C NURand(A, 0, n-1) with C=0 (``tpcc.py:174``)."""
    k1, k2 = prng.split_plain(key, 2)
    x = prng.randint(k1, shape, 0, a + 1)
    y = prng.randint(k2, shape, 0, n)
    return (x | y) % n


def _uniform_range(key: torch.Tensor, shape, lo: float, hi: float
                   ) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)`` as XLA computes
    it: ``max(lo, f * (hi - lo) + lo)`` with one rounding (an FMA).  The
    product and sum of a 24-bit f and the small constants are exact in
    float64, so one rounding to float32 is that FMA."""
    bits = prng.random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    v = (f.to(torch.float64) * float(np.float32(hi - lo))
         + float(np.float32(lo))).to(torch.float32)
    return torch.clamp_min(v, float(np.float32(lo)))


class TPCCWorkload:
    """Payment + NewOrder over 9 device tables."""

    txn_type_names = ("tpcc_payment", "tpcc_new_order")
    # NewOrder's stock update reads what it writes, so the single-pass
    # forwarding executor does not apply
    blind_writes = False

    def txn_type_of(self, q: TPCCQuery) -> torch.Tensor:
        return q.txn_type

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = kernels.resolve_device(device)
        self.full_schema = cfg.tpcc_full_schema
        self.catalog = parse_schema(tpcc_schema(self.full_schema))
        self.n_wh = cfg.num_wh
        self.n_dist = 10                     # DIST_PER_WARE (tpcc_const.h)
        self.cust_per_dist = cfg.cust_per_dist
        self.max_items = cfg.max_items
        self.ipt = cfg.max_items_per_txn     # MAX_ITEMS_PER_TXN
        # partitioned deployment: warehouse -> node (reference
        # wh_to_part, tpcc_helper.cpp); this node stores the warehouses
        # = node_id (mod part_cnt), and the read-only ITEM whole
        self.n_parts = max(cfg.part_cnt, 1)
        self.me = cfg.node_id if self.n_parts > 1 else 0
        if self.n_wh % self.n_parts != 0:
            raise ValueError("num_wh must divide evenly over part_cnt")
        self.n_wh_loc = self.n_wh // self.n_parts
        # every district holds at least one customer per lastname
        self.lastnames = min(_LASTNAMES, self.cust_per_dist)
        need = 3 + self.ipt                  # wh + dist + cust + stock rows
        if cfg.max_accesses < need:
            raise ValueError(
                f"TPCC needs max_accesses >= {need}, got {cfg.max_accesses}")
        self.n_districts = self.n_wh * self.n_dist
        self.n_cust = self.n_districts * self.cust_per_dist
        self.n_stock = self.n_wh * self.max_items
        # local (stored) row counts: the global counts over n_parts
        self.n_districts_loc = self.n_wh_loc * self.n_dist
        self.n_cust_loc = self.n_districts_loc * self.cust_per_dist
        self.n_stock_loc = self.n_wh_loc * self.max_items
        lim = 2**31 - 1
        if max(self.n_stock, self.n_cust) > lim:
            raise ValueError("TPCC key space exceeds int32: shrink "
                             "num_wh/max_items/cust_per_dist")
        if (self.n_districts + 1) * 2 * cfg.epoch_batch > lim:
            raise ValueError("num_wh*10*2*epoch_batch must fit int32")
        if cfg.tpcc_by_last_index:
            self._build_lastname_index()

    def _build_lastname_index(self):
        """CUSTOMER_LAST nonunique secondary index (``tpcc.py:234``): a
        hash probe on (w, d, lastname) gives a packed (postings start,
        count); the postings list each lastname's customers in ascending
        order, and a payment takes the middle one."""
        cpd, names = self.cust_per_dist, self.lastnames
        c = np.arange(self.n_cust, dtype=np.int64)
        c_local = (c % cpd).astype(np.int32)
        dist = (c // cpd).astype(np.int64)
        lastkey = dist * names + c_local % names        # (w,d,L) composite
        order = np.lexsort((c_local, lastkey))
        postings = c_local[order]                       # grouped by lastkey
        sorted_keys = lastkey[order]
        uniq, starts, counts = np.unique(sorted_keys, return_index=True,
                                         return_counts=True)
        if counts.max() >= 256 or len(postings) >= (1 << 23):
            raise ValueError("CUSTOMER_LAST packing overflow: shrink "
                             "cust_per_dist or num_wh")
        packed = (starts.astype(np.int64) << 8 | counts).astype(np.int32)
        self.last_idx = HashIndex.build(uniq.astype(np.int32), packed,
                                        miss_slot=0, device=self.device)
        self.last_postings = torch.from_numpy(postings).to(self.device)

    def _lastname_middle(self, c_w, c_d, lastname) -> torch.Tensor:
        """Middle same-lastname customer via the index probe."""
        key = (c_w * self.n_dist + c_d) * self.lastnames + lastname
        return self._middle_of(self.last_idx.lookup(key.to(torch.int32)))

    def _middle_of(self, packed: torch.Tensor) -> torch.Tensor:
        start, cnt = packed >> 8, packed & 0xFF
        at = torch.clamp(start + cnt // 2, 0,
                         self.last_postings.shape[0] - 1)
        return self.last_postings[at.long()]

    # -- composite keys (tpcc_helper.h:24-30, flattened dense) ----------
    def dist_key(self, w, d):
        return w * self.n_dist + d

    def cust_key(self, w, d, c):
        return self.dist_key(w, d) * self.cust_per_dist + c

    def order_index_key(self, w, d, o_id):
        """The dynamic ORDER index's key (``tpcc.py:282``), district-major
        so one district's orders are a contiguous ascending o_id run; the
        ``tpcc_order_index`` config check keeps it inside int32."""
        return (self.dist_key(w, d) * (1 << 21)).to(torch.int32) \
            + o_id.to(torch.int32)

    def stock_key(self, w, i):
        return w * self.max_items + i

    # local slots (``tpcc.py:292-320``): a warehouse this node does not
    # own resolves to each table's trash row, which no store writes
    def wh_owned(self, w):
        return partition_owned(w, self.n_parts, self.me)

    def _at_home(self, m, w):
        """``m`` narrowed to the txns whose warehouse ``w`` this node
        owns: the inserts happen at the home warehouse's owner only."""
        return m if self.n_parts == 1 else m & self.wh_owned(w)

    def _wloc(self, w):
        return w // self.n_parts if self.n_parts > 1 else w

    def wh_slot(self, w):
        return partition_slot(w, self.n_parts, self.me, self.n_wh_loc)

    def _owned_slot(self, w, local, trash: int):
        if self.n_parts == 1:
            return local
        return torch.where(self.wh_owned(w), local, trash).to(local.dtype)

    def dist_slot(self, w, d):
        return self._owned_slot(w, self._wloc(w) * self.n_dist + d,
                                self.n_districts_loc)

    def cust_slot(self, w, d, c):
        return self._owned_slot(
            w, (self._wloc(w) * self.n_dist + d) * self.cust_per_dist + c,
            self.n_cust_loc)

    def stock_slot(self, w, i):
        return self._owned_slot(w, self._wloc(w) * self.max_items + i,
                                self.n_stock_loc)

    # -- loader (tpcc_wl.cpp:89-152) --------------------------------------
    def load(self) -> dict:
        """The initial database, built on the device from the row index
        (``tpcc.py:326-468``)."""
        dev, cfg = self.device, self.cfg
        db = {}

        def tab(name, cap, ring=False):
            t = DeviceTable.create(self.catalog.table(name), cap, dev,
                                   ring=ring, striped=self.n_parts > 1)
            db[name] = t
            return t

        def ar(n):
            return torch.arange(n, dtype=torch.int32, device=dev)

        # local slot l stores global warehouse me + n_parts * (l // ...):
        # values derive from GLOBAL ids, as a one-node load gives them
        p, me = self.n_parts, self.me
        f02 = _f32(0.2, dev)
        n_wh, n_dist, n_cust = self.n_wh_loc, self.n_districts_loc, \
            self.n_cust_loc
        w_glob = me + p * ar(n_wh)
        fill_columns(tab("WAREHOUSE", n_wh), n_wh, {
            "W_ID": w_glob,
            "W_TAX": _rand01(w_glob, 7) * f02,      # URand(0,.2) (init_wh)
            "W_YTD": torch.full((n_wh,), 300000.0, device=dev)})

        dl = ar(n_dist)
        d_w = me + p * (dl // self.n_dist)
        d_id = dl % self.n_dist
        fill_columns(tab("DISTRICT", n_dist), n_dist, {
            "D_ID": d_id,
            "D_W_ID": d_w,
            "D_TAX": _rand01(d_w * self.n_dist + d_id, 11) * f02,
            "D_YTD": torch.full((n_dist,), 30000.0, device=dev),
            "D_NEXT_O_ID": torch.full((n_dist,), 3001, dtype=torch.int32,
                                      device=dev)})

        cl = ar(n_cust)
        c_local = cl % self.cust_per_dist
        c_d = (cl // self.cust_per_dist) % self.n_dist
        c_w = me + p * (cl // (self.cust_per_dist * self.n_dist))
        c_glob = (c_w * self.n_dist + c_d) * self.cust_per_dist + c_local
        fill_columns(tab("CUSTOMER", n_cust), n_cust, {
            "C_ID": c_local,
            "C_D_ID": c_d,
            "C_W_ID": c_w,
            "C_LAST": c_local % self.lastnames,
            "C_DISCOUNT": _rand01(c_glob, 13) * _f32(0.5, dev),
            "C_BALANCE": torch.full((n_cust,), -10.0, device=dev),
            "C_YTD_PAYMENT": torch.full((n_cust,), 10.0, device=dev),
            "C_PAYMENT_CNT": torch.ones(n_cust, dtype=torch.int32,
                                        device=dev)})

        i_ids = ar(self.max_items)
        fill_columns(tab("ITEM", self.max_items), self.max_items, {
            "I_ID": i_ids,
            "I_IM_ID": _mulmod(i_ids, 2654435761, 10000),
            "I_PRICE": 1 + _mulmod(i_ids, 48271, 100)})

        n_stock = self.n_stock_loc
        sl = ar(n_stock)
        s_i = sl % self.max_items
        s_w = me + p * (sl // self.max_items)
        fill_columns(tab("STOCK", n_stock), n_stock, {
            "S_I_ID": s_i,
            "S_W_ID": s_w,
            "S_QUANTITY": 10 + _mulmod(s_w * self.max_items + s_i, 69621,
                                       91),
            "S_REMOTE_CNT": torch.zeros(n_stock, dtype=torch.int32,
                                        device=dev)})

        cap = cfg.insert_table_cap
        tab("HISTORY", cap, ring=True)
        tab("ORDER", cap, ring=True)
        tab("NEW-ORDER", cap, ring=True)
        # lines wrap no earlier than their orders (<= ipt lines per order)
        tab("ORDER-LINE", cap * self.ipt, ring=True)

        if self.full_schema:
            # the extra columns of the fixed tables: deterministic
            # per-row hashes (spec-initialized counters stay zero)
            counts = {"WAREHOUSE": n_wh, "DISTRICT": n_dist,
                      "CUSTOMER": n_cust, "ITEM": self.max_items,
                      "STOCK": n_stock}
            for t, extras in _FULL_EXTRA.items():
                n = counts.get(t)
                if n is None:          # ring tables fill at insert time
                    continue
                ids = torch.arange(n, dtype=torch.int64, device=dev)
                for j, (cn, _ct, _sz) in enumerate(extras):
                    if cn in ("S_YTD", "S_ORDER_CNT", "C_DELIVERY_CNT"):
                        continue
                    v = (mul32(ids, 2654435761)
                         + (0x9E3779B9 * (j + 1) & MASK32)) & MASK32
                    db[t].columns[cn][:n] = v.to(torch.int32)
        d_parts = cfg.device_parts
        if d_parts > 1:
            # the owner-major layout of a mesh (``tpcc.py:444-456``):
            # warehouses are the ownership anchor (the reference's
            # wh_to_part node partition), rows per warehouse the anchor's
            # rows; ring tables keep one cursor per block; the read-only
            # ITEM stays whole for every shard
            db["ITEM"].mc_replicated = True
            for name, anchor_rows in (
                    ("WAREHOUSE", 1), ("DISTRICT", self.n_dist),
                    ("CUSTOMER", self.n_dist * self.cust_per_dist),
                    ("STOCK", self.max_items), ("HISTORY", 1),
                    ("ORDER", 1), ("NEW-ORDER", 1), ("ORDER-LINE", 1)):
                db[name] = to_mc_layout(db[name], d_parts, anchor_rows)
        if cfg.tpcc_order_index:
            # the dynamic ordered ORDER index (``tpcc.py:457-466``; the
            # reference's index_btree over inserted orders): empty, one
            # entry per committed NewOrder, merged each executed pass
            db["ORDER_IDX"] = DynamicSortedIndex.build(
                np.zeros(0, np.int32), np.zeros(0, np.int32),
                miss_slot=db["ORDER"].capacity, cap=cfg.insert_table_cap,
                device=dev)
        if cfg.audit:
            # the isolation audit's stamp tables (cc/base.audit_observe)
            from deneva_tpu_torch.cc.base import AUDIT_KEY, audit_init
            db[AUDIT_KEY] = audit_init(cfg, dev)
        return db

    def empty_query(self, n: int, device) -> TPCCQuery:
        """An all-zero query batch of ``n`` rows (the pool's initial
        contents, as the reference's zeros_like of a generated batch)."""
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        i = self.ipt
        return TPCCQuery(
            txn_type=z(n), w_id=z(n), d_id=z(n), c_id=z(n), c_w_id=z(n),
            c_d_id=z(n), h_amount=z(n, dtype=torch.float32), ol_cnt=z(n),
            items=z(n, i), item_valid=z(n, i, dtype=torch.bool),
            supply_w=z(n, i), quantity=z(n, i))

    # -- generation (tpcc_query.cpp:144-260) ----------------------------
    def generate_plain(self, rng: torch.Tensor, n: int) -> TPCCQuery:
        """Plain K19 (with the plain K14a probe), op for op from
        ``deneva_tpu/workloads/tpcc.py:470-530``."""
        cfg = self.cfg
        dev = rng.device
        ks = prng.split_plain(rng, 12)
        is_pay = prng.bernoulli(ks[0], cfg.perc_payment, (n,))
        w_id = prng.randint(ks[1], (n,), 0, self.n_wh)
        d_id = prng.randint(ks[2], (n,), 0, self.n_dist)

        # payment customer: remote (w', d') with prob 0.15
        remote = prng.bernoulli(ks[3], 0.15, (n,)) & (self.n_wh > 1)
        rw = prng.randint(ks[4], (n,), 0, max(self.n_wh - 1, 1))
        rw = torch.where(rw >= w_id, rw + 1, rw)          # != w_id
        c_w_id = torch.where(remote, rw, w_id)
        c_d_id = torch.where(remote,
                             prng.randint(ks[5], (n,), 0, self.n_dist),
                             d_id)

        # by-last-name 60%: the middle same-lastname customer
        by_last = prng.bernoulli(ks[6], 0.6, (n,))
        names = self.lastnames
        lastname = _nurand(ks[7], 255, names, (n,))
        if cfg.tpcc_by_last_index:
            mid = self._middle_of(self.last_idx.lookup_plain(
                ((c_w_id * self.n_dist + c_d_id) * names
                 + lastname).to(torch.int32)))
        else:
            per_name = self.cust_per_dist // names
            mid = lastname + names * (per_name // 2)
        c_direct = _nurand(ks[8], 1023, self.cust_per_dist, (n,))
        c_id = torch.where(by_last & is_pay, mid, c_direct)

        h_amount = _uniform_range(ks[9], (n,), 1.0, 5000.0)

        # new-order item list (tpcc_query.cpp:221-256)
        i = self.ipt
        ol_cnt = prng.randint(ks[10], (n,), 5, i + 1)
        ki, kq, kr, kw = prng.split_plain(ks[11], 4)
        items = _nurand(ki, 8191, self.max_items, (n, i))
        lane = torch.arange(i, device=dev)
        in_cnt = lane[None, :] < ol_cnt[:, None]
        # duplicates beyond the first occurrence are invalidated
        first = (items[:, :, None] == items[:, None, :]).to(
            torch.uint8).argmax(dim=1)
        item_valid = in_cnt & (first == lane[None, :])
        quantity = prng.randint(kq, (n, i), 1, 11)
        kr1, kr2 = prng.split_plain(kr, 2)
        rem_item = (prng.bernoulli(kr1, 0.01, (n, i))
                    & prng.bernoulli(kr2, cfg.mpr_neworder, (n, 1))
                    & (self.n_wh > 1))
        rsup = prng.randint(kw, (n, i), 0, max(self.n_wh - 1, 1))
        rsup = torch.where(rsup >= w_id[:, None], rsup + 1, rsup)
        supply_w = torch.where(rem_item, rsup, w_id[:, None])
        return TPCCQuery(
            txn_type=torch.where(is_pay, TPCC_PAYMENT,
                                 TPCC_NEW_ORDER).to(torch.int32),
            w_id=w_id, d_id=d_id, c_id=c_id.to(torch.int32), c_w_id=c_w_id,
            c_d_id=c_d_id, h_amount=h_amount, ol_cnt=ol_cnt, items=items,
            item_valid=item_valid, supply_w=supply_w, quantity=quantity)

    def generate_kernel(self, rng: torch.Tensor, n: int):
        """K19 alone: (queries, probe keys, use_mid).  With the CUSTOMER_
        LAST index, ``c_id`` holds the direct NURand customer and a lane
        with ``use_mid`` takes the middle customer of its probe key."""
        cfg, dev, i = self.cfg, rng.device, self.ipt
        if i > _MAX_KERNEL_ITEMS:
            raise ValueError(f"K19 takes max_items_per_txn <= "
                             f"{_MAX_KERNEL_ITEMS}, got {i}")
        kernels.check("rng", rng, torch.int64, (2,), dev)
        q = self.empty_query(n, dev)
        probe = torch.empty(n, dtype=torch.int32, device=dev)
        use_mid = torch.empty(n, dtype=torch.bool, device=dev)
        K19_GEN.launch(
            kernels.ptr(rng), n, i, self.n_wh, self.cust_per_dist,
            self.lastnames, self.max_items, np.float32(cfg.perc_payment),
            np.float32(cfg.mpr_neworder), int(cfg.tpcc_by_last_index),
            *[kernels.ptr(t) for t in (
                q.txn_type, q.w_id, q.d_id, q.c_id, q.c_w_id, q.c_d_id,
                q.h_amount, q.ol_cnt, q.items, q.item_valid, q.supply_w,
                q.quantity, probe, use_mid)], kernels.stream(rng))
        return q, probe, use_mid

    def generate(self, rng: torch.Tensor, n: int) -> TPCCQuery:
        """K19, then K14a and two glue ops for the by-last-name customer:
        ``n`` fresh queries from the raw key ``rng``."""
        if kernels.on_cpu(rng):
            return self.generate_plain(rng, n)
        q, probe, use_mid = self.generate_kernel(rng, n)
        if self.cfg.tpcc_by_last_index:
            mid = self._middle_of(self.last_idx.lookup(probe))
            q.c_id = torch.where(use_mid, mid, q.c_id)
        return q

    # -- RW-set planning (tpcc_txn.cpp state machines, declared up front)
    def plan(self, db, q: TPCCQuery) -> dict:
        """``deneva_tpu/workloads/tpcc.py:585``.  The warehouse, district
        and customer accesses are ``order_free`` (escrow: every write
        there is a scatter-add or the O_ID prefix sum, every read an
        immutable column); stock is a true read-modify-write."""
        cfg = self.cfg
        n = q.w_id.shape[0]
        dev = q.w_id.device
        a = cfg.max_accesses
        is_pay = q.txn_type == TPCC_PAYMENT
        i = self.ipt

        def zi():
            return torch.zeros((n, a), dtype=torch.int32, device=dev)

        def zb():
            return torch.zeros((n, a), dtype=torch.bool, device=dev)
        tables, keys, owner = zi(), zi(), zi()
        is_read, is_write, valid, order_free = zb(), zb(), zb(), zb()
        # 0: warehouse (payment W_YTD += / neworder reads W_TAX)
        tables[:, 0] = TID["WAREHOUSE"]
        keys[:, 0] = q.w_id
        is_write[:, 0] = is_pay & cfg.wh_update
        # 1: district (D_YTD += / D_NEXT_O_ID++)
        tables[:, 1] = TID["DISTRICT"]
        keys[:, 1] = self.dist_key(q.w_id, q.d_id)
        is_write[:, 1] = True
        # 2: customer (payment balance at (c_w, c_d) / neworder discount)
        tables[:, 2] = TID["CUSTOMER"]
        keys[:, 2] = torch.where(
            is_pay, self.cust_key(q.c_w_id, q.c_d_id, q.c_id),
            self.cust_key(q.w_id, q.d_id, q.c_id))
        is_write[:, 2] = is_pay
        is_read[:, :3] = True
        valid[:, :3] = True
        order_free[:, :3] = True
        # 3..3+I: stock rows (new_order_8); ITEM reads excluded
        iv = q.item_valid & ~is_pay[:, None]
        tables[:, 3:3 + i] = TID["STOCK"]
        keys[:, 3:3 + i] = self.stock_key(q.supply_w, q.items)
        is_read[:, 3:3 + i] = iv
        is_write[:, 3:3 + i] = iv
        valid[:, 3:3 + i] = iv
        p = self.n_parts
        if p > 1:
            # each access's owner (0 on one partition): its row's
            # warehouse's node (wh_to_part)
            owner[:, 0] = q.w_id % p
            owner[:, 1] = q.w_id % p
            owner[:, 2] = torch.where(is_pay, q.c_w_id, q.w_id) % p
            owner[:, 3:3 + i] = q.supply_w % p
        return dict(table_ids=tables, keys=keys, is_read=is_read,
                    is_write=is_write, valid=valid, order_free=order_free,
                    owner=owner)

    def re_execute(self, db, q: TPCCQuery, mask: torch.Tensor,
                   order: torch.Tensor, stats: dict):
        """Transaction repair's re-execution (``tpcc.py:654``): `execute` of
        the salvaged rows (K10 resolves the stock writers; under
        ``tpcc_order_index`` one more K14e merge).  Escrow deltas
        recompute from the query row and add once."""
        return self.execute(db, q, mask, order, stats)

    # -- execution ------------------------------------------------------
    def execute(self, db, q: TPCCQuery, mask: torch.Tensor,
                order: torch.Tensor, stats: dict, fwd_rank=None,
                level_exec: bool = False):
        """Apply the committed ``mask`` (``tpcc.py:677``); in place."""
        if fwd_rank is not None:
            raise ValueError("TPC-C has no forwarding executor")
        is_pay = q.txn_type == TPCC_PAYMENT
        self._exec_payment(db, q, mask & is_pay, stats)
        self._exec_neworder(db, q, mask & ~is_pay, order, stats, level_exec)
        return db

    def _exec_payment(self, db, q: TPCCQuery, m: torch.Tensor, stats):
        """run_payment_0..5 (``tpcc.py:692``): YTD / balance updates are
        commutative, so K14c applies them exactly, the three tables in one
        launch; the HISTORY row goes through K14d."""
        amt = torch.where(m, q.h_amount, 0.0)
        adds = [(db["DISTRICT"], self.dist_slot(q.w_id, q.d_id),
                 {"D_YTD": amt}),
                (db["CUSTOMER"], self.cust_slot(q.c_w_id, q.c_d_id, q.c_id),
                 {"C_BALANCE": -amt, "C_YTD_PAYMENT": amt,
                  "C_PAYMENT_CNT": m.to(torch.int32)})]
        if self.cfg.wh_update:
            adds.insert(0, (db["WAREHOUSE"], self.wh_slot(q.w_id),
                            {"W_YTD": amt}))
        table.scatter_add_many(adds, mask=m)
        hist_row = {"H_C_ID": q.c_id, "H_C_D_ID": q.c_d_id,
                    "H_C_W_ID": q.c_w_id, "H_D_ID": q.d_id,
                    "H_W_ID": q.w_id, "H_AMOUNT": q.h_amount}
        if self.full_schema:
            hist_row["H_DATE"] = torch.full_like(q.c_id, 2013)
            hist_row["H_DATA"] = mul32(u32(q.c_id), 0x9E3779B9).to(
                torch.int32)
        # the HISTORY row at the home warehouse's owner only
        db["HISTORY"].append(hist_row, self._at_home(m, q.w_id),
                             anchor=q.w_id)
        # W_YTD + D_YTD + 3 customer cols + HISTORY row per payment
        _acc(stats, "write_cnt", m.sum() * 6)

    def _order_rank(self, m: torch.Tensor, dk: torch.Tensor,
                    order: torch.Tensor) -> torch.Tensor:
        """Each committed NewOrder's rank among its district's committed
        NewOrders in serialization order (``tpcc.py:752-764``): stable
        sorts, as ``jnp.argsort`` is stable."""
        n = m.shape[0]
        dev = m.device
        seg = torch.where(m, dk, self.n_districts).to(torch.int32)
        big = torch.full_like(order, 2**31 - 1)
        key = torch.where(m, order, big)
        first = torch.argsort(key, stable=True)
        order_rank = torch.argsort(first, stable=True)
        sort_key = seg * (2 * n) + order_rank.to(torch.int32)
        perm = torch.argsort(sort_key, stable=True)
        sorted_seg = seg[perm]
        new_segment = torch.ones(n, dtype=torch.bool, device=dev)
        new_segment[1:] = sorted_seg[1:] != sorted_seg[:-1]
        lane = torch.arange(n, dtype=torch.int64, device=dev)
        pos = lane - torch.cummax(torch.where(new_segment, lane, 0),
                                  0).values
        rank = torch.zeros(n, dtype=torch.int32, device=dev)
        rank[perm] = pos.to(torch.int32)
        return rank

    def _exec_neworder(self, db, q: TPCCQuery, m: torch.Tensor,
                       order: torch.Tensor, stats, level_exec: bool):
        """new_order_0..9 (``tpcc.py:724``): O_ID = D_NEXT_O_ID + the
        rank among the district's committed NewOrders; the stock rule;
        the ORDER, NEW-ORDER and ORDER-LINE rows."""
        n = q.w_id.shape[0]
        dev = q.w_id.device
        dist = db["DISTRICT"]
        dk = self.dist_key(q.w_id, q.d_id)
        dslot = self.dist_slot(q.w_id, q.d_id)

        # taxes / discount reads feed the checksum; D_NEXT_O_ID is
        # gathered before its scatter-add below
        w_tax = db["WAREHOUSE"].gather(self.wh_slot(q.w_id),
                                       ("W_TAX",))["W_TAX"]
        d = dist.gather(dslot, ("D_TAX", "D_NEXT_O_ID"))
        c_disc = db["CUSTOMER"].gather(
            self.cust_slot(q.w_id, q.d_id, q.c_id),
            ("C_DISCOUNT",))["C_DISCOUNT"]
        # per-lane uint32 cast before the sum: two float roundings (the
        # sum of three, then * 1000), then truncation
        lanes = torch.where(m, (w_tax + d["D_TAX"] + c_disc) * 1000, 0.0)
        _acc(stats, "read_checksum", lanes.to(torch.int64).sum())

        o_id = d["D_NEXT_O_ID"] + self._order_rank(m, dk, order)
        dist.scatter_add(dslot, {"D_NEXT_O_ID": m.to(torch.int32)}, mask=m)

        # stock update (new_order_8): gather, the quantity rule, the
        # final writer's scatter; S_REMOTE_CNT adds
        i = self.ipt
        iv = (q.item_valid & m[:, None]).reshape(-1)
        sk = self.stock_slot(q.supply_w, q.items).reshape(-1).to(
            torch.int32)
        qty = q.quantity.reshape(-1)
        stock = db["STOCK"]
        s_q = stock.gather(sk, ("S_QUANTITY",))["S_QUANTITY"]
        # strict: replenish at s_q - qty <= 10 (tpcc_txn.cpp new_order_8/9)
        new_q = torch.where(s_q - qty > 10, s_q - qty, s_q - qty + 91)
        if level_exec:
            # a chained level's committed set is stock-conflict-free and
            # item_valid dedups in-txn items: every valid lane is final
            win = iv
        else:
            worder = order[:, None].expand(n, i).reshape(-1).contiguous()
            win = scatter.last_writer(
                torch.where(iv, sk, stock.capacity).to(torch.int32),
                worder, iv, stock.capacity)
        stock.scatter(sk, {"S_QUANTITY": new_q}, mask=win)
        remote = (q.supply_w != q.w_id[:, None]).reshape(-1)
        adds = {"S_REMOTE_CNT": (iv & remote).to(torch.int32)}
        if self.full_schema:
            adds["S_YTD"] = torch.where(iv, qty, 0)
            adds["S_ORDER_CNT"] = iv.to(torch.int32)
        stock.scatter_add(sk, adds, mask=iv)

        # inserts: ORDER, NEW-ORDER, ORDER-LINE (new_order_1 / _3 / _9)
        # at the home warehouse's owner only
        m_ins = self._at_home(m, q.w_id)
        all_local = (~q.item_valid | (q.supply_w == q.w_id[:, None])).all(
            dim=1)
        order_row = {"O_ID": o_id, "O_C_ID": q.c_id, "O_D_ID": q.d_id,
                     "O_W_ID": q.w_id,
                     "O_ENTRY_D": torch.full_like(q.w_id, 2013),
                     "O_OL_CNT": q.ol_cnt,
                     "O_ALL_LOCAL": all_local.to(torch.int32)}
        if self.full_schema:
            order_row["O_CARRIER_ID"] = torch.zeros_like(q.w_id)
        _, oslots = db["ORDER"].append(order_row, m_ins, anchor=q.w_id)
        if "ORDER_IDX" in db:
            # the epoch's (or the level's) orders merge into the index
            db["ORDER_IDX"] = db["ORDER_IDX"].insert(
                self.order_index_key(q.w_id, q.d_id, o_id), oslots, m_ins)
        db["NEW-ORDER"].append(
            {"NO_O_ID": o_id, "NO_D_ID": q.d_id, "NO_W_ID": q.w_id}, m_ins,
            anchor=q.w_id)
        ol_m = (q.item_valid & m_ins[:, None]).reshape(-1)

        def bcast(x):
            return x[:, None].expand(n, i).reshape(-1)
        ol_row = {"OL_O_ID": bcast(o_id), "OL_D_ID": bcast(q.d_id),
                  "OL_W_ID": bcast(q.w_id),
                  "OL_NUMBER": torch.arange(
                      i, dtype=torch.int32, device=dev).repeat(n),
                  "OL_I_ID": q.items.reshape(-1),
                  "OL_QUANTITY": q.quantity.reshape(-1)}
        if self.full_schema:
            price = db["ITEM"].columns["I_PRICE"][
                torch.clamp(q.items, 0, self.max_items - 1).long()
            ].reshape(-1)
            ol_row["OL_SUPPLY_W_ID"] = q.supply_w.reshape(-1)
            ol_row["OL_DELIVERY_D"] = torch.zeros(n * i, dtype=torch.int32,
                                                  device=dev)
            ol_row["OL_AMOUNT"] = (q.quantity.reshape(-1) * price).to(
                torch.float32)
            ol_row["OL_DIST_INFO"] = mul32(u32(q.items.reshape(-1)),
                                           2654435761).to(torch.int32)
        db["ORDER-LINE"].append(ol_row, ol_m, anchor=bcast(q.w_id))
        _acc(stats, "write_cnt", iv.sum() + m.sum() * 2)


def _acc(stats: dict, key: str, delta) -> None:
    stats[key] = (stats[key] + delta) & MASK32


def _rand01(ids: torch.Tensor, salt: int) -> torch.Tensor:
    """Deterministic per-row uniform [0,1) for loader columns
    (``tpcc.py:847``): a uint32 hash split so each half converts to
    float32 exactly, one rounding at the add."""
    h = (mul32(u32(ids), 0x7F4A7C15) + salt) & MASK32
    hi = (h >> 8).to(torch.float32) * 2.0 ** -24
    lo = (h & 0xFF).to(torch.float32) * 2.0 ** -32
    return hi + lo


def _mulmod(ids: torch.Tensor, mul: int, mod: int) -> torch.Tensor:
    """(ids * mul) % mod over uint32 ids (``tpcc.py:859``)."""
    return ((u32(ids) % mod) * (mul % mod) % mod).to(torch.int32)
