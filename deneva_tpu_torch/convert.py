"""Carry engine state between ``deneva_tpu`` and the port, as numpy.

`from_reference_state` builds the port's `EngineState` from the
reference package's ``EngineState`` after ``jax.device_get`` (so every
leaf is a numpy array; the caller does the ``device_get`` and this module
never imports JAX).  `to_numpy_state` and `flatten_reference` give both
packages' states as one flat ``{path: ndarray}`` map in the reference's
dtypes, for leaf-by-leaf comparison:

    db/<table>/<column>, db/<table>/row_cnt, db/<ring>/wts,
    cc_state/<field>, pool/queries/<field>, pool/<field>, rng, epoch,
    stats/<counter>

``db/<ring>/wts`` is MVCC's per-row `VersionRing`, ``db/ORDER_IDX/{keys,
slots,cnt}`` TPC-C's `DynamicSortedIndex` under ``tpcc_order_index``,
``db/__audit__/{epoch,writer}`` (and under MVCC ``vts``, ``vepoch``,
``vwriter``, ``vpos``) the audit stamp tables under ``audit``;
``cc_state`` holds the
T/O watermarks (``rts``, ``wts``) and MVCC's boundary ring (``his``,
``pos``), absent for stateless backends (OCC, 2PL, MAAT, CALVIN,
TPU_BATCH and NOCC carry ``()``).  Under ``device_parts > 1`` a stacked
table's columns are in the owner-major layout and its ``row_cnt`` holds
one cursor per block, in both packages alike; `from_reference_state`
carries ``mc_parts``, ``anchor_rows`` and ``mc_replicated``.

The pool's queries are the workload's: ``YCSBQuery``, ``TPCCQuery`` or
``PPSQuery``,
chosen by ``cfg.workload``, with every field of the reference's query
carried under its name.  Ring tables (TPC-C's HISTORY, ORDER, NEW-ORDER,
ORDER-LINE) keep their free-running ``row_cnt``.

`index_from_reference` carries a workload's primary index, whose arrays
live on the workload and not in the state: the reference's
``SortedIndex`` keys and slots, or its ``DenseIndex`` parameters.
TPC-C's CUSTOMER_LAST index also lives on the workload; the port
rebuilds it from numpy (`workloads.tpcc.TPCCWorkload`).

Under ``part_cnt > 1`` a table holds node ``node_id``'s ``n_local`` rows
(then its trash row and pad rows) and ``stats/conflict_density`` one
count per partition; both cross as they are.  The reference's trash
rows hold what its stores left there and the port's stores write
nothing there, so a comparison of the two takes rows ``[0, capacity)``.

uint32 leaves cross as int32 bit patterns (table columns) or int64
values (rng, counters), as the port holds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deneva_tpu_torch.cc.base import AUDIT_KEY
from deneva_tpu_torch.cc.timestamp import MVCCState, TOState
from deneva_tpu_torch.engine.pool import PoolState
from deneva_tpu_torch.engine.step import EngineState
from deneva_tpu_torch.storage.index import (DenseIndex, DynamicSortedIndex,
                                            SortedIndex)
from deneva_tpu_torch.storage.table import (DeviceTable, VersionRing,
                                            to_numpy_column)

POOL_FIELDS = ("ts", "seq", "abort_cnt", "defer_cnt", "ready_epoch",
               "entry_epoch", "occupied", "next_seq")
QUERY_FIELDS = ("keys", "is_write")      # YCSBQuery's
CC_FIELDS = ("rts", "wts", "his", "pos")
INDEX_FIELDS = ("keys", "slots", "cnt")   # a DynamicSortedIndex's leaves


def _is_index(entry) -> bool:
    """A db entry that is a `DynamicSortedIndex` (of either package)."""
    return hasattr(entry, "cnt") and hasattr(entry, "slots")


def _db_and_cc(db, cc_state, leaf) -> dict:
    """The ``db/`` and ``cc_state/`` paths of either package's state."""
    out = {}
    for name, tab in db.items():
        if name == AUDIT_KEY:                     # the audit stamp tables
            for f, arr in tab.items():
                out[f"db/{name}/{f}"] = leaf(arr)
            continue
        if _is_index(tab):
            for f in INDEX_FIELDS:
                out[f"db/{name}/{f}"] = leaf(getattr(tab, f))
            continue
        if not hasattr(tab, "columns"):          # a VersionRing
            out[f"db/{name}/wts"] = leaf(tab.wts)
            continue
        for col, arr in tab.columns.items():
            out[f"db/{name}/{col}"] = leaf(arr)
        out[f"db/{name}/row_cnt"] = leaf(tab.row_cnt)
    for f in CC_FIELDS:
        if hasattr(cc_state, f):
            out[f"cc_state/{f}"] = leaf(getattr(cc_state, f))
    return out


def _query_fields(q) -> tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(q))


def flatten_reference(tree) -> dict[str, np.ndarray]:
    """The reference's host ``EngineState`` as a flat numpy map."""
    out = _db_and_cc(tree.db, tree.cc_state, np.asarray)
    for f in _query_fields(tree.pool.queries):
        out[f"pool/queries/{f}"] = np.asarray(getattr(tree.pool.queries, f))
    for f in POOL_FIELDS:
        out[f"pool/{f}"] = np.asarray(getattr(tree.pool, f))
    out["rng"] = np.asarray(tree.rng)
    out["epoch"] = np.asarray(tree.epoch)
    for k, v in tree.stats.items():
        out[f"stats/{k}"] = np.asarray(v)
    return out


def state_leaves(state: EngineState) -> dict[str, torch.Tensor]:
    """The port's state as a flat map of its own tensors (same paths as
    `to_numpy_state`), for comparisons that stay on the device."""
    out = _db_and_cc(state.db, state.cc_state, lambda t: t)
    for f in _query_fields(state.pool.queries):
        out[f"pool/queries/{f}"] = getattr(state.pool.queries, f)
    for f in POOL_FIELDS:
        out[f"pool/{f}"] = getattr(state.pool, f)
    out["rng"] = state.rng
    out["epoch"] = state.epoch
    for k, v in state.stats.items():
        out[f"stats/{k}"] = v
    return out


def to_numpy_state(state: EngineState) -> dict[str, np.ndarray]:
    """The port's state as the same flat map, in the reference's dtypes."""
    ref = {f"db/{name}/{col}": d for name, tab in state.db.items()
           if isinstance(tab, DeviceTable)
           for col, d in tab.ref_dtypes.items()}
    out = {}
    for path, t in state_leaves(state).items():
        a = t.detach().cpu().numpy()
        if path in ref:
            a = to_numpy_column(t, ref[path])
        elif path == "rng" or path.startswith("stats/"):
            a = a.astype(np.uint32)
        out[path] = a
    return out


def _t(a, device, wide: bool = False) -> torch.Tensor:
    """numpy -> torch; uint32 becomes int32 bit patterns, or int64
    values when ``wide``."""
    a = np.array(a, order="C")
    if a.dtype == np.uint32:
        a = a.astype(np.int64) if wide else a.view(np.int32)
    return torch.from_numpy(a).to(device)


def from_reference_state(tree, cfg, device) -> EngineState:
    """The port's `EngineState` from the reference's host state: table
    columns, ``row_cnt``, MVCC's version ring, the ORDER index, the audit
    stamp tables, the T/O state, every pool field, the raw rng key,
    ``epoch`` and every stats leaf."""
    device = torch.device(device)
    db = {}
    for name, tab in tree.db.items():
        if name == AUDIT_KEY:
            db[name] = {f: _t(arr, device) for f, arr in tab.items()}
            continue
        if _is_index(tab):
            db[name] = DynamicSortedIndex(
                **{f: _t(getattr(tab, f), device) for f in INDEX_FIELDS},
                cap=int(tab.cap), miss_slot=int(tab.miss_slot))
            continue
        if not hasattr(tab, "columns"):
            db[name] = VersionRing(wts=_t(tab.wts, device),
                                   depth=int(tab.depth))
            continue
        cols, ref = {}, {}
        for col, arr in tab.columns.items():
            arr = np.asarray(arr)
            cols[col] = _t(arr, device)
            ref[col] = str(arr.dtype)
        db[name] = DeviceTable(
            columns=cols, row_cnt=_t(tab.row_cnt, device), name=tab.name,
            capacity=int(tab.capacity), full_row=bool(tab.full_row),
            ref_dtypes=ref, ring=bool(getattr(tab, "ring", False)),
            mc_parts=int(getattr(tab, "mc_parts", 1)),
            anchor_rows=int(getattr(tab, "anchor_rows", 1)),
            mc_replicated=bool(getattr(tab, "mc_replicated", False)),
            striped=cfg.part_cnt > 1)
    q = tree.pool.queries
    pool = PoolState(
        queries=_query_class(cfg)(**{f: _t(getattr(q, f), device)
                                     for f in _query_fields(q)}),
        **{f: _t(getattr(tree.pool, f), device) for f in POOL_FIELDS})
    lead = getattr(pool.queries, _query_fields(q)[0]).shape[0]
    if lead != max(cfg.epoch_batch, cfg.max_txn_in_flight):
        raise ValueError("reference state's pool does not match cfg")
    cs = tree.cc_state
    if hasattr(cs, "his"):
        cc_state = MVCCState(**{f: _t(getattr(cs, f), device)
                                for f in CC_FIELDS},
                             scratch=torch.zeros_like(_t(cs.wts, device)))
    elif hasattr(cs, "rts"):
        cc_state = TOState(rts=_t(cs.rts, device), wts=_t(cs.wts, device))
    else:
        cc_state = ()
    return EngineState(
        db=db, cc_state=cc_state, pool=pool,
        rng=_t(tree.rng, device, wide=True),
        epoch=_t(tree.epoch, device),
        stats={k: _t(v, device, wide=True) for k, v in tree.stats.items()})


def _query_class(cfg):
    """The port's query batch type of ``cfg.workload``."""
    from deneva_tpu_torch.config import WorkloadKind
    if cfg.workload == WorkloadKind.TPCC:
        from deneva_tpu_torch.workloads.tpcc import TPCCQuery
        return TPCCQuery
    if cfg.workload == WorkloadKind.PPS:
        from deneva_tpu_torch.workloads.pps import PPSQuery
        return PPSQuery
    from deneva_tpu_torch.workloads.ycsb import YCSBQuery
    return YCSBQuery


def index_from_reference(index, device):
    """The port's copy of a reference ``DenseIndex`` or ``SortedIndex``
    (after ``jax.device_get``): the sorted arrays are taken as they are,
    already in the reference's stable order."""
    if hasattr(index, "keys"):
        return SortedIndex(keys=_t(index.keys, device),
                           slots=_t(index.slots, device), n=int(index.n),
                           miss_slot=int(index.miss_slot))
    return DenseIndex(base=int(index.base), stride=int(index.stride),
                      size=int(index.size), miss_slot=int(index.miss_slot))
