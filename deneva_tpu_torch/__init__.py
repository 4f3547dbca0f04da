"""deneva_tpu_torch — the PyTorch + CUDA port of ``deneva_tpu``.

A second package beside the JAX one, with the same layout and names, so
each module's counterpart sits at the same path.  It imports ``torch``
and numpy, never JAX and nothing of ``deneva_tpu``.  Entry points run on
CUDA unless the caller passes ``device="cpu"``; asking for CUDA where
there is none raises.

The ported slices, on one node and one device (``part_cnt > 1``: node
``node_id``'s striped partition), over a full or a partial pool: YCSB, TPC-C (Payment + NewOrder, with or without the
dynamic ORDER index of ``tpcc_order_index``) and PPS, under
``CC_ALG=TPU_BATCH`` and ``CALVIN`` (YCSB through the single-pass
forwarding executor, TPC-C and PPS through the chained executor),
``OCC``, ``NO_WAIT`` and ``WAIT_DIE`` (four isolation levels),
``TIMESTAMP``, ``MVCC``, ``MAAT`` and the NOCC oracle (the sweep path),
with ``mode=SIMPLE`` / ``QRY_ONLY``.  Their device work runs in
hand-written CUDA kernels for ``sm_90a`` (``csrc/``):

* K1 — the (key, rank) lane sort           (`ops.forward.sort_lanes`)
* K2 — the forwarding scans                (`ops.forward.plan_scans`)
* K3 — the forward-execute gather/scatter  (`workloads.ycsb._forward_execute_f0`)
* K4 — threefry split + YCSB generation    (`ops.prng.split`,
  `workloads.ycsb.YCSBWorkload.generate`)
* K5+K6 — key hashing + incidence rows     (`ops.conflict.hashed_incidence`)
* K7 — the overlap product                 (`ops.conflict.overlap`)
* K8 — the first-fit sweep                 (`ops.conflict.first_fit`)
* K9a, K9b — wavefront and precedence levels
  (`ops.conflict.wavefront`, `ops.conflict.precedence_levels`)
* K10 — last-writer resolution             (`ops.scatter.last_writer`)
* K11a, K11b — MAAT's closure and peel     (`cc.maat.reach_stats`,
  `cc.maat.peel`)
* K12a, K12b — T/O watermark check and commit
  (`cc.timestamp._watermark_check`, `cc.timestamp._commit_watermarks`)
* K12c, K12d — MVCC's version ring: versioned read, push
  (`workloads.ycsb._versioned_read_f0`, `storage.table.VersionRing.push`)
* K14a, K14b — hash and sorted index probes
  (`storage.index.HashIndex.lookup`, `storage.index.SortedIndex.lookup`)
* K14c, K14d — escrow scatter-add, ring append
  (`storage.table.DeviceTable.scatter_add`, `scatter_add_many`,
  `DeviceTable.append`)
* K14e — the dynamic index's merge and its count / range probes
  (`storage.index.DynamicSortedIndex.insert`,
  `SortedIndex.lookup_count`, `range_slots`, `range_between`)
* K19 — TPC-C generation                   (`workloads.tpcc.TPCCWorkload.generate`)
* K20 — PPS generation                     (`workloads.pps.PPSWorkload.generate`)
* K21 — the router's cross-group defer     (`cc.router.cross_group_defer`)

and the planes' kernels (K13a-b, K15a-c, K16, K17, K18a-b) named in
their modules.  Under ``ctrl`` the contention router routes each epoch
(`cc.router`, `runtime.controller`).

Library surface, as the reference's:
``Config.from_args([...])`` -> ``engine.driver.run_simulation(cfg)`` ->
``Stats.summary_line()``.

Package map (mirrors ``deneva_tpu``):

* `config`    — runtime flags (the slice's fields; others raise)
* `storage`   — catalog, tables, version ring and indexes, device-resident
* `ops`       — threefry stream, zipfian sampling, forwarding plan,
  hashing, conflict incidence and sweep, last-writer resolution
* `cc`        — the backend registry (TPU_BATCH, CALVIN, OCC, NO_WAIT,
  WAIT_DIE, TIMESTAMP, MVCC, MAAT, DGCC, NOCC), incidence, the router
* `runtime`   — the control plane's controller
* `workloads` — YCSB, TPC-C, PPS
* `engine`    — pool, epoch step, run driver
* `stats`     — counters, percentile arrays, [summary] emitter
* `convert`   — state carried across from / to the reference
* `kernels`   — nvcc build + ctypes binding of ``csrc/*.cu``
"""

__version__ = "0.1.0"

from deneva_tpu_torch.config import CCAlg, Config, Mode, WorkloadKind  # noqa: F401
