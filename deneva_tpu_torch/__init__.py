"""deneva_tpu_torch — the PyTorch + CUDA port of ``deneva_tpu``.

A second package beside the JAX one, with the same layout and names, so
each module's counterpart sits at the same path.  It imports ``torch``
and numpy, never JAX and nothing of ``deneva_tpu``.  Entry points run on
CUDA unless the caller passes ``device="cpu"``; asking for CUDA where
there is none raises.

The ported slices: YCSB on one partition and one device, over a full
or a partial pool — ``CC_ALG=TPU_BATCH`` and ``CALVIN`` through the
single-pass forwarding executor; ``OCC``, ``NO_WAIT`` and ``WAIT_DIE``
(four isolation levels), ``TIMESTAMP`` and ``MVCC`` and the NOCC oracle
through the sweep path.  Their device work runs in hand-written CUDA
kernels for ``sm_90a`` (``csrc/``):

* K1 — the (key, rank) lane sort           (`ops.forward.sort_lanes`)
* K2 — the forwarding scans                (`ops.forward.plan_scans`)
* K3 — the forward-execute gather/scatter  (`workloads.ycsb._forward_execute_f0`)
* K4 — threefry split + query generation   (`ops.prng.split`,
  `workloads.ycsb.YCSBWorkload.generate`)
* K5+K6 — key hashing + incidence rows     (`ops.conflict.hashed_incidence`)
* K7 — the overlap product                 (`ops.conflict.overlap`)
* K8 — the first-fit sweep                 (`ops.conflict.first_fit`)
* K10 — last-writer resolution             (`ops.scatter.last_writer`)
* K12a, K12b — T/O watermark check and commit
  (`cc.timestamp._watermark_check`, `cc.timestamp._commit_watermarks`)
* K12c, K12d — MVCC's version ring: versioned read, push
  (`workloads.ycsb._versioned_read_f0`, `storage.table.VersionRing.push`)

Library surface, as the reference's:
``Config.from_args([...])`` -> ``engine.driver.run_simulation(cfg)`` ->
``Stats.summary_line()``.

Package map (mirrors ``deneva_tpu``):

* `config`    — runtime flags (the slice's fields; others raise)
* `storage`   — catalog / tables / dense index, device-resident
* `ops`       — threefry stream, zipfian sampling, forwarding plan,
  hashing, conflict incidence and sweep, last-writer resolution
* `cc`        — the backend registry (TPU_BATCH, CALVIN, OCC, NO_WAIT,
  WAIT_DIE, TIMESTAMP, MVCC, NOCC), incidence
* `workloads` — YCSB
* `engine`    — pool, epoch step, run driver
* `stats`     — counters, percentile arrays, [summary] emitter
* `convert`   — state carried across from / to the reference
* `kernels`   — nvcc build + ctypes binding of ``csrc/*.cu``
"""

__version__ = "0.1.0"

from deneva_tpu_torch.config import CCAlg, Config, Mode, WorkloadKind  # noqa: F401
