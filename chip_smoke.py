#!/usr/bin/env python3
"""Drive deneva_tpu_torch on one NVIDIA card and hold every kernel to its plain version.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

The deployment is YCSB at the Deneva paper's per-node scale and width:
2^24 rows (Deneva's ``2097152*8`` rows per node, ``Config``'s default),
10 requests per txn, 50% writes, zipf theta 0.9, one partition, in two
table modes: fingerprint (ten uint32 columns, 0.67 GB) and full row
(``sim_full_row``: ten 100-byte fields, 16.8 GB on the card).  These
paths drive it:

* forwarding — ``CC_ALG=TPU_BATCH`` with ``epoch_batch =
  max_txn_in_flight = 65536`` (K1-K4);
* sweep — ``bench.py``'s OCC comparator: ``CC_ALG=OCC`` (and the NOCC
  oracle) at ``epoch_batch=1024`` over a partial pool of
  ``max_txn_in_flight=100000``, ``conflict_buckets=8192``, dual hashing
  (K4, K5+K6, K7, K8, K10);
* lock and T/O — the paper's ``ycsb_skew`` point (``paper_base`` of
  ``deneva_tpu/harness/experiments.py`` at theta 0.9):
  ``epoch_batch=2048`` over a partial pool of ``max_txn_in_flight=
  10000``, ``conflict_buckets=8192``, dual hashing, ``watermark_buckets
  = 2^20``, ``mvcc_his_len=4``, under ``NO_WAIT`` and ``WAIT_DIE`` (K4,
  K5+K6, K7, K8, K10), ``TIMESTAMP`` (and K12a, K12b) and ``MVCC`` (and
  K12c, K12d), and ``CALVIN`` (the forwarding path, K1-K4);
* MAAT — at the ``ycsb_skew`` point and at the ``ycsb_hot`` sweep's
  hottest point (HOT keys: 100 hot keys take 90% of the accesses): K4,
  K5+K6, K7, K8, the level gate K9b, the closure K11a (twice) and the
  peel K11b, K10;
* modes — the ``modes`` experiment: TPU_BATCH at the ``paper_base``
  settings, theta 0.6, under ``mode=SIMPLE`` and ``QRY_ONLY``
  (validation through the wavefront levels K9a, no execution);
* ordered index — the forwarding path with ``index_struct=IDX_BTREE``
  (K1-K4 and the sorted-index probe K14b);
* TPC-C — Payment + NewOrder at the ``tpcc_scaling`` point of 64
  warehouses (``paper_base`` with ``max_accesses=32`` and the reference's
  TPC-C defaults: 1.92 M customers, 6.4 M stock rows, nothing cut) under
  TPU_BATCH, and at the ``tpcc_escrow`` point of 4 warehouses under
  TPU_BATCH, CALVIN, NO_WAIT, OCC and MVCC: generation K4a, K19 and the
  CUSTOMER_LAST probe K14a; the escrow adds K14c and ring appends K14d,
  four passes of them through the chained executor (TPU_BATCH, CALVIN,
  with K5+K6, K7, K9a) or one on the sweep path (with K8, K10, K12a-b);
  every algorithm at 4 warehouses, and ``tpcc_order_index``'s cells
  (TPU_BATCH and CALVIN at 4, 16 and 64 warehouses, the dynamic ORDER
  index of 2^20 entries off and on: K14e's merge once per executed
  pass);
* PPS — the ``pps_scaling`` point at Deneva's own scale (10,000 parts,
  1,000 products, 1,000 suppliers, 10 parts per product, the default
  mix) under all eight algorithms, and ``escrow_ablation``'s PPS cells:
  generation K4a and K20, the PART_AMOUNT escrow adds K14c, the PRODUCTS
  writers' K10 on the sweep path;
* transaction repair — ``repair_ablation``'s YCSB half (``paper_base``
  at theta 0.9 with 90% writes) under all six sweep backends with
  ``repair_rounds=2`` (OCC and MAAT also off and at 0 and 1; K13a once a
  sub-round, each sub-round re-running the backend's kernels and K10),
  and its TPC-C half at 4 warehouses, escrow off, under OCC;
* DGCC — ``dgcc_contention``'s cells (the same base at theta 0, 0.6,
  0.9 and 0.99, and at 30% writes) and TPC-C at 4 warehouses: the lane
  sort K15a, its census K15b and the wave relaxation K16, then 32
  chained passes through K10;
* the metrics and audit planes — ``--metrics=true`` (the conflict
  density K13b) and ``--audit=true`` with the reference's 2^16 audit
  buckets and 4,096-edge cap (K17's lane build, K15a at the audit's
  positions, K15c's scans and compaction, K17's stamp pass): OCC, MVCC
  and CALVIN at ``ycsb_skew``, TPU_BATCH at TPC-C 4 warehouses, DGCC at
  theta 0.9 and OCC at ``repair_ablation`` rounds 2, at
  ``audit_cadence`` 1 (OCC and CALVIN also at the default 8), OCC with
  ``audit_mutate``, and the metrics alone on the forwarding main path;
* the mesh (``device_parts``) — the forwarding main path at 2^27 rows
  (the paper's 2^24 per node, 8 nodes) over 1, 2, 4 and 8 shards, all
  on the one card: the sharded plan's capacity rule K18a and owner
  blocks K18b, then K1-K3 per shard; ``mesh_scaling``'s cells; TPC-C
  at 64 warehouses and PPS over 8 shards through each shard's executor.
  The shards share one card, so no number here is a multi-GPU one;
* partitioned keyspaces and the router (``part_cnt = 4``, node 0's
  striped view) — YCSB over 2^26 keys (node 0 stores the paper's 2^24
  rows; forwarding in both table modes, OCC and MVCC at ``ycsb_skew``),
  TPC-C at 64 warehouses (16 local) and PPS at ``pps_scaling``; the
  router's cell (the ``ycsb_skew`` shape at theta 0.6 over 2^26 keys,
  2^18 buckets, metrics, audit at cadence 1, repair rounds 2, ``ctrl``)
  under static knobs, the mixed assignment [0, 1, 2, 2] (K21, the
  cross-group defer) and ``ctrl_dgcc``'s [0, 1, 2, 3], and
  ``run_simulation`` with the controller armed.

Phases (any error or mismatch exits non-zero and prints no result):

1. device    — card name, count, ``nvidia-smi`` name and power limit.
2. build     — nvcc builds every kernel from ``deneva_tpu_torch/csrc``;
               prints the ``-Xptxas -v`` register / shared-memory lines.
3. kernels   — each kernel against its plain PyTorch version on the card,
               exactly, at its path's shapes: K1-K4 at N = 655,360 lanes
               and 2^24 rows (K3 in both modes); K5+K6, K7, K8 at B =
               1024 generated zipf-0.9 txns and K = 8192 (K7 also at the
               sweep backends' B = 2048, both against two
               ``torch.matmul``), K10 over the
               committed write lanes of the comparator's epoch and of a
               ``ycsb_skew`` epoch (20,480 lanes, its own row) and once
               at N >= capacity.  Times by
               CUDA events, beside the plain version's, the bound and a
               one-call PyTorch yardstick where there is one.
               K12a-d at the ``ycsb_skew`` shapes (B = 2048 txns x 10
               accesses, 2^20 watermark buckets, H = 4, 2^24 rows; K12c
               in both table modes) on the state and batch of a real
               MVCC epoch after ten warm-up epochs (watermark aborts,
               stale reads served from the ring and ring wrap-arounds
               occur there).  K9a on a ``modes`` epoch's conflicts.
               MAAT at ``ycsb_skew`` and at ``ycsb_hot``, one engine
               each: epoch 4 must take the closure branch and is held to
               the MAAT oracle (P from the numpy buckets, no committed
               mutual pair, serial admission, ``order`` a linear
               extension of P, every survivor on no cycle commits, the
               serial apply in ``order``); the run goes on to 60 epochs
               and counts its closure epochs.  K9b, K11a and K11b on
               ``ycsb_skew``'s epoch-4 P (K11a's two calls, over live0
               with and without counts and over the peel's survivors,
               at each residual group size, and on structured graphs: a
               ring with chords, a deep DAG, 2- and 3-cycles, a chain of
               B txns, sparse and empty live sets, the gate off; with
               the strongly connected set found and the levels each
               residual group took); K9b also on the first
               ``operating_points`` MAAT epoch at B = 8,192 whose gate is
               set (the L2 regime); K14b over 655,360 probes of the
               2^24-entry index with misses mixed in; K4b with HOT keys,
               ``key_order`` and ``txn_write_perc=0.25`` at 65,536 x 10.
               TPC-C: K19 and K14a on one 64-warehouse epoch's 2,048
               txns (K14a also on 655,360 probes with misses), K14c on
               each table's scatter-add of a real epoch at 64 and at 4
               warehouses (``index_put_(accumulate=True)`` the
               yardstick) and on Payment's three-table launch against
               the three one-table calls, K14d on each appended table's
               call (ORDER-LINE's 30,720 lanes, 2,048 for HISTORY, ORDER and
               NEW-ORDER) across the ring's end.  K20 on one
               ``pps_scaling`` epoch's 2,048 txns (and with spans above
               2^16); K14e's merge on a real 64-warehouse NewOrder
               insert into an index of 2^20 entries holding 2^19, on an
               all-masked call and on a call
               across the capacity; K14e's probes on the merged index.
               K13a on both sub-rounds of a real OCC repair epoch at
               ``repair_ablation`` (B = 2,048, 10 accesses, K = 8,192,
               two families; the two bf16 ``torch.matmul`` the
               yardstick); K15a, K15b and K16 on the lanes of real
               ``dgcc_contention`` epochs at theta 0.6, 0.9 and 0.99
               (40,960 doubled lanes; ``torch.sort`` K15a's yardstick).
               K13b on a metered OCC ``ycsb_skew`` epoch and on the
               forwarding batch of 65,536 (``torch.bincount`` + gathers
               the yardstick); K17, K15a, K15c-scan and K15c-compact on
               one audited epoch of each slice-8 configuration
               (``argsort``, ``torch.sort``, ``cumsum`` + ``index_copy_``
               and two ``scatter_reduce_`` the yardsticks; K17's rank
               alone against ``argsort``), and K15a's
               wide mode on an audited DGCC epoch at ``epoch_batch =
               16384`` (``torch.sort`` the yardstick) with K17's rank on
               its committed set.
               K18a and K18b on each shard's call of a real
               epoch of the main path at 2^27 rows over 8 shards, K18a
               also on a shard's call at 4 shards (a stable
               ``torch.sort`` of the slice's packed (owner, ts) words
               the yardstick).
4. epochs    — per mode and path: 3 epochs through the kernels equal 3
               through the plain versions leaf by leaf; one more kernel
               epoch equals a numpy oracle (forwarding: serial execution
               in rank order; OCC: Kung-Robinson serial validation over
               the same hashed buckets, exact-key conflict freedom of the
               committed set, the serial apply of its writes).  At the
               ``ycsb_skew`` point: 3 kernel epochs equal 3 plain epochs
               under NO_WAIT, WAIT_DIE, TIMESTAMP, MVCC and MAAT (both
               modes), and one epoch at each other isolation level for
               NO_WAIT and WAIT_DIE; numpy oracles for NO_WAIT (serial
               lock acquisition in rank order), TIMESTAMP and MVCC (the
               watermark rules per lane, the later-reader wait, the new
               watermarks and boundary ring) and MVCC's stale reads (each
               committed read's value against the versions written since
               the load, one per key and epoch, kept in numpy).  3 kernel
               epochs equal 3 plain epochs for MAAT at ``ycsb_hot``,
               SIMPLE and QRY_ONLY (whose F0 stays the loaded table) and
               IDX_BTREE (then its forwarding oracle epoch).  TPC-C:
               3 kernel epochs equal 3 plain epochs for TPU_BATCH at 64
               warehouses and CALVIN, NO_WAIT, OCC (escrow off) and MVCC
               at 4; one TPU_BATCH epoch against a numpy oracle that
               applies the committed txns level by level; the run's
               money conservation and dense O_IDs; the cost of an empty
               chained pass and of the O_ID rank glue.  PPS: 3 kernel
               epochs equal 3 plain epochs under TPU_BATCH, CALVIN,
               NO_WAIT, OCC, MVCC and MAAT; one TPU_BATCH epoch against
               numpy (PART_AMOUNT's adds, PRODUCT_PART the last
               committed writer in serial order).  TPC-C at 64
               warehouses with the ORDER index: 3 kernel epochs equal 3
               plain epochs, then after 20 more the index oracle (every
               ORDER row at its slot, each district's walk dense and
               ascending) through the K14e probes.  Repair: 3 kernel
               epochs equal 3 plain epochs under the six sweep backends
               at ``repair_ablation`` (rounds 2) and under OCC at TPC-C 4
               wh; one OCC repair epoch against numpy (the main round's
               winners, then each sub-round's salvages, serially by
               rank: same table and read checksum; salvaged + fallback
               = losers, aborts = fallback).  DGCC: 3 kernel epochs equal
               3 plain epochs at theta 0.9 and at TPC-C 4 wh; one epoch
               against serial execution in rank order; one repair and
               one DGCC epoch under torch's sync debug mode set to raise
               (no host sync); the cost of an empty DGCC pass.  Slice 8:
               3 kernel epochs equal 3 plain epochs (stamp tables
               included) for each audited configuration at cadence 1,
               OCC at cadence 8 (epoch 0 audited, 1-2 skipped) and OCC
               with ``audit_mutate``; a numpy oracle (serial per exact
               key) of one audited epoch per visibility rule — level 0,
               forwarding, chained levels and waves, repair rounds,
               MVCC's rings — for the edge multiset, ``cnt``, ``rdig``,
               ``vdig`` and every stamp; armed and off epochs leave the
               same rows; three sync-free armed epochs (two skipped, one
               audited); the mutation's excess witnesses only in its
               window's epochs; OCC's density over 12 epochs at theta
               0.6 / 0.9 / 0.99 ranked like its aborts (B = 2,048, 2^16
               buckets over 2^16 rows, the reference test's sizing).
               The mesh: the main path at 2^27 rows over 1, 2, 4 and 8
               shards on the card, 3 kernel epochs equal 3 plain epochs
               and every counter and every data row (mapped back from
               the owner-major layout) equals 1 shard's; one epoch of
               the replicated plan (``mc_plan_capacity=0``) equals 1
               shard's; a tight ``mc_plan_capacity=0.25`` at 4,096 rows
               defers with no abort and no lost txn; ``mesh_scaling``'s
               cells at 2, 4 and 8 shards, TPC-C at 64 warehouses
               (TPU_BATCH, NO_WAIT; with the money and O_ID audit) and
               PPS (TPU_BATCH, MAAT) at 8 equal 1 shard's.
5. simulate  — ``run_simulation`` (warmup 1 s, measure 3 s for TPU_BATCH
               in both modes, OCC and NOCC and the mesh's main path;
               0.5 s + 1 s for the rest): TPU_BATCH in
               both modes, OCC and NOCC in fingerprint mode, NO_WAIT,
               WAIT_DIE, TIMESTAMP, MVCC, CALVIN and MAAT at the
               ``ycsb_skew`` point, MAAT at ``ycsb_hot`` and at
               ``operating_points``' B = 8,192, TPU_BATCH under
               SIMPLE and QRY_ONLY and on IDX_BTREE, TPC-C under
               TPU_BATCH at 64 and 4 warehouses and every other
               algorithm at 4 (NO_WAIT, OCC and MVCC with escrow off
               too), ``tpcc_order_index``'s cells, PPS under all eight
               algorithms and ``escrow_ablation``'s four PPS cells (none
               may overflow its index, the chained ones never abort);
               ``repair_ablation``'s cells (salvages at rounds >= 1, none
               at 0) and ``dgcc_contention``'s (no abort, a wave past 0);
               the slice-8 cells (density > 0, audit edges > 0 where
               reads forward or chain, the mutated OCC run's witnesses
               above the clean run's; OCC's density per validated txn
               at theta 0.6 / 0.9 / 0.99 and the armed txn/s beside the
               off runs' written down); the mesh: the main path at
               2^27 rows as 1 shard and as 8 shards sharing the card
               (``[mesh-simulate]``) and as 4, ``mesh_scaling``'s eight
               cells at
               their own windows, TPC-C at 64 warehouses (TPU_BATCH,
               NO_WAIT) and PPS (TPU_BATCH, MAAT) over 8 shards;
               the ``[summary]``
               numbers and committed txn/s, the TPU_BATCH / OCC ratio
               (``bench.py``'s ``vs_baseline``); with counts zeroed just
               before each run, every kernel's launches equal its
               per-epoch count on that path (``PATH_LAUNCHES``) times the
               epochs run; the YCSB sweep backends must commit and
               abort, TPC-C's and PPS's may abort, the others never.
   Slice 11: ``[K21]`` K21 against its plain version on a generated
               ``ycsb_skew`` batch at 4 partitions (B = 2,048 x 10,
               K = 8,192, G = 3 and 4; also at K = 64 and 2^18), its
               time against the reference's 18 einsums in bf16;
               ``[part]`` kernel epochs equal plain epochs at
               ``part_cnt = 4`` on every leaf, the trash and pad rows
               left 0, with the non-owned lanes counted, and one
               forwarding epoch against the numpy serial oracle;
               ``[router]`` static knobs equal the unrouted step, mixed
               and ``ctrl_dgcc`` routed kernel epochs equal plain ones,
               and one mixed epoch's committed set against numpy (K21's
               defers from their definition, no cross-group conflict,
               each group's own rule); ``[ctrl-simulate]`` the armed
               controller's ``run_simulation``: its ``[ctrl]`` lines
               parse and replay, ``ctrl_decisions`` > 0.  ``--slice11``
               runs only these.
   Slice 12: ``[K17-rank]`` K17's rank through its own entry point
               at B = 2,048 (the OCC audited epoch) and at 16,384 (the
               audited DGCC epoch), each exact, beside a stable
               ``torch.argsort``, both by CUDA events; ``[K14d]`` each of
               TPC-C's four appended tables.  ``--slice12`` runs only
               these and the wide K15a.
   Slice 13: ``[K11]`` also K11a on the first MAAT epoch at TPC-C 4
               warehouses whose closure branch runs.  ``--slice13`` runs
               only ``[K11]``'s K11a calls and graphs and ``[K14c]``'s
               cases at 64 and 4 warehouses; with ``--profile`` also the
               MAAT (``ycsb_skew``, ``ycsb_hot``) and TPC-C (64 wh
               TPU_BATCH, 4 wh NO_WAIT) profiles, whose launch counts are
               held to ``PATH_LAUNCHES``; with ``--k11-parent DIR``
               (``DIR`` an unpacked checkout of another commit, say
               ``git archive HEAD~1``) ``[K11-parent]`` times that
               commit's K11a beside this one on the same epochs and
               graphs, parent, this, this, parent.
   Slice 14: ``[K8]`` K8 also at B = 2,048 on ``ycsb_skew``'s
               conflicts (its own row of the kernels line), each ``[K8]``
               line with the rounds the sweep ran before its fixpoint.
               ``--slice14`` runs only K8 at both sizes and ``[K16]``,
               K16 on the ``dgcc_contention`` epochs at theta 0.6, 0.9
               and 0.99 at clusters of 1, 2, 4 and 8 CTAs; with
               ``--profile`` also the OCC comparator's, ``ycsb_skew``
               NO_WAIT's, DGCC theta 0.9's and the routed cell's
               profiles (launches held to ``PATH_LAUNCHES``, K8's and
               K16's device time an epoch); with ``--k14-parent DIR``
               ``[K14-parent]`` times that commit's K8 and K16 beside
               this one's on the same inputs, parent, this, this, parent.
               ``--cluster-costs`` builds and runs
               ``deneva_tpu_torch/probes/cluster_costs.cu`` (not in the
               kernel library): a cluster barrier's device time
               in four forms and back-to-back launches, plain, as a
               cluster and as a pair with and without programmatic
               dependent launch (``[cluster-costs]``).
   Slice 15: ``--slice15`` runs only K3's probe (``[K3-probe]``:
               ``deneva_tpu_torch/probes/k3_costs.cu``, not in the kernel
               library, built into its own shared library: the slice-1
               K3's gather with and without its per-block atomics, its
               memset and store, empty and cooperative launches with 0,
               1 and 9 grid barriers at 256-1,024 threads a block), K3
               in both table modes on the main path's plan, a
               ``ycsb_skew`` plan and a ``ycsb_hot`` plan (``[K3]``, and
               ``[K3-phases]``: the main path's plan without stores,
               without gathers, without both), and K10 on the OCC
               comparator's (10,240 lanes) and a ``ycsb_skew`` epoch's
               (20,480) committed writes, a TPC-C stock batch (30,720)
               and the arena (65,536 and 131,072) (``[K10]``: the
               library's layout, then 1-128 CTAs and the global table;
               ``[K10-phases]``),
               each exact against its plain version; with ``--profile``
               also the forwarding cells' (both modes), ``ycsb_skew``
               NO_WAIT's and DGCC theta 0.9's profiles, K3's and K10's
               launches and device time an epoch; with ``--k15-parent
               DIR`` ``[K15-parent]`` times that commit's K3 and K10
               beside this one's on the same inputs, parent, this, this,
               parent.
   Slice 16: ``--slice16`` runs only ``[K11b-rounds]`` (`peel_trace`
               on ``ycsb_skew``'s epoch 4, a ``ycsb_hot`` closure epoch
               and an ``operating_points`` MAAT epoch at B = 8,192: per
               peel round the sweep rounds each way of the one-block
               design, |F| at their exits, the candidates, the victims
               and the cluster design's exchanges; this tree's K11b at
               the path's settings, at one peel round and at one peel
               round without sweeps), ``[K11b]`` (K11b on the same
               inputs on K11a's bits, at each cluster size, its counts
               against the trace), ``[K11b-layout]`` (the largest B
               K11b's layout takes, beside the one-block kernel's and
               K11a's) and ``[K2]``
               (K2 on the main path's, a ``ycsb_skew`` and IDX_BTREE's
               sorted words), each exact against its plain version; with
               ``--profile`` also the MAAT ``ycsb_skew``, MAAT
               ``ycsb_hot`` and forwarding fingerprint profiles; with
               ``--slice16-parent DIR`` ``[slice16-parent]`` times that
               commit's K11b, K2 and K11a beside this one's on the same
               inputs, parent, this, this, parent.
   Slice 17: ``--slice17`` runs only ``[K13b-split]`` and
               ``[K4b-split]`` (``deneva_tpu_torch/probes/
               k13b_k4b_costs.cu``, its own shared library: the slice-8
               K13b's two memsets and two passes each alone and all four;
               the slice-4 K4b's empty launch, prologue, hashes without
               the zipf power, power alone, whole kernel and row sort,
               with static SASS counts by pipe and the dispatch floor they
               imply), ``[K13b]`` on the forwarding batch, a metered OCC
               ``ycsb_skew`` epoch and a routed mixed epoch over 2^18
               buckets (``[K13b-phases]``: the regime the library picks,
               no valid lane, distinct keys, cooperative launches with 0-2
               grid barriers) and ``[K4b]`` on the main path's zipf, theta
               0, ``ycsb_hot``, the HOT row's options, zipf with
               ``key_order`` and ``txn_write_perc``, and zipf at
               ``ycsb_skew``'s 2,048 txns and at 16,384, 32,768 and 49,152
               (either side of the 4-draws-a-thread switch), each exact
               against its plain version;
               with ``--profile`` also the audited OCC ``ycsb_skew``,
               ``part_cnt = 4``, forwarding fingerprint and ``ycsb_hot``
               profiles; with ``--slice17-parent DIR``
               ``[slice17-parent]`` times that commit's K13b and K4b
               beside this one's on the same inputs, parent, this, this,
               parent, and with ``--profile`` profiles the same cells on
               that commit's package (``--parent-profile``, a child
               process; ``[slice17-parent-profile]``).
   Slice 18: ``--slice18`` runs only ``[K9b-split]``,
               ``[K9b-rounds]`` and ``[K18a-split]``
               (``deneva_tpu_torch/probes/k9b_k18a_costs.cu``, its own
               shared library: the slice-4 K9b's ``pack_cols`` and sweep
               each alone, the rounds the sweep ran and |F_r| at each,
               P's strips through one CTA (16-byte loads, bulk copies,
               a column strip) and through k CTAs at once, this K9b's
               pack cut at four depths; the slice-9 K18a's six stream
               operations each alone; empty cooperative launches with
               0-4 grid barriers), ``[K9b]`` (`k9b_inputs`:
               ``ycsb_skew``'s epoch 4, a ``ycsb_hot`` epoch and an
               ``operating_points`` MAAT epoch at B = 8,192, in the
               library's layout and at each cluster size in each
               regime; ``[K9b-phases]``, CTA 0's phase stamps) and
               ``[K18a]`` (`k18a_inputs`: a D = 8 and a D = 4 shard call
               at 2^27 rows and a 32,768-txn slice at D = 2;
               ``[K18a-phases]``), each exact against its plain version;
               with ``--profile`` also the MAAT ``ycsb_skew``, MAAT
               ``ycsb_hot`` and mesh D = 8 profiles; with
               ``--slice18-parent DIR`` ``[slice18-parent]`` times that
               commit's K9b and K18a beside this one's on the same
               inputs, parent, this, this, parent, and with
               ``--profile`` profiles the same cells on that commit's
               package (``[slice18-parent-profile]``).
6. report    — one ``{"kernels": [...]}`` line (K14e's probes, which
               no reference path runs, with ``"path": false`` and the
               launches of the index oracle), then as the last line
               ``{"ok": true, "device": {...}}``.

``--profile`` adds, before the report, a profile of 50 epochs per
forwarding mode and of OCC, NO_WAIT, MVCC, MAAT (``ycsb_skew`` and
``ycsb_hot``), SIMPLE and IDX_BTREE in fingerprint mode, of TPC-C
(TPU_BATCH at 64 warehouses with the ORDER index off and on, NO_WAIT
at 4), of PPS (TPU_BATCH, OCC), of OCC with repair (rounds 2) and of
DGCC at theta 0.9 and of the audited OCC ``ycsb_skew`` cell (cadence
1): host and wall time per epoch, device time by kernel and the
device's idle share; for TPC-C, PPS, repair, DGCC and the audited cell
also the host syncs in one epoch and the host's hot spots (cProfile);
for the MAAT and TPC-C cells the profiled epochs' launches held to
``PATH_LAUNCHES`` and K11a's and K14c's launches and device time an
epoch (K8's and K16's too under ``--slice14``).

``--audit-overhead`` runs only the armed-against-off comparison of OCC
and CALVIN at ``ycsb_skew``: host milliseconds per epoch off, with the
metrics alone, and audited at cadence 8 and 1, in turns in one process.

``--order-index-window`` runs only the 64-warehouse TPU_BATCH cell of
``tpcc_order_index`` at ``paper_base``'s 10 s + 30 s windows and reports
whether, and after how many epochs, the driver refuses it for an
overflowed index.

Without a CUDA device, or in a directory without the package, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROWS = 1 << 24
BATCH = 65536
REQ = 10
THETA = 0.9
OCC_BATCH = 1024                # bench.py's OCC comparator point
OCC_POOL = 100000
BUCKETS = 8192
SKEW_BATCH = 2048               # the ycsb_skew point (paper_base)
SKEW_POOL = 10000
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
ALU_OPS_PER_S = 67e12           # H100 SXM non-tensor fp32 rate
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
THREEFRY_OPS = 120              # integer ops of one 20-round hash
MASK32 = 0xFFFFFFFF

# kernel -> (source, the reference function it replaces)
KERNELS = {
    "K1_sort_lanes": ("deneva_tpu_torch/csrc/forward.cu",
                      "deneva_tpu/ops/forward.py:243"),
    "K2_plan_scans": ("deneva_tpu_torch/csrc/forward.cu",
                      "deneva_tpu/ops/forward.py:191"),
    "K3_forward_execute": ("deneva_tpu_torch/csrc/ycsb.cu",
                           "deneva_tpu/workloads/ycsb.py:78"),
    "K4a_threefry_split": ("deneva_tpu_torch/csrc/prng.cu",
                           "deneva_tpu/engine/step.py:218"),
    "K4b_ycsb_generate": ("deneva_tpu_torch/csrc/ycsb.cu",
                          "deneva_tpu/ops/sampling.py:54"),
    "K5K6_build_incidence": ("deneva_tpu_torch/csrc/conflict.cu",
                             "deneva_tpu/ops/conflict.py:47"),
    "K7_overlap": ("deneva_tpu_torch/csrc/conflict.cu",
                   "deneva_tpu/ops/conflict.py:63"),
    "K8_first_fit": ("deneva_tpu_torch/csrc/conflict.cu",
                     "deneva_tpu/ops/conflict.py:96"),
    "K9a_wavefront_levels": ("deneva_tpu_torch/csrc/levels.cu",
                             "deneva_tpu/ops/conflict.py:123"),
    "K9b_precedence_levels": ("deneva_tpu_torch/csrc/levels.cu",
                              "deneva_tpu/ops/conflict.py:141"),
    "K10_last_writer": ("deneva_tpu_torch/csrc/scatter.cu",
                        "deneva_tpu/ops/scatter.py:33"),
    "K11a_maat_reach": ("deneva_tpu_torch/csrc/maat.cu",
                        "deneva_tpu/cc/maat.py:178"),
    "K11b_maat_peel": ("deneva_tpu_torch/csrc/maat.cu",
                       "deneva_tpu/cc/maat.py:201"),
    "K12a_watermark_check": ("deneva_tpu_torch/csrc/timestamp.cu",
                             "deneva_tpu/cc/timestamp.py:202"),
    "K12b_commit_watermarks": ("deneva_tpu_torch/csrc/timestamp.cu",
                               "deneva_tpu/cc/timestamp.py:271"),
    "K12c_version_read": ("deneva_tpu_torch/csrc/version.cu",
                          "deneva_tpu/storage/table.py:241"),
    "K12d_version_push": ("deneva_tpu_torch/csrc/version.cu",
                          "deneva_tpu/storage/table.py:257"),
    "K14b_sorted_lookup": ("deneva_tpu_torch/csrc/index.cu",
                           "deneva_tpu/storage/index.py:159"),
    "K14a_hash_lookup": ("deneva_tpu_torch/csrc/index.cu",
                         "deneva_tpu/storage/index.py:97"),
    "K14c_scatter_add": ("deneva_tpu_torch/csrc/table.cu",
                         "deneva_tpu/storage/table.py:126"),
    "K14d_append": ("deneva_tpu_torch/csrc/table.cu",
                    "deneva_tpu/storage/table.py:137"),
    "K19_tpcc_generate": ("deneva_tpu_torch/csrc/tpcc.cu",
                          "deneva_tpu/workloads/tpcc.py:470"),
    "K14e_index_merge": ("deneva_tpu_torch/csrc/index.cu",
                         "deneva_tpu/storage/index.py:264"),
    "K14e_sorted_probe": ("deneva_tpu_torch/csrc/index.cu",
                          "deneva_tpu/storage/index.py:168"),
    "K20_pps_generate": ("deneva_tpu_torch/csrc/pps.cu",
                         "deneva_tpu/workloads/pps.py:184"),
    "K13a_repair_frontier": ("deneva_tpu_torch/csrc/frontier.cu",
                             "deneva_tpu/cc/base.py:193"),
    "K15a_lane_sort": ("deneva_tpu_torch/csrc/depgraph.cu",
                       "deneva_tpu/cc/depgraph.py:54"),
    "K15b_seg_scans": ("deneva_tpu_torch/csrc/depgraph.cu",
                       "deneva_tpu/cc/depgraph.py:63"),
    "K16_dgcc_relax": ("deneva_tpu_torch/csrc/depgraph.cu",
                       "deneva_tpu/cc/dgcc.py:77"),
    "K13b_conflict_density": ("deneva_tpu_torch/csrc/audit.cu",
                              "deneva_tpu/cc/base.py:228"),
    "K15c_audit_scans": ("deneva_tpu_torch/csrc/audit.cu",
                         "deneva_tpu/cc/depgraph.py:81"),
    "K15c_compact_edges": ("deneva_tpu_torch/csrc/audit.cu",
                           "deneva_tpu/cc/depgraph.py:115"),
    "K17_audit_observe": ("deneva_tpu_torch/csrc/audit.cu",
                          "deneva_tpu/cc/base.py:414"),
    "K18a_mc_defer": ("deneva_tpu_torch/csrc/mc.cu",
                      "deneva_tpu/ops/forward.py:109"),
    "K18b_mc_pack": ("deneva_tpu_torch/csrc/mc.cu",
                     "deneva_tpu/workloads/ycsb.py:413"),
    "K21_cross_group_defer": ("deneva_tpu_torch/csrc/router.cu",
                              "deneva_tpu/cc/router.py:149"),
}
# kernels that no reference path launches: their launches come from the
# oracle check that probes them, and the kernels line marks them
OFF_PATH = ("K14e_sorted_probe",)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` by CUDA events.  A
    sleep kernel holds the stream while the host enqueues the calls, so
    the events time the device's work and not the host's launch gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = time.perf_counter() - t
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * host * iters + 0.01) * 2e9))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(rec: dict, nbytes: float, ops: float,
          ops_per_s: float = ALU_OPS_PER_S) -> None:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    rec.update(bytes=int(nbytes), ops=int(ops), bound_ms=max(tb, to),
               bound_by="bytes" if tb >= to else "operations")


def config(full: bool, **kw):
    from deneva_tpu_torch.config import Config
    args = [f"--synth_table_size={ROWS}", f"--epoch_batch={BATCH}",
            f"--max_txn_in_flight={BATCH}", f"--req_per_query={REQ}",
            "--write_perc=0.5", "--read_perc=0.5", f"--zipf_theta={THETA}",
            "--cc_alg=TPU_BATCH", f"--sim_full_row={full}",
            "--field_per_tuple=10", "--tup_size=100", "--seed=7"]
    args += [f"--{k}={v}" for k, v in kw.items()]
    return Config.from_args(args)


def occ_config(full: bool, alg: str = "OCC", **kw):
    """bench.py's OCC comparator: YCSB zipf 0.9, 50% writes, 10 requests,
    ``epoch_batch=1024`` over a pool of 100,000 txns, 8192 buckets, dual
    hashing — at 2^24 rows."""
    return config(full, cc_alg=alg, epoch_batch=OCC_BATCH,
                  max_txn_in_flight=OCC_POOL, conflict_buckets=BUCKETS,
                  conflict_exact=True, **kw)


def skew_config(full: bool, alg: str, **kw):
    """The paper's ``ycsb_skew`` point at theta 0.9 (``paper_base`` of
    ``deneva_tpu/harness/experiments.py``): 2^24 rows, 10 requests,
    ``epoch_batch=2048`` over ``max_txn_in_flight=10000``, 8192 buckets,
    dual hashing, 2^20 watermark buckets, ``mvcc_his_len=4``."""
    return config(full, cc_alg=alg, epoch_batch=SKEW_BATCH,
                  max_txn_in_flight=SKEW_POOL, conflict_buckets=BUCKETS,
                  conflict_exact=True, watermark_buckets=1 << 20,
                  mvcc_his_len=4, **kw)


def hot_config(full: bool, alg: str = "MAAT", **kw):
    """The ``ycsb_hot`` sweep's hottest point (``experiments.py:68-74``):
    the ``ycsb_skew`` settings with ``skew_method=HOT``, a hot set of
    ``data_perc=100`` keys taking ``access_perc=0.9`` of the accesses."""
    return skew_config(full, alg, skew_method="HOT", data_perc=100,
                       access_perc=0.9, **kw)


def modes_config(mode: str, **kw):
    """The ``modes`` experiment (``experiments.py:452-456``): TPU_BATCH at
    the ``paper_base`` settings, theta 0.6, ``exec_subrounds=4``."""
    return skew_config(False, "TPU_BATCH", zipf_theta=0.6, mode=mode,
                       exec_subrounds=4, **kw)


def btree_config(**kw):
    """The forwarding path (TPU_BATCH, full pool of 65,536, theta 0.9) with
    the ordered index on the primary path."""
    return config(False, index_struct="IDX_BTREE", **kw)


# launches per epoch of each kernel on each path (kernels missing from a
# path's map launch zero times there)
_FWD = {"K1_sort_lanes": 1, "K2_plan_scans": 1, "K3_forward_execute": 1,
        "K4a_threefry_split": 1, "K4b_ycsb_generate": 1}
# both hash families share one K5+K6 launch; SERIALIZABLE takes one K7
_SWEEP = {"K4a_threefry_split": 1, "K4b_ycsb_generate": 1,
          "K5K6_build_incidence": 1, "K7_overlap": 1, "K8_first_fit": 1,
          "K10_last_writer": 1}
_TO = {**_SWEEP, "K12a_watermark_check": 1, "K12b_commit_watermarks": 1}
PATH_LAUNCHES = {
    "TPU_BATCH": _FWD, "CALVIN": _FWD,
    "BTREE": {**_FWD, "K14b_sorted_lookup": 1},
    # the closure runs twice, around the peel, in every epoch; each
    # kernel reads the gate on the device
    "MAAT": {**_SWEEP, "K9b_precedence_levels": 1, "K11a_maat_reach": 2,
             "K11b_maat_peel": 1},
    # TPU_BATCH / CALVIN under SIMPLE or QRY_ONLY: validation, no execute
    "MODES": {"K4a_threefry_split": 1, "K4b_ycsb_generate": 1,
              "K5K6_build_incidence": 1, "K7_overlap": 1,
              "K9a_wavefront_levels": 1},
    "OCC": _SWEEP, "NO_WAIT": _SWEEP, "WAIT_DIE": _SWEEP,
    "NOCC": {"K4a_threefry_split": 1, "K4b_ycsb_generate": 1,
             "K10_last_writer": 1},
    "TIMESTAMP": _TO,
    "MVCC": {**_TO, "K12c_version_read": 1, "K12d_version_push": 1},
}
# TPC-C: generation (K4a, K19, the by-last-name probe K14a); each
# executed pass adds through K14c three times (Payment's W_YTD, D_YTD and
# customer in one launch, D_NEXT_O_ID, stock) and appends through K14d
# four times (HISTORY, ORDER, NEW-ORDER, ORDER-LINE).  The chained executor
# runs
# exec_subrounds = 4 passes and takes no K10; the sweep path one pass.
_TPCC_GEN = {"K4a_threefry_split": 1, "K19_tpcc_generate": 1,
             "K14a_hash_lookup": 1}
_TPCC_SWEEP = {**_TPCC_GEN, "K5K6_build_incidence": 1, "K7_overlap": 1,
               "K8_first_fit": 1, "K10_last_writer": 1,
               "K14c_scatter_add": 3, "K14d_append": 4}
PATH_LAUNCHES.update({
    "TPCC_CHAINED": {**_TPCC_GEN, "K5K6_build_incidence": 1,
                     "K7_overlap": 1, "K9a_wavefront_levels": 1,
                     "K14c_scatter_add": 12, "K14d_append": 16},
    "TPCC_SWEEP": _TPCC_SWEEP,
    "TPCC_TO": {**_TPCC_SWEEP, "K12a_watermark_check": 1,
                "K12b_commit_watermarks": 1},
    "TPCC_MAAT": {**_TPCC_SWEEP, "K9b_precedence_levels": 1,
                  "K11a_maat_reach": 2, "K11b_maat_peel": 1},
})
# tpcc_order_index: each executed pass merges its orders through K14e
PATH_LAUNCHES.update({
    "TPCC_CHAINED_IDX": {**PATH_LAUNCHES["TPCC_CHAINED"],
                         "K14e_index_merge": 4},
    "TPCC_SWEEP_IDX": {**_TPCC_SWEEP, "K14e_index_merge": 1},
})
# PPS: generation (K4a, K20); each executed pass adds PART_AMOUNT through
# K14c twice (ORDERPRODUCT, UPDATEPART); the sweep path resolves the
# PRODUCTS writers through K10
_PPS_GEN = {"K4a_threefry_split": 1, "K20_pps_generate": 1}
_PPS_SWEEP = {**_PPS_GEN, "K5K6_build_incidence": 1, "K7_overlap": 1,
              "K8_first_fit": 1, "K10_last_writer": 1, "K14c_scatter_add": 2}
PATH_LAUNCHES.update({
    "PPS_CHAINED": {**_PPS_GEN, "K5K6_build_incidence": 1, "K7_overlap": 1,
                    "K9a_wavefront_levels": 1, "K14c_scatter_add": 8},
    "PPS_SWEEP": _PPS_SWEEP,
    "PPS_TO": {**_PPS_SWEEP, "K12a_watermark_check": 1,
               "K12b_commit_watermarks": 1},
    "PPS_MAAT": {**_PPS_SWEEP, "K9b_precedence_levels": 1,
                 "K11a_maat_reach": 2, "K11b_maat_peel": 1},
    "PPS_NOCC": {**_PPS_GEN, "K10_last_writer": 1, "K14c_scatter_add": 2},
})
# transaction repair: each of R sub-rounds takes one K13a, re-runs the
# backend's validate and re-executes its winners (every kernel of the
# path but generation and the incidence, which are built once)
_ONCE = ("K4a_threefry_split", "K4b_ycsb_generate", "K5K6_build_incidence",
         "K19_tpcc_generate", "K14a_hash_lookup")


def _with_repair(path: dict, rounds: int) -> dict:
    out = {k: v if k in _ONCE else v * (1 + rounds) for k, v in path.items()}
    if rounds:
        out["K13a_repair_frontier"] = rounds
    return out


REPAIR_BASES = ("OCC", "NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC", "MAAT",
                "TPCC_SWEEP", "TPCC_TO", "TPCC_MAAT", "TPCC_SWEEP_IDX")
PATH_LAUNCHES.update({f"{p}+R{r}": _with_repair(PATH_LAUNCHES[p], r)
                      for p in REPAIR_BASES for r in (0, 1, 2)})
# DGCC: the lane sort, its census and the relaxation once; the chained
# executor runs dgcc_levels = 32 passes, each resolving its writers
# through K10 (and on TPC-C adding through K14c and appending through
# K14d as every executed pass does)
DGCC_PASSES = 32
_DGCC = {"K15a_lane_sort": 1, "K15b_seg_scans": 1, "K16_dgcc_relax": 1}
PATH_LAUNCHES.update({
    "DGCC": {"K4a_threefry_split": 1, "K4b_ycsb_generate": 1, **_DGCC,
             "K10_last_writer": DGCC_PASSES},
    "TPCC_DGCC": {**_TPCC_GEN, **_DGCC, "K10_last_writer": DGCC_PASSES,
                  "K14c_scatter_add": 3 * DGCC_PASSES,
                  "K14d_append": 4 * DGCC_PASSES},
})
# the metrics plane: K13b once an epoch; the audit plane: K17's lane
# build, K15a's sort (wide positions), K15c's scans and compaction and
# K17's stamp pass once an epoch, on the cadence or off it (each reads the
# device gate); audit_mutate adds K13a's launch on the write lanes
_METRICS = {"K13b_conflict_density": 1}
_AUDIT = {"K17_audit_observe[lanes]": 1, "K15a_lane_sort": 1,
          "K15c_audit_scans": 1, "K15c_compact_edges": 1,
          "K17_audit_observe[stamps]": 1}


def _armed(path: str, metrics: bool = True, audit: bool = True,
           mutate: bool = False) -> dict:
    out = dict(PATH_LAUNCHES[path])
    for on, extra in ((metrics, _METRICS), (audit, _AUDIT),
                      (mutate, {"K13a_repair_frontier": 1})):
        if on:
            for k, v in extra.items():
                out[k] = out.get(k, 0) + v
    return out


PATH_LAUNCHES.update({
    "OCC+A": _armed("OCC"), "OCC+A+M": _armed("OCC", mutate=True),
    "CALVIN+A": _armed("CALVIN"), "MVCC+A": _armed("MVCC"),
    "DGCC+A": _armed("DGCC"), "OCC+R2+A": _armed("OCC+R2"),
    "TPCC_CHAINED+A": _armed("TPCC_CHAINED"),
    "TPCC_DGCC+A": _armed("TPCC_DGCC"),
    "TPU_BATCH+D": _armed("TPU_BATCH", audit=False),
    "OCC+D": _armed("OCC", audit=False),
    "TPCC_SWEEP+A": _armed("TPCC_SWEEP"),
    "TIMESTAMP+A": _armed("TIMESTAMP"),
})
# the mesh (device_parts = d on one card): the sharded plan launches K18a
# and K18b once per source shard and K1-K3 once per shard; the replicated
# plan (pair_cap = 0) only K1-K3 per shard.  The generic path runs each
# shard's executor: every per-pass kernel d times.


def mesh_launches(path: str, d: int) -> dict:
    out = {"K4a_threefry_split": 1, "K4b_ycsb_generate": 1,
           "K1_sort_lanes": d, "K2_plan_scans": d, "K3_forward_execute": d}
    if path == "MESH":
        out.update({"K18a_mc_defer": d, "K18b_mc_pack": d})
    return out


def _per_shard(path: str, d: int) -> dict:
    once = ("K4a_threefry_split", "K19_tpcc_generate", "K14a_hash_lookup",
            "K20_pps_generate", "K5K6_build_incidence", "K7_overlap",
            "K8_first_fit", "K9a_wavefront_levels", "K9b_precedence_levels",
            "K11a_maat_reach", "K11b_maat_peel")
    return {k: v if k in once else v * d
            for k, v in PATH_LAUNCHES[path].items()}


for _d in (2, 4, 8):
    PATH_LAUNCHES[f"MESH{_d}"] = mesh_launches("MESH", _d)
    PATH_LAUNCHES[f"MESH_REPL{_d}"] = mesh_launches("MESH_REPL", _d)
# the router's mixed branch: one K5+K6 launch, K21, each group's validate
# (NO_WAIT and OCC: K7 and K8; TPU_BATCH: K7 and K9a; DGCC: K15a, K15b,
# K16), the union through exec_subrounds = 4 level passes without K10
# (or, under ctrl_dgcc, dgcc_levels = 32 with it); repair sits out mixed
# epochs; the metrics and audit planes once
_MIXED = {"K4a_threefry_split": 1, "K4b_ycsb_generate": 1,
          "K5K6_build_incidence": 1, "K21_cross_group_defer": 1,
          "K7_overlap": 3, "K8_first_fit": 2, "K9a_wavefront_levels": 1}
PATH_LAUNCHES.update({"ROUTED_MIXED": _MIXED, "ROUTED_MIXED_DGCC": {
    **_MIXED, **_DGCC, "K10_last_writer": DGCC_PASSES}})
PATH_LAUNCHES.update({p: _armed(p)
                      for p in ("ROUTED_MIXED", "ROUTED_MIXED_DGCC")})
PATH_LAUNCHES.update({
    "TPCC_CHAINED@8": _per_shard("TPCC_CHAINED", 8),
    "TPCC_SWEEP@8": _per_shard("TPCC_SWEEP", 8),
    "PPS_CHAINED@8": _per_shard("PPS_CHAINED", 8),
    "PPS_MAAT@8": _per_shard("PPS_MAAT", 8)})

# paths whose runs must abort, and paths that may (TPC-C's and PPS's
# sweep backends under escrow abort only on the rows they order; repair
# salvages some or all losers); the others never abort
ABORTING = ("OCC", "NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC", "MAAT",
            "OCC+A", "OCC+A+M", "MVCC+A", "OCC+D", "TIMESTAMP+A")
MAY_ABORT = ("TPCC_SWEEP", "TPCC_TO", "TPCC_MAAT", "PPS_SWEEP", "PPS_TO",
             "PPS_MAAT", "TPCC_SWEEP+A", "TPCC_SWEEP@8", "PPS_MAAT@8") \
    + tuple(p for p in PATH_LAUNCHES if "+R" in p)


@contextlib.contextmanager
def plain_path(wl):
    """Route one engine's epochs through the plain PyTorch versions (the
    comparison side of phase 4 and of tests/test_torch_cuda.py; the
    package itself has no such switch).  A kernel added to the main path
    is swapped here."""
    from deneva_tpu_torch.cc import (base, depgraph, dgcc, maat, router,
                                     timestamp)
    from deneva_tpu_torch.ops import conflict, forward, prng, scatter
    from deneva_tpu_torch.storage import index, table
    from deneva_tpu_torch.workloads import ycsb
    swaps = [(forward, "sort_lanes", lambda k, r, w: forward.sort_lanes_plain(
                  k, r, w).values),
             (forward, "plan_scans", forward.plan_scans_plain),
             (prng, "split", prng.split_plain),
             (ycsb, "_forward_execute_f0", ycsb._forward_execute_f0_plain),
             (conflict, "hashed_incidence", conflict.hashed_incidence_plain),
             (conflict, "overlap", conflict.overlap_plain),
             (conflict, "first_fit", conflict.first_fit_plain),
             (scatter, "last_writer", scatter.last_writer_plain),
             (timestamp, "_watermark_check", timestamp._watermark_check_plain),
             (timestamp, "_commit_watermarks",
              timestamp._commit_watermarks_plain),
             (ycsb, "_versioned_read_f0", ycsb._versioned_read_f0_plain),
             (table.VersionRing, "push", table.VersionRing.push_plain),
             (conflict, "wavefront", conflict.wavefront_plain),
             (conflict, "precedence_levels",
              conflict.precedence_levels_plain),
             # the bits K11a hands K11b on the card mean nothing here
             (maat, "reach_stats",
              lambda p, live, gate, counts=True, **kw:
              maat.reach_stats_plain(p, live, gate, counts)),
             (maat, "peel", lambda *a, **kw: maat.peel_plain(*a)),
             (index.SortedIndex, "lookup", index.SortedIndex.lookup_plain),
             (index.HashIndex, "lookup", index.HashIndex.lookup_plain),
             (table.DeviceTable, "scatter_add",
              table.DeviceTable.scatter_add_plain),
             (table, "scatter_add_many", table.scatter_add_many_plain),
             (table.DeviceTable, "append", table.DeviceTable.append_plain),
             (index.DynamicSortedIndex, "insert",
              index.DynamicSortedIndex.insert_plain),
             (index.SortedIndex, "lookup_count",
              index.SortedIndex.lookup_count_plain),
             (index.SortedIndex, "range_slots",
              index.SortedIndex.range_slots_plain),
             (index.SortedIndex, "range_between",
              index.SortedIndex.range_between_plain),
             (base, "committed_write_frontier",
              base.committed_write_frontier_plain),
             (depgraph, "lane_sort",
              lambda k, p, t, n, **kw: depgraph.lane_sort_plain(k, p, t)),
             (depgraph, "census", depgraph.census_plain),
             (dgcc, "relax", dgcc.relax_plain),
             (base, "conflict_density", base.conflict_density_plain),
             (base, "audit_lanes", base.audit_lanes_plain),
             (base, "audit_stamps", base.audit_stamps_plain),
             (depgraph, "audit_scans", depgraph.audit_scans_plain),
             (depgraph, "compact_edges", depgraph.compact_edges_plain),
             (forward, "mc_slice_defer", forward.mc_slice_defer_plain),
             (router, "cross_group_defer", router.cross_group_defer_plain),
             (forward, "mc_pack_blocks",
              lambda k, v, ts, r, w, dfr, order, d, cap:
              forward.mc_pack_blocks_plain(k, v, ts, r, w, dfr, d, cap))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    wl.generate = wl.generate_plain
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        del wl.generate


def max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# -- numpy oracle (the value law re-derived from its definition) ---------

def np_fingerprint(k, v):
    k = np.asarray(k).astype(np.uint32)
    v = np.asarray(v).astype(np.uint32)
    return ((k * np.uint32(2654435761)) ^ (v * np.uint32(0x9E3779B9))) \
        | np.uint32(1)


def np_bytes(k, v, nb):
    fp = np_fingerprint(k, v)
    i = np.arange(nb, dtype=np.uint32)
    coef = i * np.uint32(2654435761) + np.uint32(0x9E3779B9)
    return (((fp[:, None] * coef) >> np.uint32(13))
            & np.uint32(0xFF)).astype(np.uint8)


def oracle_epoch(eng, state, dev):
    """One kernel epoch checked against serial execution in rank order."""
    from deneva_tpu_torch.workloads.ycsb import TABLE
    full = eng.cfg.sim_full_row
    start = state.db[TABLE].columns["F0"].clone()
    pre = {k: int(state.stats[k]) for k in
           ("read_checksum", "write_cnt", "total_txn_commit_cnt")}
    state = eng.step(state)
    torch.cuda.synchronize()
    keys = state.pool.queries.keys.cpu().numpy().astype(np.int64)
    isw = state.pool.queries.is_write.cpu().numpy()
    seq = state.pool.seq.cpu().numpy().astype(np.int64)
    lk = keys.reshape(-1)
    lw = isw.reshape(-1)
    comp = (lk << 32) | np.repeat(seq, keys.shape[1])
    wc = np.sort(comp[lw])
    rk, rc = lk[~lw], comp[~lw]
    # the latest writer strictly before each read, by binary search
    pos = np.searchsorted(wc, rc, side="left") - 1
    prev = wc[np.maximum(pos, 0)]
    fwd = np.where((pos >= 0) & ((prev >> 32) == rk), prev & MASK32, -1)
    start_rows = start[torch.from_numpy(rk).to(dev)].cpu().numpy()
    if full:
        vals = np.where((fwd >= 0)[:, None],
                        np_bytes(rk, np.maximum(fwd, 0), start.shape[1]),
                        start_rows)
    else:
        vals = np.where(fwd >= 0, np_fingerprint(rk, np.maximum(fwd, 0)),
                        start_rows.view(np.uint32))
    cks = int(vals.astype(np.uint64).sum()) & MASK32
    wkey = wc >> 32
    last = np.r_[wkey[1:] != wkey[:-1], True]
    win_k, win_r = wkey[last], wc[last] & MASK32
    new = np_bytes(win_k, win_r, start.shape[1]) if full \
        else np_fingerprint(win_k, win_r).view(np.int32)
    expect = start
    expect[torch.from_numpy(win_k).to(dev)] = torch.from_numpy(new).to(dev)
    got = state.db[TABLE].columns["F0"]
    if not torch.equal(got, expect):
        fail("oracle: table differs from serial execution in rank order")
    d = {k: (int(state.stats[k]) - pre[k]) & MASK32 for k in pre}
    if d["read_checksum"] != cks:
        fail(f"oracle: checksum {d['read_checksum']} != serial {cks}")
    if d["write_cnt"] != int(lw.sum()) or d["total_txn_commit_cnt"] != BATCH:
        fail(f"oracle: counters {d}")
    return state, int(len(win_k)), int(len(rk))


def np_bucket(keys, family: int, k: int):
    """bucket_hash(combine_key(0, keys), k, family), re-derived in numpy."""
    mult = (2654435761, 2246822519, 3266489917, 668265263)[family]
    with np.errstate(over="ignore"):
        h = np.asarray(keys).astype(np.uint32) * np.uint32(2654435761)
        h ^= np.uint32(mult)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return (h & np.uint32(k - 1)).astype(np.int64)


def occ_oracle_epoch(eng, state, dev, symmetric: bool = False):
    """One OCC kernel epoch against Kung-Robinson serial validation in
    rank order over the same hashed buckets, in numpy: every txn the
    sweep decided gets the serial verdict; no two committed txns share an
    exact key that either writes; table rows [0, capacity) equal the
    epoch-start rows with the committed writes applied serially; the
    read checksum, write and commit counts match.  With ``symmetric``
    the serial rule is NO_WAIT's under SERIALIZABLE: txn i acquires its
    locks in rank order iff no admitted txn holds a lock it conflicts
    with either way (union-vs-write overlap, symmetrized)."""
    import dataclasses

    from deneva_tpu_torch.workloads.ycsb import TABLE
    cfg, be = eng.cfg, eng.backend
    seen = {}

    def capture(cfg_, cc_state, batch, inc):
        v, st = be.validate(cfg_, cc_state, batch, inc)
        seen["batch"], seen["verdict"] = batch, v
        return v, st
    full = cfg.sim_full_row
    start = state.db[TABLE].columns["F0"].clone()
    pre = {k: int(state.stats[k]) for k in
           ("read_checksum", "write_cnt", "total_txn_commit_cnt")}
    eng.backend = dataclasses.replace(be, validate=capture)
    try:
        state = eng.step(state)
    finally:
        eng.backend = be
    torch.cuda.synchronize()
    bt, v = seen["batch"], seen["verdict"]
    keys = bt.keys.cpu().numpy().astype(np.int64)
    isw = bt.is_write.cpu().numpy()
    rank = bt.rank.cpu().numpy()
    act = bt.active.cpu().numpy()
    win, lose = v.commit.cpu().numpy(), v.abort.cpu().numpy()
    b, k = len(rank), cfg.conflict_buckets
    rows = np.repeat(np.arange(b), keys.shape[1])

    def dense(cols, lanes):
        m = np.zeros((b, k), np.float32)
        m[rows[lanes.reshape(-1)], cols.reshape(-1)[lanes.reshape(-1)]] = 1
        return m
    conflict_m = np.ones((b, b), bool)
    lanes = act[:, None] & np.ones_like(isw)
    for f in (0, 1):
        bk = np_bucket(keys, f, k)
        uw = dense(bk, lanes) @ dense(bk, lanes & isw).T > 0
        conflict_m &= (uw | uw.T) if symmetric else uw
    label = "NO_WAIT oracle" if symmetric else "OCC oracle"
    admitted = np.zeros(b, bool)
    for i in np.lexsort((np.arange(b), rank)):
        if act[i] and not (conflict_m[i] & admitted).any():
            admitted[i] = True
    decided = win | lose
    if (win & ~admitted).any() or (lose & admitted).any():
        fail(f"{label}: a decided txn differs from serial validation "
             f"({int((win & ~admitted).sum())} commits, "
             f"{int((lose & admitted).sum())} aborts)")
    committed = win & act
    ck = keys[committed]
    cw = isw[committed]
    # exact keys: no committed j before committed i (by rank, lane) has
    # W_j ∩ (R_i ∪ W_i) ≠ ∅ — a written key's one writer is its last
    # accessor
    pos = np.empty(b, np.int64)
    pos[np.lexsort((np.arange(b), rank))] = np.arange(b)
    lane_pos = np.broadcast_to(pos[committed][:, None], ck.shape)
    for key in np.unique(ck[cw]):
        at = ck == key
        if lane_pos[at & cw].min() != lane_pos[at].max():
            fail(f"{label}: committed txns conflict on key {key}")
    # serial apply in rank order: each written key holds its last writer's
    crank = np.broadcast_to(rank[committed][:, None], ck.shape)
    wk, wr = ck[cw], crank[cw]
    o = np.lexsort((wr, wk))
    wk, wr = wk[o], wr[o]
    last = np.r_[wk[1:] != wk[:-1], True]
    win_k, win_r = wk[last], wr[last]
    new = np_bytes(win_k, win_r, start.shape[1]) if full \
        else np_fingerprint(win_k, win_r).view(np.int32)
    expect = start.clone()
    expect[torch.from_numpy(win_k).to(dev)] = torch.from_numpy(new).to(dev)
    cap = eng.workload.n_rows
    got = state.db[TABLE].columns["F0"]
    if not torch.equal(got[:cap], expect[:cap]):
        fail(f"{label}: table differs from the serial apply")
    reads = ck[~cw]
    vals = start[torch.from_numpy(reads).to(dev)].cpu().numpy()
    cks = int(vals.astype(np.uint64).sum() if full
              else vals.view(np.uint32).astype(np.uint64).sum()) & MASK32
    d = {k_: (int(state.stats[k_]) - pre[k_]) & MASK32 for k_ in pre}
    if d["read_checksum"] != cks:
        fail(f"{label}: checksum {d['read_checksum']} != serial {cks}")
    if d["write_cnt"] != int(cw.sum()) \
            or d["total_txn_commit_cnt"] != int(committed.sum()):
        fail(f"{label}: counters {d}")
    return state, {"active": int(act.sum()), "commit": int(win.sum()),
                   "abort": int(lose.sum()),
                   "undecided": int((act & ~decided).sum()),
                   "written_keys": int(len(win_k))}


# -- phases ---------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(f"[card] {card}", flush=True)
    return {"kind": name, "count": count, "card": card}


def phase_build() -> float:
    from deneva_tpu_torch import kernels
    t = time.monotonic()
    kernels.library()
    secs = time.monotonic() - t
    print(f"[build] {secs:.1f} s", flush=True)
    for ln in kernels.ptxas_lines(kernels.build_log):
        print(f"[ptxas] {ln}", flush=True)
    return secs


def phase_kernels(dev, rec: dict, card: str) -> None:
    from deneva_tpu_torch.ops import forward, prng
    from deneva_tpu_torch.workloads import ycsb
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    n = BATCH * REQ
    wl = YCSBWorkload(config(False), device=dev)
    key = prng.key_from_seed(11, dev)

    # K4a
    a, b = prng.split(key), prng.split_plain(key)
    if not torch.equal(a, b):
        fail("K4a split differs from plain")
    rec["K4a_threefry_split"].update(
        max_abs_err=max_abs(a, b), ms=cuda_ms(lambda: prng.split(key)),
        plain_ms=cuda_ms(lambda: prng.split_plain(key)), library_ms=None)
    bound(rec["K4a_threefry_split"], 16 + 32, 2 * THREEFRY_OPS)

    # K4b, at theta 0.9 and theta 0.  Exact: kernel and plain version both
    # take the zipf power as f64 pow rounded to f32 (the off-by-one
    # allowance of the tests is for XLA's f32 pow, which neither matches).
    gk = prng.split(key)[1]
    q, qp = wl.generate(gk, BATCH), wl.generate_plain(gk, BATCH)
    if not torch.equal(q.is_write, qp.is_write):
        fail("K4b write flags differ from plain")
    dk = (q.keys.to(torch.int64) - qp.keys.to(torch.int64)).abs()
    if int(dk.max()) != 0:
        fail(f"K4b zipf keys: {int((dk != 0).sum())} differ from plain, "
             f"max {int(dk.max())}")
    wl0 = YCSBWorkload(config(False, zipf_theta=0.0), device=dev)
    q0, q0p = wl0.generate(gk, BATCH), wl0.generate_plain(gk, BATCH)
    if not (torch.equal(q0.keys, q0p.keys)
            and torch.equal(q0.is_write, q0p.is_write)):
        fail("K4b at theta 0 differs from plain")
    rec["K4b_ycsb_generate"].update(
        max_abs_err=int(dk.max()),
        ms=cuda_ms(lambda: wl.generate(gk, BATCH)),
        plain_ms=cuda_ms(lambda: wl.generate_plain(gk, BATCH), iters=5),
        library_ms=None)
    bound(rec["K4b_ycsb_generate"], 16 + 5 * n, n * (2 * THREEFRY_OPS + 40))

    # K1 on the generated lanes, ranks as the pool stamps them
    k = q.keys.reshape(-1).contiguous()
    r = (1 + torch.arange(BATCH, dtype=torch.int32, device=dev)
         ).repeat_interleave(REQ)
    w = q.is_write.reshape(-1).contiguous()
    words = forward.sort_lanes(k, r, w)
    words_p = forward.sort_lanes_plain(k, r, w).values
    if not torch.equal(words, words_p):
        fail("K1 sorted words differ from plain")
    packed = forward.pack_lanes(k, r, w)
    rec["K1_sort_lanes"].update(
        max_abs_err=max_abs(words, words_p),
        ms=cuda_ms(lambda: forward.sort_lanes(k, r, w)),
        plain_ms=cuda_ms(lambda: forward.sort_lanes_plain(k, r, w)),
        library_ms=cuda_ms(lambda: torch.sort(packed)))
    bound(rec["K1_sort_lanes"], 17 * n, n * np.log2(n))

    # K2
    plan = forward.plan_scans(words)
    plan_p = forward.plan_scans_plain(words)
    err = 0
    for f in ("keys", "rank", "is_read", "is_write", "fwd", "win"):
        x, y = getattr(plan, f), getattr(plan_p, f)
        if not torch.equal(x, y):
            fail(f"K2 plan field {f} differs from plain")
        err = max(err, max_abs(x, y))
    rec["K2_plan_scans"].update(
        max_abs_err=err, ms=cuda_ms(lambda: forward.plan_scans(words)),
        plain_ms=cuda_ms(lambda: forward.plan_scans_plain(words), iters=5),
        library_ms=None)
    bound(rec["K2_plan_scans"], 23 * n, 8 * n)
    print(f"[K2] reads={int(plan.is_read.sum())} "
          f"forwarded={int((plan.is_read & (plan.fwd >= 0)).sum())} "
          f"winners={int(plan.win.sum())}", flush=True)

    # K3, both table modes, on the F0 column at 2^24 rows
    for full in (False, True):
        cfg = config(full, field_per_tuple=1)
        wlm = YCSBWorkload(cfg, device=dev)
        tab = wlm.load()["MAIN_TABLE"]
        f0 = tab.columns["F0"]
        f0p = f0.clone()
        slots = wlm.index.lookup(plan.keys)
        _, cks, wcnt = ycsb._forward_execute_f0(f0, plan, slots,
                                                tab.capacity, mono=True)
        _, cksp, wcntp = ycsb._forward_execute_f0_plain(
            f0p, plan_p, slots, tab.capacity, mono=True)
        if not (torch.equal(f0, f0p) and int(cks) == int(cksp)
                and int(wcnt) == int(wcntp)):
            fail(f"K3 ({'full row' if full else 'fingerprint'}) differs "
                 "from plain")
        err = max(max_abs(f0, f0p), abs(int(cks) - int(cksp)))
        name = f"K3_forward_execute[{'full_row' if full else 'fingerprint'}]"
        rec[name].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: ycsb._forward_execute_f0(
                f0, plan, slots, tab.capacity, mono=True)),
            plain_ms=cuda_ms(lambda: ycsb._forward_execute_f0_plain(
                f0p, plan_p, slots, tab.capacity, mono=True), iters=5),
            library_ms=None)
        bound(rec[name], *k3_work(plan, slots, f0.shape[1] if full else 0))
        del f0, f0p, tab, wlm
        torch.cuda.empty_cache()
    for nm, v in rec.items():
        if v:
            print_kernel(nm, v, card)


def k3_work(plan, slots, tup: int) -> tuple[int, int]:
    """(bytes, operations) of K3 on a plan: the plan's 19 bytes a lane
    (keys, rank, fwd, slots, three flags) read once, one row read for each
    distinct slot a non-forwarded read gathers and one written for each
    winner, 8 bytes of totals; 12 integer operations a 4-byte word."""
    row = tup or 4
    gathered = plan.is_read & (plan.fwd < 0)
    n_rows_read = int(torch.unique(slots[gathered]).numel())
    n = plan.keys.numel()
    return (19 * n + row * (n_rows_read + int(plan.win.sum())) + 8,
            n * 12 * (row // 4))


def lw_library(slots, order, mask, capacity):
    """``last_writer`` as one stable torch.sort (the reference's sort
    tournament with its unsort folded into a scatter): the word
    ``slot << 33 | (order - INT32_MIN) << 1 | mask`` orders lanes by
    (slot, order, masked last); equal words keep lane order, so each
    slot's tail is its winner.  ``chip_smoke``'s yardstick only."""
    s = torch.where(mask, slots, capacity).to(torch.int64)
    o = torch.where(mask, order, -2**31).to(torch.int64) + 2**31
    word = (s << 33) | (o << 1) | mask.to(torch.int64)
    perm = torch.sort(word, stable=True).indices
    ss = s[perm]
    tail = torch.ones_like(mask)
    tail[:-1] = ss[1:] != ss[:-1]
    win = torch.empty_like(mask)
    win[perm] = tail
    return win & mask


def k7_case(ins, r: dict, card: str) -> torch.Tensor:
    """K7 on one shape's two families against its plain version and the
    two bf16 ``torch.matmul`` yardstick, all exact; times into ``r``."""
    from deneva_tpu_torch.ops import conflict
    uw = conflict.overlap(*ins)
    uw_p = conflict.overlap_plain(*ins)
    if not torch.equal(uw, uw_p):
        fail("K7 overlap differs from plain")

    def lib():
        return (torch.matmul(ins[0], ins[1].T) > 0) \
            & (torch.matmul(ins[2], ins[3].T) > 0)
    if not torch.equal(lib(), uw):
        fail("K7 overlap differs from torch.matmul")
    b, k = ins[0].shape
    # the product the data needs: per family, sum over buckets of
    # (rows touching it) x (rows writing it) multiply-adds
    need = sum(float((a.float().sum(0) * c.float().sum(0)).sum())
               for a, c in ((ins[0], ins[1]), (ins[2], ins[3])))
    r.update(max_abs_err=max_abs(uw, uw_p),
             ms=cuda_ms(lambda: conflict.overlap(*ins)),
             plain_ms=cuda_ms(lambda: conflict.overlap_plain(*ins)),
             library_ms=cuda_ms(lib))
    bound(r, 4 * b * k * 2 + b * b, 2 * need)
    print(f"[K7] B={b} K={k}: conflict pairs {int(uw.sum())} of {b * b}; "
          f"dense product {4 * b * b * k} ops, data needs {int(2 * need)}; "
          f"{r['ms']:.4f} ms, two torch.matmul {r['library_ms']:.4f}, plain "
          f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.6f} ({r['bound_by']})"
          f" (card {card})", flush=True)
    return uw


def k8_row(nm: str, b: int) -> str:
    """The kernels line's row of a launch: K8's and K13b's at B = 2,048
    apart."""
    return f"{nm}[B=2048]" if b == SKEW_BATCH and nm in (
        "K8_first_fit", "K13b_conflict_density") else nm


def k10_row(nm: str, cfg) -> str:
    """The kernels line's row of a run's launches: K10's in YCSB cells of
    20,480 lanes (B = 2,048 txns of 10 requests) apart."""
    return f"{nm}[N=20480]" if nm == "K10_last_writer" \
        and cfg.workload.name == "YCSB" \
        and cfg.epoch_batch * cfg.req_per_query == 20480 else nm


def slice18_row(nm: str, cfg) -> str:
    """The kernels line's row of a run's launches: K9b's at B = 8,192 and
    K18a's at D = 4 apart."""
    if nm == "K9b_precedence_levels" and cfg.epoch_batch == 8192:
        return f"{nm}[B=8192]"
    if nm == "K18a_mc_defer" and cfg.device_parts == 4:
        return f"{nm}[D=4]"
    return nm


def sweep_conflicts(dev, cfg, b: int, seed: int) -> tuple:
    """K7's inputs at a sweep comparator's shape: both families' union
    and write count rows of ``b`` txns generated from ``seed``."""
    from deneva_tpu_torch.ops import conflict, prng
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    wl = YCSBWorkload(cfg, device=dev)
    q = wl.generate(prng.split(prng.key_from_seed(seed, dev))[1], b)
    (g1, g2), _ = conflict.hashed_incidence(
        torch.zeros_like(q.keys), q.keys, ~q.is_write, q.is_write,
        torch.ones_like(q.is_write),
        torch.ones(b, dtype=torch.bool, device=dev), None, BUCKETS, 2,
        ("u", "w"))
    return g1["u"], g1["w"], g2["u"], g2["w"]


def skew_conflicts(dev) -> tuple:
    """K7's inputs at the sweep backends' ``ycsb_skew`` shape (B =
    2,048)."""
    return sweep_conflicts(dev, skew_config(False, "OCC"), SKEW_BATCH, 17)


def sweep_rounds_run(uw, rank, active, rounds: int) -> int:
    """The rounds K8 runs on these inputs: the reference's Jacobi rounds
    up to and including the first that changes nothing (or ``rounds``)."""
    from deneva_tpu_torch.ops import conflict
    e = conflict.earlier_edges(uw, rank, active).to(torch.float32)
    win = torch.zeros_like(active)
    lose = torch.zeros_like(active)
    for r in range(rounds):
        pending = active & ~win & ~lose
        new_win = pending & ~((e @ (~lose).to(torch.float32)) > 0)
        new_lose = pending & ((e @ win.to(torch.float32)) > 0) & ~new_win
        if not bool((new_win | new_lose).any()):
            return r + 1
        win, lose = win | new_win, lose | new_lose
    return rounds


def k8_inputs(uw) -> tuple:
    """K8's (conflict, rank, active) on a conflict matrix, as the sweep
    comparators take them: every txn active, ranks in lane order."""
    b = uw.shape[0]
    return (uw, 1 + torch.arange(b, dtype=torch.int32, device=uw.device),
            torch.ones(b, dtype=torch.bool, device=uw.device))


def k8_case(uw, rounds: int, r: dict, card: str):
    """K8 on one conflict matrix against its plain version, timed into
    ``r``; returns (win, lose, undecided)."""
    from deneva_tpu_torch.ops import conflict
    c, rank, active = k8_inputs(uw)
    b = c.shape[0]
    ff = conflict.first_fit(c, rank, active, rounds)
    ff_p = conflict.first_fit_plain(c, rank, active, rounds)
    for x, y in zip(ff, ff_p):
        if not torch.equal(x, y):
            fail(f"K8 at B = {b} differs from plain")
    edges = int(conflict.earlier_edges(c, rank, active).sum())
    r.update(max_abs_err=max(max_abs(x, y) for x, y in zip(ff, ff_p)),
             ms=cuda_ms(lambda: conflict.first_fit(c, rank, active, rounds)),
             plain_ms=cuda_ms(lambda: conflict.first_fit_plain(
                 c, rank, active, rounds), iters=5), library_ms=None)
    # one sequential pass over the edges decides the lex-first MIS
    bound(r, b * b + 5 * b + 3 * b, 2 * edges)
    ctas, in_smem, _ = conflict.first_fit_layout(b)
    print(f"[K8] B={b}: win={int(ff[0].sum())} lose={int(ff[1].sum())} "
          f"undecided={int(ff[2].sum())} edges={edges} rounds run "
          f"{sweep_rounds_run(c, rank, active, rounds)} of {rounds}; "
          f"cluster of {ctas} CTA(s), rows in "
          f"{'shared memory' if in_smem else 'L2'}; {r['ms']:.4f} ms "
          f"(card {card})", flush=True)
    return ff


def phase_sweep_kernels(dev, rec: dict, card: str) -> None:
    """K5+K6, K7, K8 and K10 against their plain versions at the OCC
    comparator's shapes: B = 1024 txns of 10 zipf-0.9 requests, K = 8192,
    both families (K7 and K8 also at ``ycsb_skew``'s B = 2,048); K10 over
    the epoch's committed write lanes, and once in the arena regime (N >=
    capacity)."""
    from deneva_tpu_torch.ops import conflict, prng, scatter
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    b, k = OCC_BATCH, BUCKETS
    n = b * REQ
    wl = YCSBWorkload(occ_config(False), device=dev)
    q = wl.generate(prng.split(prng.key_from_seed(13, dev))[1], b)
    tid = torch.zeros_like(q.keys)
    valid = torch.ones_like(q.is_write)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    rank = 1 + torch.arange(b, dtype=torch.int32, device=dev)
    args = (tid, q.keys, ~q.is_write, q.is_write, valid, active, None, k, 2,
            ("u", "w"))

    # K5+K6: bit-exact bf16 counts and family-0 bucket ids
    (f1, f2), b1 = conflict.hashed_incidence(*args)
    (p1, p2), b1p = conflict.hashed_incidence_plain(*args)
    if not torch.equal(b1, b1p):
        fail("K5+K6 bucket ids differ from plain")
    for fam, pfam in ((f1, p1), (f2, p2)):
        for nm in ("u", "w"):
            if not torch.equal(fam[nm].view(torch.int16),
                               pfam[nm].view(torch.int16)):
                fail(f"K5+K6 view {nm} differs from plain")
    rec["K5K6_build_incidence"].update(
        max_abs_err=max(max_abs(b1, b1p), max(
            float((fam[nm].float() - pfam[nm].float()).abs().max())
            for fam, pfam in ((f1, p1), (f2, p2)) for nm in ("u", "w"))),
        ms=cuda_ms(lambda: conflict.hashed_incidence(*args)),
        plain_ms=cuda_ms(lambda: conflict.hashed_incidence_plain(*args),
                         iters=5), library_ms=None)
    # lanes in (table, key, 3 flags) + active; out: 4 count rows + ids
    bound(rec["K5K6_build_incidence"], 11 * n + b + 4 * b * k * 2 + 4 * n,
          2 * 12 * n)

    # K7 at this shape into the kernels line, and at the sweep backends'
    ins = (f1["u"], f1["w"], f2["u"], f2["w"])
    uw = k7_case(ins, rec["K7_overlap"], card)
    uw2 = k7_case(skew_conflicts(dev), {}, card)

    # K8 on both conflict matrices, at the config's 24 rounds
    rounds = occ_config(False).sweep_rounds
    ff = k8_case(uw, rounds, rec["K8_first_fit"], card)
    k8_case(uw2, rounds, rec["K8_first_fit[B=2048]"], card)
    del uw2

    # K10 over the committed write lanes (the comparator's 10,240 and
    # ycsb_skew's 20,480), and in the arena regime
    wmask = (q.is_write & ff[0][:, None]).reshape(-1)
    cases = {"epoch": (q.keys.reshape(-1).contiguous(),
                       rank[:, None].expand(b, REQ).reshape(-1), wmask,
                       ROWS),
             "ycsb_skew epoch": k10_epoch(dev, skew_config(False, "OCC"),
                                          SKEW_BATCH, 17),
             "arena": k10_arena(dev)}
    err = {}
    for nm, (sl, od, mk, cp) in cases.items():
        w = k10_check(nm, sl, od, mk, cp)
        err[nm] = max_abs(w, scatter.last_writer_plain(sl, od, mk, cp))
        print(f"[K10] {nm}: N={sl.numel()} capacity={cp} "
              f"winners={int(w.sum())}", flush=True)
    for nm, row in (("epoch", "K10_last_writer"),
                    ("ycsb_skew epoch", "K10_last_writer[N=20480]")):
        sl, od, mk, cp = cases[nm]
        rec[row].update(
            max_abs_err=err[nm],
            ms=cuda_ms(lambda: scatter.last_writer(sl, od, mk, cp)),
            plain_ms=cuda_ms(lambda: scatter.last_writer_plain(
                sl, od, mk, cp)),
            library_ms=cuda_ms(lambda: lw_library(sl, od, mk, cp)))
        bound(rec[row], 10 * sl.numel(), 4 * sl.numel())
    for nm in ("K5K6_build_incidence", "K7_overlap", "K8_first_fit",
               "K8_first_fit[B=2048]", "K10_last_writer",
               "K10_last_writer[N=20480]"):
        print_kernel(nm, rec[nm], card)


def k10_check(label: str, sl, od, mk, cp) -> torch.Tensor:
    """K10 on one input against its plain version and the sort yardstick,
    exactly; returns the kernel's flags."""
    from deneva_tpu_torch.ops import scatter
    w = scatter.last_writer(sl, od, mk, cp)
    for other, fn in (("plain", scatter.last_writer_plain),
                      ("sort yardstick", lw_library)):
        if not torch.equal(w, fn(sl, od, mk, cp)):
            fail(f"K10 ({label}) differs from {other}")
    return w


def k10_epoch(dev, cfg, b: int, seed: int) -> tuple:
    """K10's (slots, order, mask, capacity) on a sweep epoch of ``b`` txns
    generated under ``cfg`` from ``seed``: the write lanes of the txns K8
    commits on the epoch's conflicts (K5+K6, K7), ranks in txn order, at
    2^24 rows."""
    from deneva_tpu_torch.ops import conflict, prng
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    wl = YCSBWorkload(cfg, device=dev)
    q = wl.generate(prng.split(prng.key_from_seed(seed, dev))[1], b)
    (g1, g2), _ = conflict.hashed_incidence(
        torch.zeros_like(q.keys), q.keys, ~q.is_write, q.is_write,
        torch.ones_like(q.is_write),
        torch.ones(b, dtype=torch.bool, device=dev), None, BUCKETS, 2,
        ("u", "w"))
    uw = conflict.overlap(g1["u"], g1["w"], g2["u"], g2["w"])
    win = conflict.first_fit(*k8_inputs(uw), cfg.sweep_rounds)[0]
    req = q.keys.shape[1]
    rank = 1 + torch.arange(b, dtype=torch.int32, device=dev)
    return (q.keys.reshape(-1).contiguous(),
            rank[:, None].expand(b, req).reshape(-1),
            (q.is_write & win[:, None]).reshape(-1), ROWS)


def k10_arena(dev, na: int = 1 << 17) -> tuple:
    """K10's arena case: ``na`` lanes (131,072) over na / 2 + 1 slots (N >=
    capacity, the reference's scatter-max regime), orders spread over
    int32."""
    g = torch.Generator(device=dev).manual_seed(3)
    cap = na // 2
    return (torch.randint(0, cap + 1, (na,), generator=g, device=dev,
                          dtype=torch.int32),
            torch.randint(-2**31, 2**31 - 1, (na,), generator=g, device=dev,
                          dtype=torch.int32) // 4096,
            torch.rand(na, generator=g, device=dev) < 0.7, cap)


def print_kernel(nm: str, v: dict, card: str) -> None:
    print(f"[kernel] {nm} ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} "
          f"library_ms={v['library_ms']} bytes={v['bytes']} "
          f"ops={v['ops']} bound_ms={v['bound_ms']:.6f} "
          f"({v['bound_by']}; 3.35 TB/s, 67 Tops/s, 989 bf16 Tflop/s; "
          f"card {card})", flush=True)


def phase_epochs(dev, full: bool) -> None:
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    cfg = config(full)
    wl_k = YCSBWorkload(cfg, device=dev)
    wl_p = YCSBWorkload(cfg, device=dev)
    eng_k, eng_p = Engine(cfg, wl_k), Engine(cfg, wl_p)
    t = time.monotonic()
    sk = eng_k.init_state()
    sp = copy.deepcopy(sk)
    sk = eng_k.run(sk, 3)
    with plain_path(wl_p):
        sp = eng_p.run(sp, 3)
    torch.cuda.synchronize()
    lk, lp = state_leaves(sk), state_leaves(sp)
    for path, x in lk.items():
        if not torch.equal(x, lp[path]):
            fail(f"epochs ({'full row' if full else 'fingerprint'}): leaf "
                 f"{path} differs between kernel and plain epochs")
    del sp, lp
    torch.cuda.empty_cache()
    sk, n_win, n_read = oracle_epoch(eng_k, sk, dev)
    print(f"[epochs] {'full_row' if full else 'fingerprint'}: 3 kernel "
          f"epochs == 3 plain epochs ({len(lk)} leaves); oracle epoch ok "
          f"(reads={n_read} written_keys={n_win}) "
          f"in {time.monotonic() - t:.1f} s", flush=True)


def phase_sweep_epochs(dev, full: bool) -> None:
    """OCC at the comparator's settings: `epochs_equal`, then one kernel
    epoch against the numpy Kung-Robinson oracle."""
    mode = "full_row" if full else "fingerprint"
    t = time.monotonic()
    eng, sk = epochs_equal(dev, occ_config(full), 3, f"OCC {mode}")
    torch.cuda.empty_cache()
    _, n = occ_oracle_epoch(eng, sk, dev)
    print(f"[occ-epochs] {mode}: oracle epoch ok ({n}) "
          f"in {time.monotonic() - t:.1f} s", flush=True)


# -- the lock and T/O paths at the ycsb_skew point ---------------------------

def clone_cc(cs):
    """A copy of a T/O state's leaves."""
    import dataclasses
    return type(cs)(**{f.name: getattr(cs, f.name).clone()
                       for f in dataclasses.fields(cs)})


def capture_epoch(eng, state):
    """One kernel epoch of a sweep engine, keeping what its kernels saw:
    the batch, its incidence, the cc_state before validation (cloned),
    the verdict and,
    under MVCC, K12c's and K12d's arguments (table and ring cloned before
    the epoch's stores)."""
    import dataclasses

    from deneva_tpu_torch.storage import table
    from deneva_tpu_torch.workloads import ycsb
    seen = {}
    be = eng.backend
    real_read, real_push = ycsb._versioned_read_f0, table.VersionRing.push

    def validate(cfg_, cc_state, batch, inc):
        seen["pre"] = cc_state if isinstance(cc_state, tuple) \
            else clone_cc(cc_state)
        seen["batch"], seen["inc"] = batch, inc
        v, st = be.validate(cfg_, cc_state, batch, inc)
        seen["verdict"] = v
        return v, st

    def read(f0, ring, keys, slots, rmask, ver_ts, capacity):
        seen["read"] = (f0.clone(), table.VersionRing(ring.wts.clone(),
                                                      ring.depth),
                        keys, slots, rmask, ver_ts, capacity)
        return real_read(f0, ring, keys, slots, rmask, ver_ts, capacity)

    def push(ring, slots, wts, mask):
        seen["push"] = (table.VersionRing(ring.wts.clone(), ring.depth),
                        slots, wts, mask)
        return real_push(ring, slots, wts, mask)
    eng.backend = dataclasses.replace(be, validate=validate)
    ycsb._versioned_read_f0, table.VersionRing.push = read, push
    try:
        state = eng.step(state)
    finally:
        eng.backend = be
        ycsb._versioned_read_f0, table.VersionRing.push = real_read, real_push
    torch.cuda.synchronize()
    return state, seen


def same_state(x, y) -> bool:
    return all(torch.equal(getattr(x, f), getattr(y, f))
               for f in ("rts", "wts", "his", "pos") if hasattr(x, f))


def phase_to_kernels(dev, rec: dict, card: str) -> None:
    """K12a-d against their plain versions on the inputs of a real MVCC
    epoch at the ycsb_skew point: the first epoch after ten warm-up
    epochs in which a committed read is served from the ring and a
    winner's ring row wraps around; K12c also in full-row mode on the
    same lanes and ring."""
    from deneva_tpu_torch.cc import timestamp
    from deneva_tpu_torch.cc.timestamp import TOState
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.ops import conflict
    from deneva_tpu_torch.storage.table import VersionRing
    from deneva_tpu_torch.workloads import ycsb
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    cfg = skew_config(False, "MVCC")
    eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
    st = eng.run(eng.init_state(), 10)
    for tries in range(1, 41):
        st, seen = capture_epoch(eng, st)
        _, ring, _, slots, rmask, ver_ts, _ = seen["read"]
        _, has = ring.select_version(slots,
                                     ver_ts[:, None].expand(slots.shape))
        served = int((has & rmask).sum())
        ring0, wslots, _, win = seen["push"]
        wraps = int((ring0.rows(wslots).gt(0).all(dim=1) & win).sum())
        if served and wraps:
            break
    else:
        fail("K12c/K12d: 40 epochs served no stale read from the ring or "
             "wrapped no ring row")
    print(f"[K12] epoch {10 + tries} of MVCC: {served} committed reads "
          f"served from the ring, {wraps} ring rows wrapped", flush=True)
    bt, pre, v = seen["batch"], seen["pre"], seen["verdict"]
    b, a = bt.keys.shape
    h = cfg.mvcc_his_len
    lanes = bt.valid & bt.active[:, None]

    # K12a, MVCC and TIMESTAMP flavours
    to_pre = TOState(rts=pre.rts, wts=pre.wts)
    err = 0
    for mvcc, state in ((True, pre), (False, to_pre)):
        got = timestamp._watermark_check(cfg, state, bt, mvcc)
        want = timestamp._watermark_check_plain(cfg, state, bt, mvcc)
        for x, y, nm in zip(got, want, ("wm_abort", "ro")):
            if not torch.equal(x, y):
                fail(f"K12a ({'MVCC' if mvcc else 'TIMESTAMP'}) {nm} "
                     "differs from plain")
            err = max(err, max_abs(x, y))
    wm_abort = timestamp._watermark_check(cfg, pre, bt, True)[0]
    wm = timestamp._wm_bucket(cfg, bt).long()
    stale = lanes & bt.is_read & ~bt.is_write \
        & (pre.wts[wm] > bt.ts[:, None])
    touched = int(torch.unique(wm[lanes]).numel())
    touched_w = int(torch.unique(wm[lanes & bt.is_write]).numel())
    his_rows = int(torch.unique(wm[stale]).numel())
    n_act, n_lanes = int(bt.active.sum()), int(lanes.sum())
    rec["K12a_watermark_check"].update(
        max_abs_err=err,
        ms=cuda_ms(lambda: timestamp._watermark_check(cfg, pre, bt, True)),
        plain_ms=cuda_ms(lambda: timestamp._watermark_check_plain(
            cfg, pre, bt, True), iters=5), library_ms=None)
    # active per txn, valid per lane of an active txn; table id, key and
    # the two flags per live lane, ts per active txn; wts per touched
    # bucket, rts per written one, a ring row per stale pure read's
    # bucket; two flags out per txn
    bound(rec["K12a_watermark_check"],
          b + a * n_act + 10 * n_lanes + 4 * n_act + 4 * touched
          + 4 * touched_w + 4 * h * his_rows + 2 * b, 30 * n_lanes)
    print(f"[K12a] active={int(bt.active.sum())} "
          f"wm_aborts={int((wm_abort & bt.active).sum())} "
          f"stale_pure_reads={int(stale.sum())} touched_buckets={touched}",
          flush=True)

    # K12b on clones of the pre-epoch state, against plain and against the
    # state the real epoch left
    commit = v.commit
    err = 0
    for mvcc in (True, False):
        base = pre if mvcc else to_pre
        got = timestamp._commit_watermarks(cfg, clone_cc(base), bt, commit)
        want = timestamp._commit_watermarks_plain(cfg, base, bt, commit)
        if not same_state(got, want):
            fail(f"K12b ({'MVCC' if mvcc else 'TIMESTAMP'}) differs from "
                 "plain")
        if mvcc and (got.scratch.any() or not same_state(got, st.cc_state)):
            fail("K12b: scratch not zero, or differs from the epoch's state")
        err = max(err, max(max_abs(getattr(got, f), getattr(want, f))
                           for f in ("rts", "wts")))
    cl = clone_cc(pre)
    committed = lanes & commit[:, None]
    flat = wm.reshape(-1)
    tsl = bt.ts[:, None].expand(b, a)
    r_ts = torch.where(committed & bt.is_read, tsl, 0).reshape(-1)
    w_ts = torch.where(committed & bt.is_write, tsl, 0).reshape(-1)
    lib_r, lib_w = pre.rts.clone(), pre.wts.clone()

    def lib():
        lib_r.scatter_reduce_(0, flat, r_ts, "amax")
        lib_w.scatter_reduce_(0, flat, w_ts, "amax")
    lib()
    if not (torch.equal(lib_r, st.cc_state.rts)
            and torch.equal(lib_w, st.cc_state.wts)):
        fail("K12b: watermarks differ from scatter_reduce_")
    rb = int(torch.unique(wm[committed & bt.is_read]).numel())
    wb = int(torch.unique(wm[committed & bt.is_write]).numel())
    n_com, n_cl = int(commit.sum()), int(committed.sum())
    rec["K12b_commit_watermarks"].update(
        max_abs_err=err,
        ms=cuda_ms(lambda: timestamp._commit_watermarks(cfg, cl, bt, commit)),
        plain_ms=cuda_ms(lambda: timestamp._commit_watermarks_plain(
            cfg, pre, bt, commit), iters=5),
        library_ms=cuda_ms(lib))
    # commit per txn, valid per lane of a committed txn; table id, key
    # and the two flags per committed lane, ts per committed txn; rts
    # read and written per read bucket, wts per written bucket, and
    # there one ring entry written and its cursor read and written
    bound(rec["K12b_commit_watermarks"],
          b + a * n_com + 10 * n_cl + 4 * n_com + 8 * rb + 8 * wb
          + 12 * wb, 20 * n_cl)
    print(f"[K12b] committed={int(commit.sum())} read_buckets={rb} "
          f"written_buckets={wb} (scatter_reduce_ amax covers rts/wts only)",
          flush=True)

    # K12c in both table modes, on the captured lanes and ring
    f0, ring, keys, slots, rmask, ver_ts, cap = seen["read"]
    _, newer = ring.select_version(slots, ver_ts[:, None].expand(
        slots.shape))
    newer &= rmask
    nr, n_new = int(rmask.sum()), int(newer.sum())
    read_txns = int(rmask.any(dim=1).sum())
    ring_rows = int(torch.unique(slots[rmask]).numel())
    f0_rows = int(torch.unique(slots[rmask & ~newer]).numel())
    full_cfg = config(True, field_per_tuple=1)
    f0_full = YCSBWorkload(full_cfg, device=dev).load()[
        "MAIN_TABLE"].columns["F0"]
    err = 0
    for mode, col in (("fingerprint", f0), ("full_row", f0_full)):
        got = ycsb._versioned_read_f0(col, ring, keys, slots, rmask, ver_ts,
                                      cap)
        want = ycsb._versioned_read_f0_plain(col, ring, keys, slots, rmask,
                                             ver_ts, cap)
        if int(got) != int(want):
            fail(f"K12c ({mode}) checksum {int(got)} != plain {int(want)}")
        row = col.shape[1] if col.ndim == 2 else 4
        t_k = cuda_ms(lambda: ycsb._versioned_read_f0(
            col, ring, keys, slots, rmask, ver_ts, cap))
        t_p = cuda_ms(lambda: ycsb._versioned_read_f0_plain(
            col, ring, keys, slots, rmask, ver_ts, cap), iters=5)
        r = {"max_abs_err": abs(int(got) - int(want)), "ms": t_k,
             "plain_ms": t_p, "library_ms": None}
        # rmask per lane; slot per committed read, key per read served
        # from the ring, ts per reading txn; a ring row per distinct
        # slot read, an F0 row per distinct slot read from the table;
        # the checksum out
        bound(r, rmask.numel() + 4 * nr + 4 * n_new + 4 * read_txns
              + 4 * h * ring_rows + row * f0_rows + 4,
              10 * nr + 8 * (row // 4) * n_new)
        if mode == "fingerprint":
            rec["K12c_version_read"].update(r)
        print_kernel(f"K12c_version_read[{mode}]", r, card)
    print(f"[K12c] committed_reads={nr} served_from_ring={n_new} "
          f"reading_txns={read_txns} ring_rows={ring_rows} "
          f"table_rows={f0_rows}", flush=True)
    del f0_full
    torch.cuda.empty_cache()

    # K12d on clones of the ring before the push
    ring0, wslots, worder, win = seen["push"]
    kr = VersionRing(ring0.wts.clone(), ring0.depth).push(wslots, worder,
                                                          win)
    pr = VersionRing(ring0.wts.clone(), ring0.depth).push_plain(
        wslots, worder, win)
    if not torch.equal(kr.wts, pr.wts) \
            or not torch.equal(kr.wts, st.db[ycsb.VER_TABLE].wts):
        fail("K12d ring differs from plain or from the epoch's ring")
    tk = VersionRing(ring0.wts.clone(), ring0.depth)
    tp = VersionRing(ring0.wts.clone(), ring0.depth)
    nw = int(win.sum())
    rec["K12d_version_push"].update(
        max_abs_err=max_abs(kr.wts, pr.wts),
        ms=cuda_ms(lambda: tk.push(wslots, worder, win)),
        plain_ms=cuda_ms(lambda: tp.push_plain(wslots, worder, win)),
        library_ms=None)
    # the flag per lane; slot and order per winner, its ring row read
    # and one entry written
    bound(rec["K12d_version_push"], win.numel() + (8 + 4 * h + 4) * nw,
          nw * 2 * h)
    print(f"[K12d] winners={nw} ring_wraps={wraps}", flush=True)

    # WAIT_DIE's min_owner_ts: plain [B, B] glue on the edges
    inc = conflict.hashed_incidence(bt.table_ids, bt.keys, bt.is_read,
                                    bt.is_write, bt.valid, bt.active, None,
                                    BUCKETS, 2, ("u", "w"))[0]
    uw = conflict.overlap(inc[0]["u"], inc[0]["w"], inc[1]["u"],
                          inc[1]["w"])
    c = uw | uw.T
    win2 = conflict.first_fit(c, bt.rank, bt.active, cfg.sweep_rounds)[0]

    def glue():
        blockers = conflict.earlier_edges(c, bt.rank, bt.active) \
            & win2[None, :]
        return torch.where(blockers, bt.ts[None, :], 2**31 - 1).amin(dim=1)
    print(f"[glue] WAIT_DIE min_owner_ts at B={b}: {cuda_ms(glue):.4f} ms "
          f"(plain PyTorch; card {card})", flush=True)
    for nm in ("K12a_watermark_check", "K12b_commit_watermarks",
               "K12d_version_push"):
        print_kernel(nm, rec[nm], card)


def epochs_equal(dev, cfg, n: int, label: str):
    """``n`` epochs through the kernels equal ``n`` through the plain
    versions, every leaf but the table's trash row (the sweep path's
    losers write it in an unspecified order); K12b's scratch is all
    zeros after the kernel epochs.  Returns the kernel engine and its
    state."""
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import TABLE, YCSBWorkload
    t = time.monotonic()
    wl_k, wl_p = YCSBWorkload(cfg, device=dev), YCSBWorkload(cfg, device=dev)
    eng_k, eng_p = Engine(cfg, wl_k), Engine(cfg, wl_p)
    sk = eng_k.init_state()
    sp = copy.deepcopy(sk)
    sk = eng_k.run(sk, n)
    with plain_path(wl_p):
        sp = eng_p.run(sp, n)
    torch.cuda.synchronize()
    lk, lp = state_leaves(sk), state_leaves(sp)
    cap = cfg.synth_table_size
    for path, x in lk.items():
        y = lp[path]
        if path.startswith(f"db/{TABLE}/") and x.ndim:
            same = torch.equal(x[:cap], y[:cap]) \
                and torch.equal(x[cap + 1:], y[cap + 1:])
        else:
            same = torch.equal(x, y)
        if not same:
            fail(f"{label}: leaf {path} differs between kernel and plain "
                 "epochs")
    if hasattr(sk.cc_state, "scratch") and sk.cc_state.scratch.any():
        fail(f"{label}: K12b's scratch is not all zeros between epochs")
    print(f"[sweep-epochs] {label}: {n} kernel epochs == {n} plain epochs "
          f"({len(lk)} leaves; commits "
          f"{int(sk.stats['total_txn_commit_cnt'])}, aborts "
          f"{int(sk.stats['total_txn_abort_cnt'])}, defers "
          f"{int(sk.stats['defer_cnt'])}) in {time.monotonic() - t:.1f} s",
          flush=True)
    return eng_k, sk


def phase_lock_to_epochs(dev) -> None:
    for alg, full in (("NO_WAIT", False), ("WAIT_DIE", False),
                      ("TIMESTAMP", False), ("MVCC", False), ("MVCC", True)):
        mode = "full_row" if full else "fingerprint"
        epochs_equal(dev, skew_config(full, alg), 3, f"{alg} {mode}")
        torch.cuda.empty_cache()
    for alg in ("NO_WAIT", "WAIT_DIE"):
        for level in ("READ_COMMITTED", "READ_UNCOMMITTED", "NOLOCK"):
            epochs_equal(dev, skew_config(False, alg, isolation_level=level),
                         1, f"{alg} {level}")


def to_oracle_epoch(eng, state, dev):
    """One TIMESTAMP or MVCC kernel epoch against numpy: the watermark
    rules per lane give the aborts; among the rest (less MVCC's read-only
    txns) serial admission in (ts, lane) order, a reader waiting behind
    any admitted earlier writer of a shared bucket (both families), gives
    the commits; the new watermarks are the committed lanes' maxima and,
    under MVCC, each written bucket's ring takes that epoch's max write
    ts at its cursor."""
    cfg = eng.cfg
    mvcc = cfg.cc_alg.value == "MVCC"
    state, seen = capture_epoch(eng, state)
    bt, pre, v = seen["batch"], seen["pre"], seen["verdict"]
    keys = bt.keys.cpu().numpy().astype(np.int64)
    isr, isw = bt.is_read.cpu().numpy(), bt.is_write.cpu().numpy()
    act = bt.active.cpu().numpy()
    ts = bt.ts.cpu().numpy().astype(np.int64)
    rts, wts = pre.rts.cpu().numpy(), pre.wts.cpu().numpy()
    b = len(ts)
    lanes = act[:, None] & np.ones_like(isw)
    wm = np_bucket(keys, 0, cfg.watermark_buckets)
    wts_at, rts_at, t = wts[wm], rts[wm], ts[:, None]
    if mvcc:
        his_min = pre.his.cpu().numpy().min(axis=1)[wm]
        pure, rmw = isr & ~isw, isr & isw
        read_bad = lanes & ((pure & (wts_at > t) & (t < his_min))
                            | (rmw & (wts_at > t)))
    else:
        read_bad = lanes & isr & (wts_at > t)
    write_bad = lanes & isw & ((rts_at > t) | (wts_at > t))
    ro = ~(lanes & isw).any(axis=1) if mvcc else np.zeros(b, bool)
    wm_abort = (read_bad | write_bad).any(axis=1) & ~ro
    commit, abort = v.commit.cpu().numpy(), v.abort.cpu().numpy()
    if not np.array_equal(abort, act & wm_abort):
        fail(f"T/O oracle ({cfg.cc_alg.value}): watermark aborts differ "
             f"({int((abort != (act & wm_abort)).sum())} txns)")
    live = act & ~wm_abort
    swept = live & ~ro
    k = cfg.conflict_buckets
    rows = np.repeat(np.arange(b), keys.shape[1])
    rw = np.ones((b, b), bool)
    for f in (0, 1):
        bk = np_bucket(keys, f, k)

        def dense(m):
            d = np.zeros((b, k), np.float32)
            d[rows[m.reshape(-1)], bk.reshape(-1)[m.reshape(-1)]] = 1
            return d
        rw &= dense(lanes & isr) @ dense(lanes & isw).T > 0
    admitted = np.zeros(b, bool)
    for i in np.lexsort((np.arange(b), ts)):
        if swept[i] and not (rw[i] & admitted).any():
            admitted[i] = True
    if (commit & swept & ~admitted).any() or (live & ro & ~commit).any():
        fail(f"T/O oracle ({cfg.cc_alg.value}): commits differ from the "
             "serial later-reader rule")
    waiting = swept & ~commit
    # new watermarks: the committed lanes' maxima
    cl = lanes & commit[:, None]
    tl = np.broadcast_to(t, keys.shape)
    for name, base, m in (("rts", rts, cl & isr), ("wts", wts, cl & isw)):
        want = base.copy()
        np.maximum.at(want, wm[m], tl[m])
        if not np.array_equal(want, getattr(state.cc_state,
                                            name).cpu().numpy()):
            fail(f"T/O oracle ({cfg.cc_alg.value}): {name} differs")
    if mvcc:
        his = pre.his.cpu().numpy().copy()
        pos = pre.pos.cpu().numpy().copy()
        ep = np.zeros_like(wts)
        np.maximum.at(ep, wm[cl & isw], tl[cl & isw])
        wb = np.nonzero(ep > 0)[0]
        his[wb, pos[wb]] = ep[wb]
        pos[wb] = (pos[wb] + 1) % his.shape[1]
        if not (np.array_equal(his, state.cc_state.his.cpu().numpy())
                and np.array_equal(pos, state.cc_state.pos.cpu().numpy())):
            fail("T/O oracle (MVCC): the boundary ring differs")
    return state, {"active": int(act.sum()), "wm_abort": int(abort.sum()),
                   "commit": int(commit.sum()),
                   "read_only": int((live & ro).sum()),
                   "waiting": int(waiting.sum()),
                   "admitted_undecided": int((admitted & ~commit).sum())}


def mvcc_history_oracle(dev) -> dict:
    """MVCC's committed reads over eleven epochs against the serial
    history since the load, kept in numpy: every committed writer's
    version of every key (its order).  A committed read of a read-write
    txn at ts is owed v*, the newest version older than ts (0 = the
    load); a read-only txn's read the newest one.  The ring stores one
    version per row and epoch, its last writer's (the fault of
    ROADMAP.md queue 3), so a read whose v* was overwritten inside its
    own epoch gets the newest stored version below ts instead.  The
    checksum must equal the serial values with exactly those reads moved
    to the stored version; the oracle counts them.  At the end every row
    of F0 holds f(key, newest)."""
    import bisect

    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import (TABLE, YCSBWorkload,
                                                 _field_fingerprint)
    cfg = skew_config(False, "MVCC")
    eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
    st = eng.init_state()
    # per key: every committed writer's order, and the ones the ring kept
    serial: dict[int, list[int]] = {}
    stored: dict[int, list[int]] = {}

    def before(vs, o):
        i = bisect.bisect_right(vs, o)
        return vs[i - 1] if i else 0
    diverging = reads = 0
    for _ in range(11):
        pre = int(st.stats["read_checksum"])
        st, seen = capture_epoch(eng, st)
        bt, v = seen["batch"], seen["verdict"]
        keys = bt.keys.cpu().numpy().astype(np.int64)
        isw = bt.is_write.cpu().numpy()
        com = (v.commit & bt.active).cpu().numpy()
        order = v.order.cpu().numpy().astype(np.int64)
        ordl = np.broadcast_to(order[:, None], keys.shape)
        # the reads, from the versions before this epoch
        rm = com[:, None] & ~isw
        want_serial = want = stale = 0
        for key, o in zip(keys[rm].tolist(), ordl[rm].tolist()):
            vs, ks = serial.get(key, []), stored.get(key, [])
            if o == 0:
                vser = vs[-1] if vs else 0
                vring = ks[-1] if ks else 0
            else:
                vser, vring = before(vs, o), before(ks, o)
                stale += bool(vs) and vs[-1] > o
            diverging += vser != vring
            reads += 1
            want_serial += int(np_fingerprint(key, vser))
            want += int(np_fingerprint(key, vring))
        got = (int(st.stats["read_checksum"]) - pre) & MASK32
        if got != want & MASK32:
            fail(f"MVCC history oracle: checksum {got} != "
                 f"{want & MASK32} (serial values: {want_serial & MASK32})")
        # this epoch's versions: every committed writer; the ring keeps
        # each written key's last one
        wm = com[:, None] & isw
        last: dict[int, int] = {}
        for key, o in zip(keys[wm].tolist(), ordl[wm].tolist()):
            last[key] = max(last.get(key, 0), o)
            if o not in serial.setdefault(key, []):
                bisect.insort(serial[key], o)
        for key, o in last.items():
            stored.setdefault(key, []).append(o)
    wk = torch.tensor(list(stored), dtype=torch.int64, device=dev)
    wv = torch.tensor([vs[-1] for vs in stored.values()],
                      dtype=torch.int64, device=dev)
    if any(serial[k][-1] != vs[-1] for k, vs in stored.items()):
        fail("MVCC history oracle: a key's newest version is not stored")
    n = cfg.synth_table_size
    expect = _field_fingerprint(torch.arange(n, device=dev), 0)
    expect[wk] = _field_fingerprint(wk, wv)
    if not torch.equal(st.db[TABLE].columns["F0"][:n].to(torch.int64)
                       & MASK32, expect):
        fail("MVCC history oracle: F0 differs from the newest versions")
    return {"keys_written": len(stored),
            "versions_hidden": sum(len(serial[k]) - len(vs)
                                   for k, vs in stored.items()),
            "reads": reads, "reads_diverging_from_serial": diverging,
            "stale_reads_last_epoch": stale,
            "max_versions_per_key": max(len(vs) for vs in stored.values())}


def phase_lock_to_oracles(dev) -> None:
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    t = time.monotonic()
    cfg = skew_config(False, "NO_WAIT")
    eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
    st = eng.run(eng.init_state(), 3)
    _, n = occ_oracle_epoch(eng, st, dev, symmetric=True)
    print(f"[oracle] NO_WAIT: serial lock acquisition ok ({n})", flush=True)
    for alg in ("TIMESTAMP", "MVCC"):
        cfg = skew_config(False, alg)
        eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
        st = eng.run(eng.init_state(), 6)
        _, n = to_oracle_epoch(eng, st, dev)
        print(f"[oracle] {alg}: watermark rules, later-reader wait and "
              f"new watermarks ok ({n})", flush=True)
        torch.cuda.empty_cache()
    n = mvcc_history_oracle(dev)
    print(f"[oracle] MVCC: every committed read over 11 epochs equals its "
          f"serial version in the numpy history, or the stored one where "
          f"the ring hid it ({n}) in "
          f"{time.monotonic() - t:.1f} s", flush=True)


# -- slice 4: the level sweeps, MAAT, the ordered index, K4b's options -------

def maat_front(cfg, bt, inc):
    """MAAT's first stages on a captured batch, through the port's own
    functions: (P, live0) — the survivors of the mutual-pair sweep."""
    from deneva_tpu_torch.cc import maat
    from deneva_tpu_torch.ops import conflict
    p = maat.must_precede(cfg, inc, bt.active.shape[0])
    _, lose, und = conflict.first_fit(p & p.T, bt.rank, bt.active,
                                      cfg.sweep_rounds)
    return p, bt.active & ~lose & ~und


def maat_points(dev, epochs: int = 60):
    """MAAT at the ``ycsb_skew`` and the ``ycsb_hot`` point, one engine
    each from a fresh state: three epochs, then epoch 4 held to the numpy
    MAAT oracle (it fails unless that epoch's level gate is set, so that
    the closure branch runs), then the remaining epochs up to ``epochs``.
    The gate of every epoch is kept on the device and read once at the
    end: how often the closure branch runs.  Returns ``ycsb_skew``'s
    config, its epoch-4 capture, P and live0 for the K9b and K11
    checks."""
    from deneva_tpu_torch.cc import maat
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    real = maat.reach_stats
    out = None
    for label, cfg in (("ycsb_skew", skew_config(False, "MAAT")),
                       ("ycsb_hot", hot_config(False))):
        t = time.monotonic()
        gates = []

        def counted(p, live, gate, *args, **kwargs):
            gates.append(gate.any())
            return real(p, live, gate, *args, **kwargs)
        eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
        maat.reach_stats = counted
        try:
            st = eng.run(eng.init_state(), 3)
            st, n, cap = maat_oracle_epoch(eng, st, dev)
            if not n.pop("closure"):
                fail(f"MAAT at {label}: epoch 4 did not take the closure "
                     "branch")
            print(f"[oracle] MAAT at {label}, epoch 4 (closure branch): "
                  f"mutual pairs, serial admission, linear extension, "
                  f"acyclic survivors commit, serial apply ok ({n})",
                  flush=True)
            eng.run(st, epochs - 4)
        finally:
            maat.reach_stats = real
        # reach_stats runs twice per epoch, both times on the epoch's gate
        closure = int(torch.stack(gates[::2]).sum())
        print(f"[K11] MAAT at {label}: the closure branch ran in {closure} "
              f"of {epochs} epochs from a fresh state "
              f"({time.monotonic() - t:.1f} s)", flush=True)
        if out is None:
            out = (cfg, *cap)
        del eng, st
        torch.cuda.empty_cache()
    return out


def closure_library(p, live, k: int):
    """The reference's closure as it runs on the MXU: ``k`` squarings of
    a bf16 copy by ``torch.matmul``, then the diagonal and the column
    sums.  ``chip_smoke``'s yardstick only."""
    r = p & live[:, None] & live[None, :]
    for _ in range(k):
        f = r.to(torch.bfloat16)
        r = r | (torch.matmul(f, f) > 0)
    return torch.diagonal(r) & live, r.sum(dim=0, dtype=torch.int32)


def k11_call(p, live, gate, b: int, label: str, card: str,
             counts: bool = True):
    """One K11a call checked against ``reach_stats_plain`` and the bf16
    ``torch.matmul`` closure at each residual group size, and timed
    beside them; prints the strongly connected set the candidates found
    and the levels each residual group took.  Returns the kernel's
    (self_reach, anc) and its largest difference from plain over the
    group sizes (the diagonal, and the counts where they are made)."""
    from deneva_tpu_torch.cc import maat
    srp, ancp = maat.reach_stats_plain(p, live, gate, counts)
    k = max(1, (b - 1).bit_length())
    sl, al = closure_library(p, live, k)
    if not bool(gate.any()):
        sl, al = torch.zeros_like(sl), torch.zeros_like(al)
    g0 = maat.reach_group(b)
    times, out, err = {}, None, 0
    for group in (g for g in (32, 16) if g <= g0):
        lv = torch.zeros(-(-b // group), dtype=torch.int32, device=p.device)
        st = torch.zeros(4, dtype=torch.int32, device=p.device)
        sr, anc = maat.reach_stats(p, live, gate, counts, group=group,
                                   levels=lv, stats=st)
        err = max(err, max_abs(sr, srp),
                  max_abs(anc, ancp) if counts else 0)
        if not (torch.equal(sr, srp) and torch.equal(sr, sl)):
            fail(f"K11a {label} (group {group}): the diagonal differs from "
                 "plain or from the bf16 torch.matmul closure")
        if counts and not (torch.equal(anc, ancp) and torch.equal(anc, al)):
            fail(f"K11a {label} (group {group}): the counts differ from "
                 "plain or from the bf16 torch.matmul closure")
        times[group] = cuda_ms(lambda: maat.reach_stats(
            p, live, gate, counts, group=group))
        if group == g0:
            out = (sr, anc)
            levels, stats = lv.tolist(), st.tolist()
    lib = cuda_ms(lambda: closure_library(p, live, k), iters=5)
    busy = [x for x in levels if x]
    print(f"[K11] K11a {label}: B={b} live={int(live.sum())} "
          f"gate={int(gate.sum())} "
          f"edges={int((p & live[:, None] & live[None, :]).sum())} "
          f"self_reach={int(out[0].sum())} "
          f"reach_bits={int(ancp.sum()) if counts else 'not counted'}; "
          f"candidate {stats[0]}: strongly connected set {stats[1]}, its "
          f"search {stats[3]} levels; residual {stats[2]} txns in "
          f"{len(busy)} groups of {g0}, levels {busy}; ms by group: "
          + ", ".join(f"{g} {t:.4f}" for g, t in times.items())
          + f"; bf16 torch.matmul {lib:.4f} (card {card})", flush=True)
    return (*out, err)


def k11_graphs(b: int, seed: int = 0) -> dict:
    """Structured graphs for K11a over B = ``b`` txns (bool P, live,
    gate, on the CPU): a ring with chords (one strongly connected set), a
    DAG of chains 100 deep (past ``sweep_rounds``) with forward edges,
    disjoint 2- and 3-cycles, a chain of all B txns, a sparse live set, an
    empty one, and the gate off."""
    g = np.random.default_rng(seed)
    i = np.arange(b)
    gate = np.zeros(b, bool)
    gate[b // 2] = True
    out = {}
    ring = np.zeros((b, b), bool)
    ring[i, (i + 1) % b] = True
    ring[i[::5], (i[::5] + 7) % b] = True
    out["ring"] = ring
    dag = np.zeros((b, b), bool)
    ch = i[:-1][(i[:-1] + 1) % 100 != 0]
    dag[ch, ch + 1] = True
    fw = g.random((b, b)) < min(0.5, 2.0 / b)
    dag |= np.triu(fw, 1)
    out["dag"] = dag
    cyc = np.zeros((b, b), bool)
    for j in range(0, b - 4, 5):
        cyc[j, j + 1] = cyc[j + 1, j] = True
        cyc[j + 2, j + 3] = cyc[j + 3, j + 4] = cyc[j + 4, j + 2] = True
    out["cycles23"] = cyc
    chain = np.zeros((b, b), bool)
    chain[i[:-1], i[:-1] + 1] = True
    out["chain"] = chain
    rnd = g.random((b, b)) < min(0.5, 3.0 / b)
    np.fill_diagonal(rnd, False)
    res = {nm: (torch.from_numpy(m), torch.ones(b, dtype=torch.bool),
                torch.from_numpy(gate)) for nm, m in out.items()}
    res["sparse_live"] = (torch.from_numpy(rnd),
                          torch.from_numpy(g.random(b) < 0.05),
                          torch.from_numpy(gate))
    res["empty_live"] = (torch.from_numpy(rnd),
                         torch.zeros(b, dtype=torch.bool),
                         torch.from_numpy(gate))
    res["gate_off"] = (torch.from_numpy(rnd), torch.ones(b, dtype=torch.bool),
                       torch.zeros(b, dtype=torch.bool))
    return res


def k11_structured(dev, card: str, b: int = SKEW_BATCH) -> None:
    """K11a on `k11_graphs` at B = ``b``: each group size against plain
    and the bf16 closure, timed, with the levels each group took."""
    for nm, (p, live, gate) in k11_graphs(b).items():
        k11_call(p.to(dev), live.to(dev), gate.to(dev), b, f"graph {nm}",
                 card)


def tpcc_maat_reach(dev, card: str, epochs: int = 60) -> dict:
    """K11a's two calls of the first epoch, in ``epochs`` of MAAT at the
    ``tpcc_escrow`` point of 4 warehouses from a fresh state, whose level
    gate is set, each checked and timed by `k11_call`.  Returns those
    calls' (p, live, gate) by label, or none when the closure branch ran
    in no epoch."""
    from deneva_tpu_torch.cc import maat
    real, calls = maat.reach_stats, []

    def grab(p, live, gate, *args, **kwargs):
        calls.append((p, live, gate))
        return real(p, live, gate, *args, **kwargs)
    eng = tpcc_engine(dev, tpcc_config(4, "MAAT"))
    maat.reach_stats = grab
    try:
        eng.run(eng.init_state(), epochs)
    finally:
        maat.reach_stats = real
    # two calls per epoch, both on the epoch's gate
    hits = [e for e in range(epochs) if bool(calls[2 * e][2].any())]
    print(f"[K11] MAAT at tpcc 4wh: the closure branch ran in {len(hits)} "
          f"of {epochs} epochs from a fresh state", flush=True)
    out = {}
    if hits:
        e = hits[0]
        for j, what in ((0, "first call, over live0"),
                        (1, "second call, over live0 & ~aborted")):
            p, live, gate = calls[2 * e + j]
            label = f"tpcc 4wh epoch {e + 1} {what}"
            k11_call(p, live, gate, p.shape[0], label, card)
            out[label] = (p, live, gate)
    del eng, calls
    torch.cuda.empty_cache()
    return out


def _peel_on_bits(maat):
    """K11b as the path runs it: where ``maat.peel`` takes K11a's bits, on
    those of K11a's call over the input's live0, packed once an input (the
    cache holds the input, so no other tensor takes its address); an
    earlier tree's ``maat.peel``, which packs P itself, as it is."""
    import inspect
    if "bits" not in inspect.signature(maat.peel).parameters:
        return maat.peel
    packed = {}

    def run(p, live0, oc, rank, rounds, peel_rounds, gate):
        key = (p.data_ptr(), live0.data_ptr(), gate.data_ptr())
        if key not in packed:
            packed[key] = (p, live0, gate, k11a_bits(p, live0, gate))
        return maat.peel(p, live0, oc, rank, rounds, peel_rounds, gate,
                         bits=packed[key][3])
    return run


def _port_calls() -> dict:
    """kind -> (the kernel's wrapper, its plain version), from whichever
    ``deneva_tpu_torch`` is on the path."""
    import functools
    from deneva_tpu_torch.cc import dgcc, maat
    from deneva_tpu_torch.ops import conflict, forward, scatter
    return {"K9b": (conflict.precedence_levels,
                    conflict.precedence_levels_plain),
            "K18a": (forward.mc_slice_defer, forward.mc_slice_defer_plain),
            "K11a": (maat.reach_stats, maat.reach_stats_plain),
            "K11b": (_peel_on_bits(maat), maat.peel_plain),
            "K2": (forward.plan_scans, forward.plan_scans_plain),
            "K8": (conflict.first_fit, conflict.first_fit_plain),
            "K16": (dgcc.relax, dgcc.relax_plain),
            "K3": (k3_run, functools.partial(k3_run, plain=True)),
            "K13b": (k13b_run, functools.partial(k13b_run, plain=True)),
            "K4b": (k4b_run, functools.partial(k4b_run, plain=True)),
            "K10": (scatter.last_writer, scatter.last_writer_plain)}


# keywords of a kind's check call: K3 writes its table in place, so its
# kernel and plain version each start from a fresh copy of the table
_CHECK_KW = {"K3": {"fresh": True}}


def _outputs(r) -> tuple:
    if hasattr(r, "fwd"):               # a ForwardPlan
        return (r.keys, r.rank, r.is_read, r.is_write, r.fwd, r.win)
    return (r,) if torch.is_tensor(r) else tuple(r)


_K3_TABLES: dict = {}


def k3_table(full: int, dev, fresh: bool = False) -> tuple:
    """(F0 column, capacity) of the 2^24-row table as the loader makes it
    (fingerprint or full rows): one working copy per mode that timed calls
    write, or with ``fresh`` a new copy of the loaded table."""
    from deneva_tpu_torch.workloads.ycsb import TABLE, YCSBWorkload
    if full not in _K3_TABLES:
        tab = YCSBWorkload(config(bool(full), field_per_tuple=1),
                           device=dev).load()[TABLE]
        f0 = tab.columns["F0"]
        _K3_TABLES[full] = (f0, f0.clone(), tab.capacity)
    loaded, work, cap = _K3_TABLES[full]
    return (loaded.clone() if fresh else work), cap


def k3_run(full: int, keys, rank, is_read, is_write, fwd, win, slots,
           plain: bool = False, fresh: bool = False):
    """K3 (or its plain version) on a sorted plan's fields over the
    2^24-row table of ``k3_table``, as the forwarding path calls it."""
    from deneva_tpu_torch.ops.forward import ForwardPlan
    from deneva_tpu_torch.workloads import ycsb
    f0, cap = k3_table(full, keys.device, fresh)
    p = ForwardPlan(keys=keys, rank=rank, is_read=is_read, is_write=is_write,
                    fwd=fwd, win=win, perm=None)
    fn = ycsb._forward_execute_f0_plain if plain else ycsb._forward_execute_f0
    return fn(f0, p, slots, cap, mono=True)


def vs_parent(inputs: dict, root: str, card: str, tag: str) -> None:
    """The kernels of the checkout at ``root`` (the parent commit) beside
    this tree's on the same inputs (label -> (kind, args)), in the order
    parent, this, this, parent.  The parent runs in a child process that
    imports its own package (``--parent-child``)."""
    import os
    import tempfile
    calls = _port_calls()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as d:
        f = os.path.join(d, "parent_inputs.pt")
        torch.save({k: (kind, tuple(t.cpu() if torch.is_tensor(t) else t
                                    for t in args))
                    for k, (kind, args) in inputs.items()}, f)

        def parent():
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--parent-child", root, f],
                               capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                fail(f"the kernels of the parent at {root}: "
                     f"{r.stderr[-2000:]}")
            return json.loads(r.stdout.strip().splitlines()[-1])

        def this():
            return {k: cuda_ms(lambda fn=calls[kind][0], a=args: fn(*a))
                    for k, (kind, args) in inputs.items()}
        runs = [parent(), this(), this(), parent()]
    for k in inputs:
        a, b, c, e = (r[k] for r in runs)
        print(f"[{tag}-parent] {k}: ms parent {a:.4f}, this {b:.4f}, this "
              f"{c:.4f}, parent {e:.4f} (card {card})", flush=True)


def parent_child(root: str, path: str) -> int:
    """``--parent-child``: the kernels of the package at ``root`` on the
    inputs at ``path``, each checked against that package's plain version
    and timed; prints the times by label as one JSON line."""
    import os
    sys.path.insert(0, os.path.abspath(root))
    calls = _port_calls()
    from deneva_tpu_torch import kernels
    if not kernels.__file__.startswith(os.path.abspath(root)):
        fail(f"--parent-child imported {kernels.__file__}, not the tree at "
             f"{root}")
    dev = torch.device("cuda", 0)
    out = {}
    for k, (kind, v) in torch.load(path).items():
        args = tuple(t.to(dev) if torch.is_tensor(t) else t for t in v)
        fn, plain = calls[kind]
        kw = _CHECK_KW.get(kind, {})
        if not all(torch.equal(x, y) for x, y in zip(
                _outputs(fn(*args, **kw)), _outputs(plain(*args, **kw)))):
            fail(f"{kind} of the tree at {root} differs from its plain "
                 f"version on {k}")
        out[k] = cuda_ms(lambda: fn(*args))
    print(json.dumps(out), flush=True)
    return 0


def phase_slice4_kernels(dev, rec: dict, card: str) -> None:
    """K9a on a ``modes`` epoch's edges; K9b, K11a and K11b on a real
    MAAT epoch's P in which the closure branch runs; K14b over 655,360
    queries on the 2^24-entry index with misses mixed in; K4b with HOT
    keys, ``key_order`` and ``txn_write_perc=0.25`` at 65,536 x 10.
    Each exactly against its plain version."""
    from deneva_tpu_torch.cc import maat
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.ops import conflict, prng
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    b = SKEW_BATCH

    # K9a on the conflicts of a TPU_BATCH epoch under SIMPLE (theta 0.6)
    cfg = modes_config("SIMPLE")
    eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
    st = eng.run(eng.init_state(), 5)
    seen, real = {}, conflict.wavefront

    def grab(uw, rank, active, max_level):
        seen["args"] = (uw, rank, active, max_level)
        return real(uw, rank, active, max_level)
    conflict.wavefront = grab
    try:
        eng.step(st)
    finally:
        conflict.wavefront = real
    args = seen["args"]
    got, want = conflict.wavefront(*args), conflict.wavefront_plain(*args)
    for x, y, nm in zip(got, want, ("levels", "overflow")):
        if not torch.equal(x, y):
            fail(f"K9a {nm} differs from plain")
    uw, rank, active, ml = args
    nnz = int(conflict.earlier_edges(uw | uw.T, rank, active).sum())
    rec["K9a_wavefront_levels"].update(
        max_abs_err=max(max_abs(x, y) for x, y in zip(got, want)),
        ms=cuda_ms(lambda: conflict.wavefront(*args)),
        plain_ms=cuda_ms(lambda: conflict.wavefront_plain(*args), iters=5),
        library_ms=None)
    # the conflicts, ranks and flags in, levels and flags out; the earlier
    # test per pair, one relaxation per edge
    bound(rec["K9a_wavefront_levels"], b * b + 5 * b + 5 * b,
          b * b + 2 * nnz)
    print(f"[K9a] modes epoch (TPU_BATCH, SIMPLE, theta 0.6): edges={nnz} "
          f"max_level={ml} overflow={int(got[1].sum())} levels="
          f"{torch.bincount(got[0].long()).tolist()}", flush=True)
    del eng, st, seen, args, uw
    torch.cuda.empty_cache()

    # K9b, K11a, K11b on a MAAT epoch in which the closure branch runs
    cfg, cap, p, live0 = maat_points(dev)
    rounds, peel_rounds = cfg.sweep_rounds, cfg.maat_peel_rounds
    rank = cap["batch"].rank
    lv, un = conflict.precedence_levels(p, live0, rounds)
    lvp, unp = conflict.precedence_levels_plain(p, live0, rounds)
    if not (torch.equal(lv, lvp) and torch.equal(un, unp)):
        fail("K9b differs from plain")
    sub = int((p & live0[:, None] & live0[None, :]).sum())
    rec["K9b_precedence_levels"].update(
        max_abs_err=max(max_abs(lv, lvp), max_abs(un, unp)),
        ms=cuda_ms(lambda: conflict.precedence_levels(p, live0, rounds)),
        plain_ms=cuda_ms(lambda: conflict.precedence_levels_plain(
            p, live0, rounds), iters=5), library_ms=None)
    bound(rec["K9b_precedence_levels"], k9b_bytes(b), 2 * sub)
    # K9b at operating_points' B = 8,192 (the L2 regime)
    (lb8, args8), = k9b_inputs(dev, K11B_SHAPES[2:]).items()
    p8, live8, _ = args8
    ms8 = k9b_case(lb8, args8, card)
    rec["K9b_precedence_levels[B=8192]"].update(
        max_abs_err=0, ms=ms8,
        plain_ms=cuda_ms(lambda: conflict.precedence_levels_plain(*args8),
                         iters=3), library_ms=None)
    bound(rec["K9b_precedence_levels[B=8192]"], k9b_bytes(8192),
          2 * int((p8 & live8[:, None] & live8[None, :]).sum()))
    del args8, p8, live8
    torch.cuda.empty_cache()
    sr, anc, err = k11_call(p, live0, un, b, "first call, over live0", card)
    err = max(err, k11_call(p, live0, un, b, "first call, over live0, no "
                            "counts", card, counts=False)[2])
    reach_bits = int(anc.sum())
    k = max(1, (b - 1).bit_length())
    rec["K11a_maat_reach"].update(
        max_abs_err=err, ms=cuda_ms(lambda: maat.reach_stats(p, live0, un)),
        plain_ms=cuda_ms(lambda: maat.reach_stats_plain(p, live0, un),
                         iters=5),
        library_ms=cuda_ms(lambda: closure_library(p, live0, k), iters=5))
    # the function's bytes: P read once, live and gate in, the flags and
    # counts out (a bit search does no arithmetic to count)
    bound(rec["K11a_maat_reach"], b * b + 2 * b + 5 * b, 0)
    ab, ms = k11b_case("ycsb_skew epoch 4",
                       (p, live0, sr, rank, rounds, peel_rounds, un), card)
    abp = maat.peel_plain(p, live0, sr, rank, rounds, peel_rounds, un)
    rec["K11b_maat_peel"].update(
        max_abs_err=max_abs(ab, abp), ms=ms,
        plain_ms=cuda_ms(lambda: maat.peel_plain(
            p, live0, sr, rank, rounds, peel_rounds, un), iters=2),
        library_ms=None)
    # K11a's bits of P's rows and columns (K11a's bound counts P), the
    # three flag vectors and the ranks in, the aborts out; each sweep
    # relaxes every live edge at least once
    bound(rec["K11b_maat_peel"], k11b_bytes(b), 2 * sub)
    left, _, err = k11_call(p, live0 & ~ab, un, b,
                            "second call, over live0 & ~aborted", card)
    rec["K11a_maat_reach"]["max_abs_err"] = max(
        rec["K11a_maat_reach"]["max_abs_err"], err)
    v = cap["verdict"]
    print(f"[K11] ycsb_skew epoch 4: live0={int(live0.sum())} "
          f"edges={sub} unstable={int(un.sum())} on_cycle={int(sr.sum())} "
          f"reach_bits={reach_bits} peeled={int(ab.sum())} "
          f"leftover={int(left.sum())}; verdict commits="
          f"{int(v.commit.sum())} aborts={int(v.abort.sum())} defers="
          f"{int(v.defer.sum())}", flush=True)
    del cap, p, live0
    torch.cuda.empty_cache()
    k11_structured(dev, card)
    tpcc_maat_reach(dev, card)

    # K14b over one forwarding epoch's lanes on the 2^24-entry index
    n = BATCH * REQ
    wl = YCSBWorkload(btree_config(), device=dev)
    idx = wl.index
    q = wl.generate(prng.split(prng.key_from_seed(17, dev))[1], BATCH)
    q = q.keys.reshape(-1).contiguous()
    q[::16] += ROWS                     # misses past the table
    q[5::64] = -1 - q[5::64]            # and below it
    got, want = idx.lookup(q), idx.lookup_plain(q)
    if not torch.equal(got, want):
        fail("K14b differs from plain")

    def lib():
        lo = torch.searchsorted(idx.keys, q).clamp_(max=idx.n - 1)
        return torch.where(idx.keys[lo] == q, idx.slots[lo], idx.miss_slot)
    if not torch.equal(lib(), got):
        fail("K14b differs from torch.searchsorted")
    hits = got != idx.miss_slot
    n_hit_rows = int(torch.unique(got[hits]).numel())
    rec["K14b_sorted_lookup"].update(
        max_abs_err=max_abs(got, want), ms=cuda_ms(lambda: idx.lookup(q)),
        plain_ms=cuda_ms(lambda: idx.lookup_plain(q)),
        library_ms=cuda_ms(lib))
    # queries in, slots out, the key and slot of each distinct hit entry
    bound(rec["K14b_sorted_lookup"], 8 * n + 8 * n_hit_rows,
          n * int(np.ceil(np.log2(idx.n))))
    print(f"[K14b] {n} queries on {idx.n} entries: hits={int(hits.sum())} "
          f"misses={int((~hits).sum())} distinct_hit_rows={n_hit_rows}",
          flush=True)
    del wl, idx
    torch.cuda.empty_cache()

    # K4b with HOT keys, key_order and the per-txn write gate
    wlh = YCSBWorkload(config(False, skew_method="HOT", data_perc=100,
                              access_perc=0.9, key_order=True,
                              txn_write_perc=0.25), device=dev)
    gk = prng.split(prng.key_from_seed(19, dev))[1]
    qh, qp = wlh.generate(gk, BATCH), wlh.generate_plain(gk, BATCH)
    if not (torch.equal(qh.keys, qp.keys)
            and torch.equal(qh.is_write, qp.is_write)):
        fail("K4b (HOT, key_order, txn_write_perc) differs from plain")
    if not bool((qh.keys[:, 1:] >= qh.keys[:, :-1]).all()):
        fail("K4b key_order: a txn's keys are not ascending")
    r = {"max_abs_err": max(max_abs(qh.keys, qp.keys),
                            max_abs(qh.is_write, qp.is_write)),
         "ms": cuda_ms(lambda: wlh.generate(gk, BATCH)),
         "plain_ms": cuda_ms(lambda: wlh.generate_plain(gk, BATCH), iters=5),
         "library_ms": None}
    # the hashes the output depends on: per element the hot draw, the
    # chosen range's randint (two) and the write flag; per txn the write
    # gate and a 10-key insertion sort
    bound(r, 16 + 5 * n, n * (4 * THREEFRY_OPS + 20)
          + BATCH * (THREEFRY_OPS + REQ * REQ))
    rec["K4b_ycsb_generate[hot]"].update(r)
    print(f"[K4b] HOT: hot_share={float((qh.keys < 100).float().mean()):.4f}"
          f" read_only_txns={int((~qh.is_write.any(dim=1)).sum())} of "
          f"{BATCH}", flush=True)
    for nm in ("K9a_wavefront_levels", "K9b_precedence_levels",
               "K9b_precedence_levels[B=8192]",
               "K11a_maat_reach", "K11b_maat_peel", "K14b_sorted_lookup",
               "K4b_ycsb_generate[hot]"):
        print_kernel(nm, rec[nm], card)


def maat_oracle_epoch(eng, state, dev):
    """One MAAT kernel epoch against numpy: P rebuilt from both hash
    families' buckets (scipy's sparse product) equals the port's; no two
    committed txns form a mutual pair, and every committed txn is one that
    serial lex-first admission over the mutual pairs admits; ``order`` is
    a linear extension of P on the committed txns; every survivor of the
    mutual stage that is on no cycle of P over the survivors (strongly
    connected components) commits, and only cycle members abort or defer
    there; table rows [0, capacity) equal the epoch-start rows with the
    committed writes applied serially in ``order``; the checksum of the
    committed reads and the counters match.  Returns the new state, the
    epoch's counts and (its capture, P, live0)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    from deneva_tpu_torch.ops import conflict
    from deneva_tpu_torch.workloads.ycsb import TABLE
    cfg = eng.cfg
    start = state.db[TABLE].columns["F0"].clone()
    pre = {k: int(state.stats[k]) for k in
           ("read_checksum", "write_cnt", "total_txn_commit_cnt")}
    state, seen = capture_epoch(eng, state)
    bt, v = seen["batch"], seen["verdict"]
    p_port, live0 = maat_front(cfg, bt, seen["inc"])
    keys = bt.keys.cpu().numpy().astype(np.int64)
    isr, isw = bt.is_read.cpu().numpy(), bt.is_write.cpu().numpy()
    lanes = bt.valid.cpu().numpy() & bt.active.cpu().numpy()[:, None]
    rank = bt.rank.cpu().numpy()
    b, k = keys.shape[0], cfg.conflict_buckets
    rows = np.repeat(np.arange(b), keys.shape[1])
    p = np.ones((b, b), bool)
    for f in (0, 1):
        bk = np_bucket(keys, f, k).reshape(-1)

        def sp(m):
            m = m.reshape(-1)
            return csr_matrix((np.ones(int(m.sum()), np.float32),
                               (rows[m], bk[m])), shape=(b, k))
        p &= (sp(lanes & isr) @ sp(lanes & isw).T).toarray() > 0
    np.fill_diagonal(p, False)
    if not np.array_equal(p, p_port.cpu().numpy()):
        fail("MAAT oracle: P differs from the numpy buckets' product")
    act = bt.active.cpu().numpy()
    com, abort, defer = (t.cpu().numpy() for t in (v.commit, v.abort,
                                                   v.defer))
    order = v.order.cpu().numpy().astype(np.int64)
    mutual = p & p.T
    admitted = np.zeros(b, bool)
    for i in np.lexsort((np.arange(b), rank)):
        if act[i] and not (mutual[i] & admitted).any():
            admitted[i] = True
    if (com & ~admitted).any() or mutual[np.ix_(com, com)].any():
        fail("MAAT oracle: a committed txn is in a mutual pair or was not "
             "admitted by the serial sweep")
    pc = p[np.ix_(com, com)]
    oc = order[com]
    if not (oc[:, None] < oc[None, :])[pc].all():
        fail("MAAT oracle: order is not a linear extension of P on the "
             "committed txns")
    l0 = live0.cpu().numpy()
    idx = np.nonzero(l0)[0]
    _, lab = connected_components(csr_matrix(p[np.ix_(idx, idx)]),
                                  directed=True, connection="strong")
    on_cycle = np.zeros(b, bool)
    on_cycle[idx] = np.bincount(lab)[lab] > 1
    if (l0 & ~on_cycle & ~com).any() or ((abort | defer) & l0
                                         & ~on_cycle).any():
        fail("MAAT oracle: a survivor on no cycle did not commit")
    # serial apply of the committed writes in order
    cm = com[:, None] & lanes
    wl, rl = cm & isw, cm & isr & ~isw
    ol = np.broadcast_to(order[:, None], keys.shape)
    wk, wo = keys[wl], ol[wl]
    srt = np.lexsort((wo, wk))
    wk, wo = wk[srt], wo[srt]
    # [:len] keeps an epoch that committed no write (ycsb_hot has them)
    last = np.r_[wk[1:] != wk[:-1], True][:len(wk)]
    win_k, win_o = wk[last], wo[last]
    expect = start.clone()
    expect[torch.from_numpy(win_k).to(dev)] = torch.from_numpy(
        np_fingerprint(win_k, win_o).view(np.int32)).to(dev)
    capy = eng.workload.n_rows
    if not torch.equal(state.db[TABLE].columns["F0"][:capy],
                       expect[:capy]):
        fail("MAAT oracle: table differs from the serial apply in order")
    vals = start[torch.from_numpy(keys[rl]).to(dev)].cpu().numpy()
    cks = int(vals.view(np.uint32).astype(np.uint64).sum()) & MASK32
    d = {k_: (int(state.stats[k_]) - pre[k_]) & MASK32 for k_ in pre}
    if d["read_checksum"] != cks or d["write_cnt"] != int(wl.sum()) \
            or d["total_txn_commit_cnt"] != int(com.sum()):
        fail(f"MAAT oracle: counters {d} (checksum want {cks})")
    closure = bool(conflict.precedence_levels_plain(
        p_port, live0, cfg.sweep_rounds)[1].any())
    return state, {"closure": closure, "active": int(act.sum()),
                   "survivors": int(l0.sum()),
                   "on_cycle": int(on_cycle.sum()), "commit": int(com.sum()),
                   "abort": int(abort.sum()), "defer": int(defer.sum()),
                   "edges": int(p.sum()), "mutual_pairs":
                   int(mutual.sum()) // 2}, (seen, p_port, live0)


def phase_slice4_epochs(dev) -> None:
    """3 kernel epochs equal 3 plain epochs for MAAT (both table modes,
    and at ycsb_hot), TPU_BATCH under SIMPLE and QRY_ONLY (the table
    untouched) and TPU_BATCH on the ordered index (then its forwarding
    oracle epoch).  The MAAT oracle runs in phase 3 (`maat_points`)."""
    from deneva_tpu_torch.workloads.ycsb import TABLE, _field_fingerprint
    for full in (False, True):
        mode = "full_row" if full else "fingerprint"
        epochs_equal(dev, skew_config(full, "MAAT"), 3, f"MAAT {mode}")
        torch.cuda.empty_cache()
    epochs_equal(dev, hot_config(False), 3, "MAAT ycsb_hot")
    torch.cuda.empty_cache()
    for mode in ("SIMPLE", "QRY_ONLY"):
        _, sk = epochs_equal(dev, modes_config(mode), 3, f"TPU_BATCH {mode}")
        f0 = sk.db[TABLE].columns["F0"][:ROWS].to(torch.int64) & MASK32
        if not torch.equal(f0, _field_fingerprint(
                torch.arange(ROWS, device=dev), 0)) \
                or int(sk.stats["write_cnt"]) != 0:
            fail(f"{mode}: the table changed")
        print(f"[modes] {mode}: F0 equals the loaded table after 3 epochs",
              flush=True)
        torch.cuda.empty_cache()
    eng, sk = epochs_equal(dev, btree_config(), 3, "TPU_BATCH IDX_BTREE")
    _, n_win, n_read = oracle_epoch(eng, sk, dev)
    print(f"[btree] forwarding oracle epoch on the ordered index ok "
          f"(reads={n_read} written_keys={n_win})", flush=True)
    del eng, sk
    torch.cuda.empty_cache()


# -- TPC-C (slice 5): the tpcc_scaling and tpcc_escrow points ----------------

def tpcc_fields() -> list[str]:
    import dataclasses

    from deneva_tpu_torch.workloads.tpcc import TPCCQuery
    return [f.name for f in dataclasses.fields(TPCCQuery)]


def tpcc_config(num_wh: int, alg: str = "TPU_BATCH", **kw):
    """``tpcc_scaling`` / ``tpcc_escrow`` of ``deneva_tpu/harness/
    experiments.py:113-131,194-215`` (the reference's ``scripts/
    experiments.py:188-235``): ``paper_base`` (``epoch_batch=2048`` over
    ``max_txn_in_flight=10000``, 8192 buckets, dual hashing) with
    ``max_accesses=32``, ``perc_payment=0.5`` and the reference's TPC-C
    defaults: 3000 customers per district, 100,000 items, 15 items per
    txn, ``insert_table_cap=2^17``, ``mpr_neworder=0.01``, the
    CUSTOMER_LAST index, escrow on.  Nothing is cut: at 64 warehouses
    the tables hold 1.92 M customers and 6.4 M stock rows."""
    from deneva_tpu_torch.config import Config
    args = ["--workload=TPCC", f"--num_wh={num_wh}", f"--cc_alg={alg}",
            "--max_accesses=32", f"--epoch_batch={SKEW_BATCH}",
            f"--max_txn_in_flight={SKEW_POOL}",
            f"--conflict_buckets={BUCKETS}", "--conflict_exact=true",
            "--perc_payment=0.5", "--seed=7"]
    args += [f"--{k}={v}" for k, v in kw.items()]
    return Config.from_args(args)


def tpcc_engine(dev, cfg):
    """An engine of ``cfg``'s workload (TPC-C or PPS) on the card."""
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads import get_workload
    return Engine(cfg, get_workload(cfg, device=dev))


def index_config(num_wh: int, alg: str = "TPU_BATCH", **kw):
    """``tpcc_order_index``'s index-on cell (``deneva_tpu/harness/
    experiments.py:304-325``): ``tpcc_config`` with the dynamic ORDER
    index and ``insert_table_cap=2^20`` (an ORDER-LINE ring of 15 x 2^20
    rows, an 8 MB index)."""
    return tpcc_config(num_wh, alg, tpcc_order_index=True,
                       insert_table_cap=1 << 20, **kw)


def pps_config(alg: str = "TPU_BATCH", **kw):
    """``pps_scaling`` (``deneva_tpu/harness/experiments.py:135-142``; the
    reference's ``scripts/experiments.py:51-59``): ``paper_base``
    (``epoch_batch=2048`` over ``max_txn_in_flight=10000``, 8192 buckets,
    dual hashing) with ``max_accesses=32`` and Deneva's PPS defaults
    (``config.h:230-242``): 10,000 parts, 1,000 products, 1,000
    suppliers, 10 parts per product, the mix GETPARTBYPRODUCT 0.34,
    ORDERPRODUCT 0.33, UPDATEPRODUCTPART 0.33.  Nothing is cut."""
    from deneva_tpu_torch.config import Config
    args = ["--workload=PPS", f"--cc_alg={alg}", "--max_accesses=32",
            f"--epoch_batch={SKEW_BATCH}", f"--max_txn_in_flight={SKEW_POOL}",
            f"--conflict_buckets={BUCKETS}", "--conflict_exact=true",
            "--seed=7"]
    args += [f"--{k}={v}" for k, v in kw.items()]
    return Config.from_args(args)


def table_clone(tab, cols=None):
    """A copy of a table's named columns (all by default) and cursor."""
    import dataclasses
    names = tab.columns if cols is None else cols
    return dataclasses.replace(
        tab, columns={c: tab.columns[c].clone() for c in names},
        row_cnt=tab.row_cnt.clone())


def capture_writes(eng, state):
    """One kernel epoch, keeping the arguments of every ``scatter_add``,
    ``scatter_add_many`` and ``append`` call (table name, slots or mask,
    values), cloned.  A ``scatter_add_many`` call is kept as ("many",
    [(table name, slots, values), ...], mask)."""
    from deneva_tpu_torch.storage import table
    from deneva_tpu_torch.storage.table import DeviceTable
    calls = []
    real_add, real_app = DeviceTable.scatter_add, DeviceTable.append
    real_many = table.scatter_add_many

    def add(tab, slots, updates, mask=None):
        calls.append(("add", tab.name, slots.clone(),
                      None if mask is None else mask.clone(),
                      {c: v.clone() for c, v in updates.items()}))
        return real_add(tab, slots, updates, mask)

    def many(adds, mask=None):
        calls.append(("many", [(tab.name, slots.clone(),
                                {c: v.clone() for c, v in up.items()})
                               for tab, slots, up in adds],
                      None if mask is None else mask.clone()))
        return real_many(adds, mask)

    def app(tab, rows, mask, anchor=None):
        calls.append(("append", tab.name, None, mask.clone(),
                      {c: v.clone() for c, v in rows.items()}))
        return real_app(tab, rows, mask, anchor)
    DeviceTable.scatter_add, DeviceTable.append = add, app
    table.scatter_add_many = many
    try:
        state = eng.step(state)
    finally:
        DeviceTable.scatter_add, DeviceTable.append = real_add, real_app
        table.scatter_add_many = real_many
    torch.cuda.synchronize()
    return state, calls


def phase_tpcc_kernels(dev, rec: dict, card: str) -> None:
    """K19 and K14a on one epoch's generation at 64 warehouses (and K14a
    on 655,360 probes with misses), K14c on a real epoch's scatter-adds
    at 64 and at 4 warehouses, K14d on each of the four tables' appends
    across a ring wrap: each exact against its plain version."""
    from deneva_tpu_torch.ops import prng
    cfg = tpcc_config(64)
    eng = tpcc_engine(dev, cfg)
    wl = eng.workload
    b, i = cfg.epoch_batch, cfg.max_items_per_txn
    key = prng.split(prng.key_from_seed(23, dev))[1]

    # K19 (with K14a and the glue it feeds) against the plain generator
    q, qp = wl.generate(key, b), wl.generate_plain(key, b)
    err = 0
    for f in tpcc_fields():
        x, y = getattr(q, f), getattr(qp, f)
        if f == "h_amount":
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            fail(f"K19: field {f} differs from plain")
        err = max(err, max_abs(x, y))
    rec["K19_tpcc_generate"].update(
        max_abs_err=err, ms=cuda_ms(lambda: wl.generate_kernel(key, b)),
        plain_ms=cuda_ms(lambda: wl.generate_plain(key, b), iters=3),
        library_ms=None)
    # per txn 23 hashes (12 draws, 4 of them randint, 2 NURand), per item
    # lane 9 (NURand, randint, Bernoulli, randint) and the dedup compares;
    # out: 8 words and a flag per txn, 3 words and a flag per item lane
    bound(rec["K19_tpcc_generate"], 16 + b * 37 + b * i * 13,
          (23 * b + 9 * b * i) * THREEFRY_OPS + b * i * i)
    in_cnt = torch.arange(i, device=dev) < q.ol_cnt[:, None]
    print(f"[K19] B={b}: payments={int((q.txn_type == 0).sum())} "
          f"remote_customers={int((q.c_w_id != q.w_id).sum())} "
          f"items_valid={int(q.item_valid.sum())} of {int(in_cnt.sum())} "
          f"remote_supply={int((q.supply_w != q.w_id[:, None]).sum())}",
          flush=True)

    # K14a on the epoch's probes, then on 655,360 with misses
    _, probe, use_mid = wl.generate_kernel(key, b)
    idx = wl.last_idx
    got, want = idx.lookup(probe), idx.lookup_plain(probe)
    if not torch.equal(got, want):
        fail("K14a differs from plain on the epoch's probes")
    rec["K14a_hash_lookup"].update(
        max_abs_err=max_abs(got, want), ms=cuda_ms(lambda: idx.lookup(probe)),
        plain_ms=cuda_ms(lambda: idx.lookup_plain(probe)), library_ms=None)
    # probes in, slots out, the key and slot of each home cell
    bound(rec["K14a_hash_lookup"], 16 * b, 20 * b)
    g = torch.Generator(device=dev).manual_seed(29)
    top = int(idx.keys.max()) + 1
    big = torch.randint(0, top + top // 4, (BATCH * REQ,), generator=g,
                        device=dev, dtype=torch.int32)
    gb, wb = idx.lookup(big), idx.lookup_plain(big)
    if not torch.equal(gb, wb):
        fail("K14a differs from plain on 655,360 probes")
    print(f"[K14a] {b} epoch probes: by_last_payments={int(use_mid.sum())}; "
          f"{big.numel()} probes ({int((gb == idx.miss_slot).sum())} "
          f"misses) on {int((idx.keys >= 0).sum())} keys in {idx.cap} "
          f"cells, max_probe {idx.max_probe}: "
          f"{cuda_ms(lambda: idx.lookup(big)):.4f} ms (plain "
          f"{cuda_ms(lambda: idx.lookup_plain(big)):.4f}; K14b on 655,360 "
          f"probes of 2^24 entries {rec['K14b_sorted_lookup']['ms']:.4f}; "
          f"card {card})", flush=True)
    del big, gb, wb

    # K14c and K14d on a real epoch's calls (after two warm-up epochs)
    state = eng.run(eng.init_state(), 2)
    state, calls = capture_writes(eng, state)
    k14c_cases(dev, state, calls, rec, card, "64wh")
    eng4 = tpcc_engine(dev, tpcc_config(4))
    s4, calls4 = capture_writes(eng4, eng4.run(eng4.init_state(), 2))
    k14c_cases(dev, s4, calls4, None, card, "4wh")
    del eng4, s4, calls4
    k14d_cases(dev, state, calls, rec, card)
    for nm in ("K19_tpcc_generate", "K14a_hash_lookup", "K14c_scatter_add",
               "K14d_append"):
        print_kernel(nm, rec[nm], card)


def k14c_bytes(slots, mask, vals, cap) -> tuple[int, int, int, int]:
    """(bytes, operations, live lanes, touched rows) of one table's adds:
    slot and mask of every lane in, the values of live lanes only, each
    touched row read and written once per column."""
    live = (mask if mask is not None else torch.ones_like(
        slots, dtype=torch.bool)) & (slots >= 0) & (slots < cap)
    nl = int(live.sum())
    rows = int(torch.unique(slots[live]).numel())
    k = len(vals)
    return slots.numel() * 5 + 4 * nl * k + rows * 8 * k, nl * k, nl, rows


def same_cols(a, p, vals, cap, what: str) -> int:
    """Rows [0, cap) of each added column equal, floats as bits; the pad
    rows too.  Returns the max abs difference (0)."""
    err = 0
    for c in vals:
        x, y = a.columns[c], p.columns[c]
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not (torch.equal(x[:cap], y[:cap])
                and torch.equal(x[cap + 1:], y[cap + 1:])):
            fail(f"{what}: column {c} differs")
        err = max(err, max_abs(x[:cap], y[:cap]))
    return err


def k14c_cases(dev, state, calls, rec, card, label) -> None:
    """Each table's first scatter-add of the epoch (level 0) replayed on
    clones through K14c and its plain version; the DISTRICT D_YTD call at
    64 warehouses is the kernel's record, with ``index_put_(accumulate=
    True)`` on the live lanes as the one-call yardstick.  Then the
    epoch's first Payment launch (``scatter_add_many``, three tables)
    against its plain version, against the three one-table calls, and
    against ``index_put_`` per column."""
    from deneva_tpu_torch.storage import table
    ones = []
    for c in calls:
        if c[0] == "add":
            ones.append(c[1:])
        elif c[0] == "many":
            ones += [(nm, sl, c[2], v) for nm, sl, v in c[1]]
    seen = set()
    for name, slots, mask, vals in ones:
        tag = (name, tuple(vals))
        if tag in seen:
            continue
        seen.add(tag)
        tab = state.db[name]
        a, p = table_clone(tab, vals), table_clone(tab, vals)
        a.scatter_add(slots, vals, mask=mask)
        p.scatter_add_plain(slots, vals, mask=mask)
        cap = tab.capacity
        err = same_cols(a, p, vals, cap, f"K14c ({label} {name})")
        live = (mask if mask is not None else torch.ones_like(slots,
                dtype=torch.bool)) & (slots >= 0) & (slots < cap)
        s_live = slots[live].long()
        v_live = {c: v[live] for c, v in vals.items()}
        seg = int(torch.bincount(s_live).max()) if s_live.numel() else 0
        r = {"max_abs_err": err,
             "ms": cuda_ms(lambda: a.scatter_add(slots, vals, mask=mask)),
             "plain_ms": cuda_ms(lambda: p.scatter_add_plain(
                 slots, vals, mask=mask), iters=3),
             "library_ms": cuda_ms(lambda: [
                 a.columns[c].index_put_((s_live,), v_live[c],
                                         accumulate=True)
                 for c in vals])}
        nb, ops, nl, rows = k14c_bytes(slots, mask, vals, cap)
        bound(r, nb, ops)
        print(f"[K14c] {label} {name} {'+'.join(vals)}: lanes="
              f"{slots.numel()} live={nl} rows={rows} longest_segment={seg}"
              f" passes={-(-cap.bit_length() // 8)} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} index_put_ms="
              f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.6f} "
              f"({r['bound_by']}; card {card})", flush=True)
        if rec is not None and tag == ("DISTRICT", ("D_YTD",)):
            rec["K14c_scatter_add"].update(r)
    _, adds, mask = next(c for c in calls if c[0] == "many")
    tabs = {nm: state.db[nm] for nm, _, _ in adds}
    ka = {nm: table_clone(t, v) for (nm, _, v), t in zip(adds, tabs.values())}
    kp = {nm: table_clone(t, v) for (nm, _, v), t in zip(adds, tabs.values())}
    ko = {nm: table_clone(t, v) for (nm, _, v), t in zip(adds, tabs.values())}
    table.scatter_add_many([(ka[nm], sl, v) for nm, sl, v in adds], mask)
    table.scatter_add_many_plain([(kp[nm], sl, v) for nm, sl, v in adds],
                                 mask)
    for nm, sl, v in adds:
        ko[nm].scatter_add(sl, v, mask=mask)
    for nm, _, v in adds:
        cap = tabs[nm].capacity
        same_cols(ka[nm], kp[nm], v, cap, f"K14c {label} many {nm} vs plain")
        same_cols(ka[nm], ko[nm], v, cap,
                  f"K14c {label} many {nm} vs one-table calls")
    lib = []
    for nm, sl, v in adds:
        cap = tabs[nm].capacity
        live = mask & (sl >= 0) & (sl < cap)
        lib += [(ka[nm].columns[c], sl[live].long(), x[live])
                for c, x in v.items()]
    many_ms = cuda_ms(lambda: table.scatter_add_many(
        [(ka[nm], sl, v) for nm, sl, v in adds], mask))
    ones_ms = cuda_ms(lambda: [ko[nm].scatter_add(sl, v, mask=mask)
                               for nm, sl, v in adds])
    lib_ms = cuda_ms(lambda: [c.index_put_((s,), x, accumulate=True)
                              for c, s, x in lib])
    plain_ms = cuda_ms(lambda: table.scatter_add_many_plain(
        [(kp[nm], sl, v) for nm, sl, v in adds], mask), iters=3)
    r = {}
    bound(r, sum(k14c_bytes(sl, mask, v, tabs[nm].capacity)[0]
                 for nm, sl, v in adds),
          sum(k14c_bytes(sl, mask, v, tabs[nm].capacity)[1]
              for nm, sl, v in adds))
    print(f"[K14c] {label} scatter_add_many "
          f"{'+'.join(nm for nm, _, _ in adds)} (one launch): "
          f"ms={many_ms:.4f} three one-table calls={ones_ms:.4f} "
          f"plain_ms={plain_ms:.4f} index_put_ms={lib_ms:.4f} "
          f"({len(lib)} calls) bound_ms={r['bound_ms']:.6f} "
          f"({r['bound_by']}; card {card}); exact against plain and the "
          f"one-table calls", flush=True)


K14D_TABLES = ("HISTORY", "ORDER", "NEW-ORDER", "ORDER-LINE")


def k14d_cases(dev, state, calls, rec, card) -> None:
    """Each of the four tables' first append of the epoch (ORDER-LINE's
    30,720 lanes, 2,048 for the others at 64 warehouses) replayed through
    K14d and its plain version on clones whose cursor sits just before
    the ring's end, so the call wraps: slots, cursor and every row, pad
    and trash rows included, exact.  ORDER-LINE's is the kernel's
    record; the appends an epoch of each table come from the same
    epoch's calls."""
    from deneva_tpu_torch.storage.table import APPEND_TILE
    for name in K14D_TABLES:
        _, _, _, mask, rows = next(c for c in calls if c[0] == "append"
                                   and c[1] == name)
        per_epoch = sum(1 for c in calls if c[0] == "append" and c[1] == name)
        tab = state.db[name]
        cap, live = tab.capacity, int(mask.sum())
        a, p = table_clone(tab), table_clone(tab)
        for t in (a, p):
            t.row_cnt.fill_(cap - live // 2)
        _, sa = a.append(rows, mask)
        _, sp = p.append_plain(rows, mask)
        if not (torch.equal(sa, sp) and torch.equal(a.row_cnt, p.row_cnt)):
            fail(f"K14d {name}: slots or row_cnt differ from plain")
        for c in tab.columns:
            if not torch.equal(a.columns[c], p.columns[c]):
                fail(f"K14d {name}: column {c} differs from plain")
        wrapped = int(((sa < live) & mask).sum())
        if tab.ring and live > 1 and wrapped == 0:
            fail(f"K14d {name}: the ring did not wrap")
        r = {"max_abs_err": max_abs(sa, sp),
             "ms": cuda_ms(lambda: a.append(rows, mask)),
             "plain_ms": cuda_ms(lambda: p.append_plain(rows, mask)),
             "library_ms": None}
        n, k = mask.numel(), len(rows)
        # mask in, the values of inserted lanes only; slots out, one row
        # per inserted lane, the cursor
        bound(r, n + 4 * live * k + 4 * n + 4 * live * k + 8, n)
        if name == "ORDER-LINE":
            rec["K14d_append"].update(r)
        print(f"[K14d] {name}: lanes={n} inserted={live} wrapped={wrapped} "
              f"capacity={cap} ring={tab.ring} columns={k} blocks="
              f"{-(-n // APPEND_TILE)} appends_per_epoch={per_epoch}: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.6f} {r['bound_by']}; card {card})",
              flush=True)


def tpcc_epochs_equal(dev, cfg, n: int, label: str, tag: str = "tpcc"):
    """``n`` TPC-C (or PPS) epochs through the kernels equal ``n`` through
    the plain versions: every table's rows [0, capacity), its padded rows
    and cursor, the ORDER index's arrays and count, the pool, cc state,
    rng and counters."""
    from deneva_tpu_torch.convert import state_leaves
    t = time.monotonic()
    ek, ep = tpcc_engine(dev, cfg), tpcc_engine(dev, cfg)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    sk = ek.run(sk, n)
    with plain_path(ep.workload):
        sp = ep.run(sp, n)
    torch.cuda.synchronize()
    lk, lp = state_leaves(sk), state_leaves(sp)
    for path, x in lk.items():
        y = lp[path]
        tab = sk.db.get(path.split("/")[1]) if path.startswith("db/") \
            else None
        if hasattr(tab, "capacity") and x.ndim:
            cap = tab.capacity
            same = torch.equal(x[:cap], y[:cap]) \
                and torch.equal(x[cap + 1:], y[cap + 1:])
        else:
            same = torch.equal(x, y)
        if not same:
            fail(f"{label}: leaf {path} differs between kernel and plain "
                 "epochs")
    print(f"[{tag}-epochs] {label}: {n} kernel epochs == {n} plain epochs "
          f"({len(lk)} leaves; commits "
          f"{int(sk.stats['total_txn_commit_cnt'])}, aborts "
          f"{int(sk.stats['total_txn_abort_cnt'])}, defers "
          f"{int(sk.stats['defer_cnt'])}) in {time.monotonic() - t:.1f} s",
          flush=True)
    return ek, sk


def tpcc_oracle_epoch(eng, state):
    """One TPU_BATCH kernel epoch against numpy: the committed txns
    applied level by level in plain Python — payments' escrow adds in
    lane order (float32, one rounding each), NewOrders' O_IDs dense per
    district in (level, order), the stock quantity rule, the HISTORY,
    ORDER, NEW-ORDER and ORDER-LINE rows appended in lane order at the
    cursor; every table row [0, capacity), each cursor, the read
    checksum and the write count must equal the epoch's bit for bit."""
    import dataclasses
    wl, cfg = eng.workload, eng.cfg
    pre = {nm: ({c: v[:t.capacity].cpu().numpy().copy()
                 for c, v in t.columns.items()}, int(t.row_cnt), t.capacity)
           for nm, t in state.db.items()}
    cks0, wc0 = int(state.stats["read_checksum"]), int(state.stats["write_cnt"])
    seen = {}
    be, real_plan = eng.backend, wl.plan

    def validate(cfg_, cs, batch, inc):
        v, st = be.validate(cfg_, cs, batch, inc)
        seen["v"] = v
        return v, st

    def plan(db, q):
        seen["q"] = q
        return real_plan(db, q)
    eng.backend = dataclasses.replace(be, validate=validate)
    wl.plan = plan
    try:
        state = eng.step(state)
    finally:
        eng.backend = be
        del wl.plan
    torch.cuda.synchronize()
    q = {f: getattr(seen["q"], f).cpu().numpy() for f in tpcc_fields()}
    v = seen["v"]
    commit, level, order = (x.cpu().numpy() for x in (v.commit, v.level,
                                                      v.order))
    tab = {nm: {c: a.copy() for c, a in cols.items()}
           for nm, (cols, _, _) in pre.items()}
    cur = {nm: rc for nm, (_, rc, _) in pre.items()}
    caps = {nm: cap for nm, (_, _, cap) in pre.items()}
    f32 = np.float32
    cks, wc = 0, 0
    nd, cpd, mi = 10, cfg.cust_per_dist, cfg.max_items
    n_items = cfg.max_items_per_txn

    def append(nm, row):
        slot = cur[nm] % caps[nm]
        for c, x in row.items():
            tab[nm][c][slot] = x
        cur[nm] += 1
    levels = []
    for lvl in range(cfg.exec_subrounds):
        lanes = np.nonzero(commit & (level == lvl))[0]
        levels.append(len(lanes))
        pays = [i for i in lanes if q["txn_type"][i] == 0]
        nos = [i for i in lanes if q["txn_type"][i] == 1]
        for i in pays:
            amt = f32(q["h_amount"][i])
            w, d = q["w_id"][i], q["d_id"][i]
            cs = (q["c_w_id"][i] * nd + q["c_d_id"][i]) * cpd + q["c_id"][i]
            tab["WAREHOUSE"]["W_YTD"][w] = f32(tab["WAREHOUSE"]["W_YTD"][w]
                                               + amt)
            tab["DISTRICT"]["D_YTD"][w * nd + d] = f32(
                tab["DISTRICT"]["D_YTD"][w * nd + d] + amt)
            cu = tab["CUSTOMER"]
            cu["C_BALANCE"][cs] = f32(cu["C_BALANCE"][cs] + (-amt))
            cu["C_YTD_PAYMENT"][cs] = f32(cu["C_YTD_PAYMENT"][cs] + amt)
            cu["C_PAYMENT_CNT"][cs] += 1
            append("HISTORY", {"H_C_ID": q["c_id"][i],
                               "H_C_D_ID": q["c_d_id"][i],
                               "H_C_W_ID": q["c_w_id"][i], "H_D_ID": d,
                               "H_W_ID": w, "H_AMOUNT": amt})
            wc += 6
        nxt = tab["DISTRICT"]["D_NEXT_O_ID"].copy()
        per: dict[int, int] = {}
        oid = {}
        for i in sorted(nos, key=lambda i: (order[i], i)):
            ds = int(q["w_id"][i] * nd + q["d_id"][i])
            oid[i] = nxt[ds] + per.get(ds, 0)
            per[ds] = per.get(ds, 0) + 1
        for ds, k in per.items():
            tab["DISTRICT"]["D_NEXT_O_ID"][ds] += k
        st = tab["STOCK"]
        for i in nos:
            w, d = q["w_id"][i], q["d_id"][i]
            lane = (f32(f32(tab["WAREHOUSE"]["W_TAX"][w]
                            + tab["DISTRICT"]["D_TAX"][w * nd + d])
                        + tab["CUSTOMER"]["C_DISCOUNT"][
                            (w * nd + d) * cpd + q["c_id"][i]]) * f32(1000))
            cks = (cks + int(lane)) & MASK32
            for j in range(n_items):
                if not q["item_valid"][i, j]:
                    continue
                s = q["supply_w"][i, j] * mi + q["items"][i, j]
                left = int(st["S_QUANTITY"][s]) - int(q["quantity"][i, j])
                st["S_QUANTITY"][s] = left if left > 10 else left + 91
                st["S_REMOTE_CNT"][s] += int(q["supply_w"][i, j] != w)
                wc += 1
            wc += 2
        for i in nos:
            w, d = q["w_id"][i], q["d_id"][i]
            valid = q["item_valid"][i]
            append("ORDER", {"O_ID": oid[i], "O_C_ID": q["c_id"][i],
                             "O_D_ID": d, "O_W_ID": w, "O_ENTRY_D": 2013,
                             "O_OL_CNT": q["ol_cnt"][i], "O_ALL_LOCAL": int(
                                 (~valid | (q["supply_w"][i] == w)).all())})
            append("NEW-ORDER", {"NO_O_ID": oid[i], "NO_D_ID": d,
                                 "NO_W_ID": w})
        for i in nos:
            for j in range(n_items):
                if q["item_valid"][i, j]:
                    append("ORDER-LINE", {
                        "OL_O_ID": oid[i], "OL_D_ID": q["d_id"][i],
                        "OL_W_ID": q["w_id"][i], "OL_NUMBER": j,
                        "OL_I_ID": q["items"][i, j],
                        "OL_QUANTITY": q["quantity"][i, j]})
    for nm, t in state.db.items():
        if int(t.row_cnt) != cur[nm]:
            fail(f"tpcc oracle: {nm} row_cnt {int(t.row_cnt)} != {cur[nm]}")
        for c, col in t.columns.items():
            have = col[:t.capacity].cpu().numpy()
            want = tab[nm][c].astype(have.dtype)
            if not np.array_equal(have.view(np.int32), want.view(np.int32)):
                bad = int((have.view(np.int32) != want.view(np.int32)).sum())
                fail(f"tpcc oracle: {nm}/{c} differs in {bad} rows")
    got_cks = (int(state.stats["read_checksum"]) - cks0) & MASK32
    got_wc = (int(state.stats["write_cnt"]) - wc0) & MASK32
    if got_cks != cks or got_wc != wc & MASK32:
        fail(f"tpcc oracle: checksum {got_cks} vs {cks}, writes {got_wc} "
             f"vs {wc}")
    return state, {"committed_by_level": levels,
                   "defers": int(v.defer.sum()), "checksum": cks,
                   "writes": wc}


def tpcc_invariants(state, d_ytd0, w_ytd0, bal0) -> dict:
    """Over the run since the load: D_YTD, W_YTD and the balances moved
    by exactly the HISTORY amounts (``tests/test_tpcc.py:164``), and each
    district's O_IDs are 3001 .. D_NEXT_O_ID - 1, each once."""
    db = state.db
    n_hist = int(db["HISTORY"].row_cnt)
    if n_hist >= db["HISTORY"].capacity:
        fail("tpcc invariants: HISTORY wrapped")
    paid = float(db["HISTORY"].columns["H_AMOUNT"][:n_hist].double().sum())
    for nm, col, before, sign in (("DISTRICT", "D_YTD", d_ytd0, 1),
                                  ("WAREHOUSE", "W_YTD", w_ytd0, 1),
                                  ("CUSTOMER", "C_BALANCE", bal0, -1)):
        cap = db[nm].capacity
        moved = sign * float(db[nm].columns[col][:cap].double().sum()
                             - before)
        if abs(moved - paid) > 1e-5 * max(abs(paid), 1.0):
            fail(f"tpcc invariants: {col} moved {moved}, paid {paid}")
    n_ord = int(db["ORDER"].row_cnt)
    o_w, o_d, o_id = (db["ORDER"].columns[c][:n_ord].long()
                      for c in ("O_W_ID", "O_D_ID", "O_ID"))
    ds = o_w * 10 + o_d
    nd = db["DISTRICT"].capacity
    nxt = db["DISTRICT"].columns["D_NEXT_O_ID"][:nd].long()
    cnt = torch.bincount(ds, minlength=nd)
    if not torch.equal(cnt, nxt - 3001):
        fail("tpcc invariants: orders per district != D_NEXT_O_ID advance")
    key = torch.sort(ds * (1 << 24) + o_id).values
    k_ds, k_id = key >> 24, key & ((1 << 24) - 1)
    first = torch.ones_like(k_ds, dtype=torch.bool)
    first[1:] = k_ds[1:] != k_ds[:-1]
    prev = torch.cat([k_id[:1], k_id[:-1]])
    if not bool(torch.where(first, k_id == 3001, k_id == prev + 1).all()):
        fail("tpcc invariants: a district's O_IDs are not dense")
    return {"payments_paid": paid, "history_rows": n_hist, "orders": n_ord}


def phase_tpcc_epochs(dev, card: str) -> None:
    """3 kernel epochs equal 3 plain epochs for TPU_BATCH at 64
    warehouses and CALVIN, NO_WAIT, OCC (escrow off) and MVCC at 4; then
    TPU_BATCH's numpy oracle epoch and the run's invariants, the cost of
    an empty chained pass and of the O_ID rank glue."""
    eng, st = tpcc_epochs_equal(dev, tpcc_config(64), 3, "TPU_BATCH 64wh")
    torch.cuda.empty_cache()
    for alg, kw in (("CALVIN", {}), ("NO_WAIT", {}),
                    ("OCC", {"escrow_sweep": False}), ("MVCC", {})):
        tpcc_epochs_equal(dev, tpcc_config(4, alg, **kw), 3,
                          f"{alg} 4wh" + (" escrow off" if kw else ""))
        torch.cuda.empty_cache()
    wl = eng.workload
    base = wl.load()
    sums = [float(base[nm].columns[c][:base[nm].capacity].double().sum())
            for nm, c in (("DISTRICT", "D_YTD"), ("WAREHOUSE", "W_YTD"),
                          ("CUSTOMER", "C_BALANCE"))]
    del base
    st, info = tpcc_oracle_epoch(eng, st)
    print(f"[tpcc-oracle] TPU_BATCH 64wh epoch 4: {info}", flush=True)
    print(f"[tpcc-invariants] TPU_BATCH 64wh after 4 epochs: "
          f"{tpcc_invariants(st, *sums)}", flush=True)
    # an empty chained pass (a level above the epoch's deepest) and one
    # with the epoch's level-0 mask, device and host time
    from deneva_tpu_torch.engine.step import init_device_stats
    from deneva_tpu_torch.ops import prng
    q = wl.generate(prng.split(prng.key_from_seed(31, dev))[1],
                    eng.cfg.epoch_batch)
    order = torch.arange(1, q.w_id.numel() + 1, dtype=torch.int32,
                         device=dev)
    none = torch.zeros_like(q.w_id, dtype=torch.bool)
    stats = init_device_stats(2, 1, dev)

    def empty_pass():
        wl.execute(st.db, q, none, order, stats, level_exec=True)
    dev_ms = cuda_ms(empty_pass)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        empty_pass()
    host_ms = (time.perf_counter() - t) / 20 * 1e3
    torch.cuda.synchronize()
    dk = wl.dist_key(q.w_id, q.d_id)
    glue_ms = cuda_ms(lambda: wl._order_rank(~none, dk, order))
    print(f"[chained] empty pass: device {dev_ms:.4f} ms, host "
          f"{host_ms:.4f} ms (9 launches, level_exec; card {card})",
          flush=True)
    print(f"[glue] TPC-C O_ID rank (3 stable argsorts, a cummax, a "
          f"scatter) at B={q.w_id.numel()}: {glue_ms:.4f} ms (plain "
          f"PyTorch; card {card})", flush=True)
    del eng, st
    torch.cuda.empty_cache()


def capture_inserts(eng, state):
    """One kernel epoch, keeping the arguments of every ORDER index
    insert (new keys, slots, mask), cloned."""
    from deneva_tpu_torch.storage.index import DynamicSortedIndex
    calls = []
    real = DynamicSortedIndex.insert

    def ins(idx, keys, slots, mask):
        calls.append((keys.clone(), slots.clone(), mask.clone()))
        return real(idx, keys, slots, mask)
    DynamicSortedIndex.insert = ins
    try:
        state = eng.step(state)
    finally:
        DynamicSortedIndex.insert = real
    torch.cuda.synchronize()
    return state, calls


def same_index(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("keys", "slots", "cnt"))


def phase_slice6_kernels(dev, rec: dict, card: str) -> None:
    """K20 on one ``pps_scaling`` epoch's generation (and with key spans
    above 2^16); K14e merge on a real 64-warehouse NewOrder insert into
    an index of capacity 2^20 pre-filled to about 2^19 entries, on a call
    that crosses the capacity and on an all-masked call; K14e probes on
    the merged index: each exact against its plain version."""
    from deneva_tpu_torch.ops import prng
    from deneva_tpu_torch.storage.index import BIG, DynamicSortedIndex
    from deneva_tpu_torch.workloads.pps import PPSQuery, PPSWorkload
    # K20
    cfg = pps_config()
    wl = PPSWorkload(cfg, device=dev)
    b = cfg.epoch_batch
    key = prng.split(prng.key_from_seed(41, dev))[1]
    q, qp = wl.generate(key, b), wl.generate_plain(key, b)
    err = 0
    for f in PPSQuery.__dataclass_fields__:
        x, y = getattr(q, f), getattr(qp, f)
        if not torch.equal(x, y):
            fail(f"K20: field {f} differs from plain")
        err = max(err, max_abs(x, y))
    rec["K20_pps_generate"].update(
        max_abs_err=err, ms=cuda_ms(lambda: wl.generate(key, b)),
        plain_ms=cuda_ms(lambda: wl.generate_plain(key, b), iters=3),
        library_ms=None)
    # per txn one uniform and three randint (two hashes each), eight
    # compares; in the key and the mix, out four words per txn
    bound(rec["K20_pps_generate"], 16 + 32 + 16 * b,
          (7 * THREEFRY_OPS + 8) * b)
    wide = PPSWorkload(pps_config(pps_parts_cnt=100003,
                                  pps_products_cnt=65537), device=dev)
    qw, qwp = wide.generate(key, b), wide.generate_plain(key, b)
    for f in PPSQuery.__dataclass_fields__:
        if not torch.equal(getattr(qw, f), getattr(qwp, f)):
            fail(f"K20 (spans above 2^16): field {f} differs from plain")
    print(f"[K20] B={b}: types {torch.bincount(q.txn_type, minlength=8).tolist()}"
          f"; spans above 2^16 exact too", flush=True)

    # K14e merge on a real 64-warehouse epoch's level-0 NewOrder insert
    tcfg = index_config(64)
    eng = tpcc_engine(dev, tcfg)
    st = eng.run(eng.init_state(), 2)
    st, calls = capture_inserts(eng, st)
    if len(calls) != tcfg.exec_subrounds:
        fail(f"K14e: {len(calls)} inserts in a chained epoch")
    nk, ns, nm = calls[0]
    cap, nd = tcfg.insert_table_cap, eng.workload.n_districts
    per = cap // 2 // nd         # orders per district already indexed
    dk = np.repeat(np.arange(nd, dtype=np.int64), per)
    oid = 3001 + np.tile(np.arange(per, dtype=np.int64), nd)
    live = len(dk)
    idx = DynamicSortedIndex.build(
        (dk * (1 << 21) + oid).astype(np.int32),
        np.arange(live, dtype=np.int32), miss_slot=cap, cap=cap, device=dev)
    # the epoch's orders, as they arrive once every district holds `per`
    kk = torch.where(nm, nk + per, nk)
    got, want = idx.insert(kk, ns, nm), idx.insert_plain(kk, ns, nm)
    if not same_index(got, want):
        fail("K14e merge differs from plain on the 64-wh insert")
    n_in = int(nm.sum())
    allk = torch.cat([idx.keys, torch.where(nm, kk, BIG)])
    alls = torch.cat([idx.slots, ns])

    def library():
        return alls[torch.sort(allk, stable=True).indices[:cap]]
    r = {"max_abs_err": max(max_abs(got.keys, want.keys),
                            max_abs(got.slots, want.slots)),
         "ms": cuda_ms(lambda: idx.insert(kk, ns, nm)),
         "plain_ms": cuda_ms(lambda: idx.insert_plain(kk, ns, nm), iters=5),
         "library_ms": cuda_ms(library, iters=5)}
    m = nm.numel()
    # the live keys and slots read and written once, the inserts' key,
    # slot and mask read; a merge compares once per output entry
    bound(r, 16 * cap + 9 * m + 8, cap + m)
    rec["K14e_index_merge"].update(r)
    none = torch.zeros_like(nm)
    empty = idx.insert(kk, ns, none)
    if not same_index(empty, idx.insert_plain(kk, ns, none)):
        fail("K14e merge differs from plain on an all-masked call")
    empty_ms = cuda_ms(lambda: idx.insert(kk, ns, none))
    # a call that crosses the capacity: the index topped up with keys
    # above every district's, so that half the epoch's orders fit
    n_fill = cap - n_in // 2
    full = DynamicSortedIndex.build(
        np.concatenate([dk * (1 << 21) + oid,
                        (nd << 21) + np.arange(n_fill - live)]
                       ).astype(np.int32),
        np.arange(n_fill, dtype=np.int32), miss_slot=cap, cap=cap,
        device=dev)
    over, over_p = full.insert(kk, ns, nm), full.insert_plain(kk, ns, nm)
    if not same_index(over, over_p) or not bool(over.overflowed()):
        fail("K14e merge differs from plain (or did not overflow) on the "
             "call that crosses the capacity")
    print(f"[K14e] merge: {m} lanes, {n_in} orders into {live} of {cap} "
          f"entries; crossing the capacity at {int(full.cnt)} + {n_in} "
          f"-> cnt {int(over.cnt)}, exact; an all-masked call "
          f"{empty_ms:.4f} ms (card {card})", flush=True)

    # K14e probes on the merged 2^20 index: the count of each lane's key
    # (the epoch's orders and the keys lanes held before), and a window
    # of 128 entries up to 10 orders past each key
    view = got._view()
    cnt_k, cnt_p = view.lookup_count(kk), view.lookup_count_plain(kk)
    lo, hi = kk - 100, kk + 10
    rk = view.range_between(lo, hi, 128)
    rp = view.range_between_plain(lo, hi, 128)
    sk_, sp_ = view.range_slots(lo, 128), view.range_slots_plain(lo, 128)
    if not (torch.equal(cnt_k, cnt_p) and all(
            torch.equal(a, c) for a, c in zip(rk + sk_, rp + sp_))):
        fail("K14e probes differ from plain on the 2^20 index")
    if int(cnt_k[nm].min()) != 1:
        fail("K14e probes: an inserted order is not found once")

    def lib_count():
        return (torch.searchsorted(view.keys, kk, side="right")
                - torch.searchsorted(view.keys, kk))
    r = {"max_abs_err": max(max_abs(cnt_k, cnt_p), max_abs(rk[0], rp[0])),
         "ms": cuda_ms(lambda: view.lookup_count(kk)),
         "plain_ms": cuda_ms(lambda: view.lookup_count_plain(kk)),
         "library_ms": cuda_ms(lib_count)}
    # a query in, a count out, the two bounding keys read; two binary
    # searches of log2(cap) steps
    bound(r, 16 * m, 2 * 20 * m)
    rec["K14e_sorted_probe"].update(r)
    print(f"[K14e] probes: {m} counts {r['ms']:.4f} ms; {m} windows of "
          f"128 (range_between) {cuda_ms(lambda: view.range_between(lo, hi, 128)):.4f} ms, "
          f"plain {cuda_ms(lambda: view.range_between_plain(lo, hi, 128)):.4f}; "
          f"{int(rk[1].sum())} entries in the windows (card {card})",
          flush=True)
    for nm_ in ("K20_pps_generate", "K14e_index_merge", "K14e_sorted_probe"):
        print_kernel(nm_, rec[nm_], card)
    del eng, st, idx, got, want, full, over, over_p, empty
    torch.cuda.empty_cache()


def order_index_oracle(state, wl) -> dict:
    """``tests/test_tpcc.py:87-117`` at scale, through the K14e probes:
    every ORDER ring row is found at its slot by its key, exactly once;
    each district's range walk holds exactly its orders, in ascending
    o_id from 3001 to ``D_NEXT_O_ID - 1``.  Returns the probes'
    launches."""
    from deneva_tpu_torch.storage.index import K14E_PROBE
    db = state.db
    idx, order = db["ORDER_IDX"], db["ORDER"]
    n_ord = int(order.row_cnt)
    if not 0 < n_ord <= idx.cap or bool(idx.overflowed()) \
            or int(idx.cnt) != n_ord:
        fail(f"order index oracle: {n_ord} orders, cnt {int(idx.cnt)}")
    o_w, o_d, o_id = (order.columns[c][:n_ord]
                      for c in ("O_W_ID", "O_D_ID", "O_ID"))
    keys = wl.order_index_key(o_w, o_d, o_id)
    before = K14E_PROBE.launches
    slot = idx.lookup(keys)
    if not torch.equal(slot, torch.arange(n_ord, dtype=torch.int32,
                                          device=slot.device)):
        fail("order index oracle: an ORDER row is not found at its slot")
    if int(idx.lookup_count(keys).max()) != 1:
        fail("order index oracle: a key is indexed twice")
    nd = wl.n_districts
    nxt = db["DISTRICT"].columns["D_NEXT_O_ID"][:nd]
    width = -(-int((nxt - 3001).max()) // 32) * 32 + 32
    ds = torch.arange(nd, dtype=torch.int32, device=slot.device)
    walk, ok = idx.range_between(ds * (1 << 21), ds * (1 << 21) + (1 << 21)
                                 - 1, width)
    launches = K14E_PROBE.launches - before
    got = torch.where(ok, o_id[walk.clamp(0, n_ord - 1).long()], 0)
    want = torch.arange(width, device=ds.device)[None, :] + 3001
    want_ok = want < nxt[:, None]
    dist = torch.where(ok, (o_w * 10 + o_d)[walk.clamp(0, n_ord - 1).long()],
                       -1)
    if not (torch.equal(ok, want_ok) and torch.equal(
            torch.where(ok, got, 0), torch.where(want_ok, want, 0).to(
                got.dtype)) and bool((dist[ok] == ds[:, None].expand_as(
                    dist)[ok]).all())):
        fail("order index oracle: a district's walk is not its dense, "
             "ascending orders")
    return {"orders": n_ord, "districts": nd, "walk_width": width,
            "probe_launches": launches}


def pps_oracle_epoch(eng, state) -> tuple:
    """One PPS kernel epoch against numpy: PART_AMOUNT moves by exactly
    -1 on each used part of every committed ORDERPRODUCT and +100 on the
    part of every committed UPDATEPART (``np.add.at``), and each
    product's PRODUCT_PART is the part of its last committed
    UPDATEPRODUCTPART in serial order (``verdict.order``), or unchanged."""
    from deneva_tpu_torch.workloads import pps
    wl, cfg = eng.workload, eng.cfg
    n_pt, n_pr = cfg.pps_parts_cnt, cfg.pps_products_cnt
    amt0 = state.db["PARTS"].columns["PART_AMOUNT"][:n_pt].cpu().numpy(
        ).copy()
    part0 = state.db["PRODUCTS"].columns["PRODUCT_PART"][:n_pr].cpu(
        ).numpy().copy()
    uses = state.db["USES"].columns["PART_KEY"].cpu().numpy()
    calls = []
    real = wl.execute

    def execute(db, q, mask, order, stats, fwd_rank=None, level_exec=False):
        calls.append((q, mask.clone(), order.clone()))
        return real(db, q, mask, order, stats, fwd_rank, level_exec)
    wl.execute = execute
    try:
        state = eng.step(state)
    finally:
        del wl.execute
    torch.cuda.synchronize()
    q = {f: getattr(calls[0][0], f).cpu().numpy()
         for f in pps.PPSQuery.__dataclass_fields__}
    order = calls[0][2].cpu().numpy()
    commit = np.zeros(len(order), bool)
    for _, m, _ in calls:
        commit |= m.cpu().numpy()
    t = q["txn_type"]
    amt = amt0.astype(np.int64)
    per = cfg.pps_parts_per
    op = np.nonzero(commit & (t == pps.ORDERPRODUCT))[0]
    up = np.nonzero(commit & (t == pps.UPDATEPART))[0]
    for i in op:
        np.add.at(amt, uses[q["product_key"][i] * per
                            + np.arange(per)], -1)
    np.add.at(amt, q["part_key"][up], 100)
    part = part0.copy()
    pw = np.nonzero(commit & (t == pps.UPDATEPRODUCTPART))[0]
    for i in sorted(pw, key=lambda i: order[i]):
        part[q["product_key"][i]] = q["part_key"][i]
    got_amt = state.db["PARTS"].columns["PART_AMOUNT"][:n_pt].cpu().numpy()
    got_part = state.db["PRODUCTS"].columns["PRODUCT_PART"][:n_pr].cpu(
        ).numpy()
    if not np.array_equal(got_amt.astype(np.int64), amt):
        fail("pps oracle: PART_AMOUNT differs from the serial adds")
    if int(got_amt.astype(np.int64).sum() - amt0.astype(np.int64).sum()) \
            != -per * len(op) + 100 * len(up):
        fail("pps oracle: PART_AMOUNT's total moved by the wrong amount")
    if not np.array_equal(got_part, part):
        fail("pps oracle: PRODUCT_PART is not the last committed writer's")
    return state, {"commits": int(commit.sum()), "orderproduct": len(op),
                   "updatepart": len(up), "updateproductpart": len(pw),
                   "products_rewritten": int((part != part0).sum()),
                   "passes": len(calls)}


def phase_slice6_epochs(dev, card: str) -> int:
    """3 kernel epochs equal 3 plain epochs for PPS under TPU_BATCH,
    CALVIN, NO_WAIT, OCC, MVCC and MAAT at ``pps_scaling``, and for TPC-C
    at 64 warehouses under TPU_BATCH with the ORDER index on; a PPS
    numpy oracle epoch; the ORDER index oracle after 20 more epochs.
    Returns the K14e probes' launches in that oracle."""
    for alg in ("TPU_BATCH", "CALVIN", "NO_WAIT", "OCC", "MVCC", "MAAT"):
        eng, st = tpcc_epochs_equal(dev, pps_config(alg), 3, f"PPS {alg}",
                                    tag="pps")
        if alg == "TPU_BATCH":
            st, info = pps_oracle_epoch(eng, st)
            print(f"[pps-oracle] TPU_BATCH epoch 4: {info}", flush=True)
        del eng, st
        torch.cuda.empty_cache()
    eng, st = tpcc_epochs_equal(dev, index_config(64), 3,
                                "TPU_BATCH 64wh order index")
    st = eng.run(st, 20)
    info = order_index_oracle(st, eng.workload)
    print(f"[order-index-oracle] TPU_BATCH 64wh after 23 epochs: {info} "
          f"(card {card})", flush=True)
    del eng, st
    torch.cuda.empty_cache()
    return info["probe_launches"]


# -- transaction repair and DGCC (slice 7) ------------------------------------

SWEEP6 = ("OCC", "NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC", "MAAT")


def repair_config(alg: str = "OCC", rounds: int | None = 2, **kw):
    """``repair_ablation``'s YCSB half (``experiments.py:217-264``):
    ``paper_base`` with theta 0.9, 10% reads, 90% writes — 2^24 rows, 10
    requests (``max_accesses=16``), ``epoch_batch=2048`` over a pool of
    10,000, 8192 buckets, dual hashing; repair off when ``rounds`` is
    None, else on at ``repair_rounds=rounds``."""
    if rounds is not None:
        kw.update(repair=True, repair_rounds=rounds)
    return skew_config(False, alg, read_perc=0.1, write_perc=0.9, **kw)


def dgcc_config(theta: float = 0.9, write: float = 0.9, **kw):
    """``dgcc_contention``'s DGCC cells (``experiments.py:267-301``): the
    ``repair_ablation`` base at ``zipf_theta=theta`` and ``write_perc=
    write``, ``dgcc_levels=32``."""
    return skew_config(False, "DGCC", zipf_theta=theta,
                       read_perc=round(1.0 - write, 6), write_perc=write,
                       **kw)


@contextlib.contextmanager
def grab_calls(mod, name: str, calls: list):
    """Record the arguments of every call of ``mod.name`` (and run it)."""
    real = getattr(mod, name)

    def grab(*a, **k):
        calls.append(a)
        return real(*a, **k)
    setattr(mod, name, grab)
    try:
        yield real
    finally:
        setattr(mod, name, real)


def dgcc_epoch_lanes(dev, theta: float):
    """(cfg, K15a's arguments) of epoch 11 of ``dgcc_contention`` DGCC at
    ``theta`` from a fresh state: the doubled lanes and the txn count."""
    from deneva_tpu_torch.cc import depgraph
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    cfg = dgcc_config(theta)
    eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
    st = eng.run(eng.init_state(), 10)
    calls: list = []
    with grab_calls(depgraph, "lane_sort", calls):
        st = eng.step(st)
    torch.cuda.synchronize()
    return cfg, calls[0]


def relax_inputs(dev, theta: float) -> tuple:
    """K16's (head, sid, sw, live, b, rounds) on that epoch's lanes."""
    from deneva_tpu_torch.cc import depgraph
    cfg, (keys, pos, tid, n_txn) = dgcc_epoch_lanes(dev, theta)
    sk, sp, sid = depgraph.lane_sort(keys, pos, tid, n_txn)
    head = depgraph.census(sk, sp, sid)[0]
    return (head, sid, (sp & 1) == 1, sk != depgraph.LANE_PAD, n_txn,
            cfg.dgcc_levels)


def phase_slice7_kernels(dev, rec: dict, card: str) -> None:
    """K13a on the inputs of a real OCC repair epoch at ``repair_ablation``'s
    YCSB shape (both sub-rounds checked, the first timed); K15a, K15b and
    K16 on the lanes of real ``dgcc_contention`` epochs at theta 0.6, 0.9
    and 0.99 (theta 0.9 timed into the kernels line).  Each exact against
    its plain version."""
    from deneva_tpu_torch.cc import base, depgraph, dgcc
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    cfg = repair_config("OCC", 2)
    eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
    st = eng.run(eng.init_state(), 10)
    calls: list = []
    with grab_calls(base, "committed_write_frontier", calls) as k13a:
        st = eng.step(st)
    torch.cuda.synchronize()
    for i, (c, bt, inc, committed, losers) in enumerate(calls):
        got = k13a(c, bt, inc, committed, losers)
        want = base.committed_write_frontier_plain(c, bt, inc, committed,
                                                   losers)
        if not torch.equal(got, want):
            fail(f"K13a: sub-round {i + 1} differs from the plain version")
    if len(calls) != 2:
        fail(f"K13a: {len(calls)} frontier calls in a 2-round repair epoch")
    c, bt, inc, committed, losers = calls[0]
    got = k13a(c, bt, inc, committed, losers)
    b, a = bt.keys.shape
    k = inc.w1.shape[1]
    fams = 1 if inc.w2 is None else 2
    n_com = int(committed.sum())
    c16 = committed.to(torch.bfloat16)[None, :]

    def lib():
        for w in (inc.w1, inc.w2)[:fams]:
            torch.matmul(c16, w)
    r = {"max_abs_err": max_abs(got, base.committed_write_frontier_plain(
             c, bt, inc, committed, losers)),
         "ms": cuda_ms(lambda: k13a(c, bt, inc, committed, losers)),
         "plain_ms": cuda_ms(lambda: base.committed_write_frontier_plain(
             c, bt, inc, committed, losers)),
         "library_ms": cuda_ms(lib)}
    # the result depends on the committed rows of each write view only;
    # the lanes' bucket, table id and key (4 B) and valid / read flags
    # (1 B), committed and losers in; the frontier out
    bound(r, fams * n_com * k * 2 + b * a * 14 + 2 * b + b * a,
          fams * n_com * k)
    rec["K13a_repair_frontier"].update(r)
    print(f"[K13a] OCC repair_ablation epoch 11, sub-round 1: B={b} A={a} "
          f"K={k} families={fams} committed={n_com} "
          f"losers={int(losers.sum())} frontier lanes={int(got.sum())}; "
          f"sub-round 2 committed={int(calls[1][3].sum())}", flush=True)
    print_kernel("K13a_repair_frontier", r, card)
    del eng, st, calls
    torch.cuda.empty_cache()
    k15a = depgraph.lane_sort
    for theta in (0.6, 0.9, 0.99):
        cfg, (keys, pos, tid, n_txn) = dgcc_epoch_lanes(dev, theta)
        srt = k15a(keys, pos, tid, n_txn)
        srt_p = depgraph.lane_sort_plain(keys, pos, tid)
        cen = depgraph.census(*srt)
        cen_p = depgraph.census_plain(*srt)
        sk, sp, sid = srt
        sw, live = (sp & 1) == 1, sk != depgraph.LANE_PAD
        rel = dgcc.relax(cen[0], sid, sw, live, n_txn, cfg.dgcc_levels)
        rel_p = dgcc.relax_plain(cen[0], sid, sw, live, n_txn,
                                 cfg.dgcc_levels)
        for nm, x, y in (("K15a", srt, srt_p), ("K15b", cen, cen_p),
                         ("K16", rel, rel_p)):
            if not all(torch.equal(u, v) for u, v in zip(x, y)):
                fail(f"K15/K16 theta {theta}: {nm} differs from plain")
        n = keys.numel()
        n_live = int(live.sum())
        iters = int(rel[2])
        packed = keys * (1 << 31) + pos.to(torch.int64)
        rows = {
            "K15a_lane_sort": (
                lambda: k15a(keys, pos, tid, n_txn),
                lambda: depgraph.lane_sort_plain(keys, pos, tid),
                lambda: torch.sort(packed), 32 * n, n),
            "K15b_seg_scans": (
                lambda: depgraph.census(sk, sp, sid),
                lambda: depgraph.census_plain(sk, sp, sid), None,
                25 * n + 4, 10 * n),
            "K16_dgcc_relax": (
                lambda: dgcc.relax(cen[0], sid, sw, live, n_txn,
                                   cfg.dgcc_levels),
                lambda: dgcc.relax_plain(cen[0], sid, sw, live, n_txn,
                                         cfg.dgcc_levels), None,
                7 * n + 4 * n_txn + 5, 2 * 12 * iters * n_live)}
        line = []
        for nm, (fn, plain, lib, nbytes, ops) in rows.items():
            r = {"max_abs_err": 0, "ms": cuda_ms(fn),
                 "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                 "library_ms": None if lib is None else cuda_ms(lib)}
            bound(r, nbytes, ops)
            line.append(f"{nm} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}"
                        f", bound {r['bound_ms']:.6f})")
            if theta == 0.9:
                rec[nm].update(r)
        print(f"[K15/K16] dgcc_contention theta {theta} epoch 11: lanes={n} "
              f"live={n_live} txns={n_txn} edges={int(cen[3])} "
              f"wave_max={int(rel[0][rel[0] < cfg.dgcc_levels].max())} "
              f"deferred={int((rel[0] >= cfg.dgcc_levels).sum())} "
              f"relax_rounds={iters}: " + "; ".join(line)
              + f" (card {card})", flush=True)
        torch.cuda.empty_cache()
    for nm in ("K15a_lane_sort", "K15b_seg_scans", "K16_dgcc_relax"):
        print_kernel(nm, rec[nm], card)


def serial_apply(f0: np.ndarray, groups, keys, isw, version):
    """Numpy serial execution in fingerprint mode: txn by txn (``groups``
    in order), the read lanes' current values into the checksum, then
    each write lane stores fingerprint(key, version of the txn)."""
    t = f0.copy()
    cks = 0
    for idx in groups:
        for i in idx:
            rk = keys[i][~isw[i]]
            cks += int(t[rk].astype(np.uint64).sum())
            wk = keys[i][isw[i]]
            t[wk] = np_fingerprint(wk, np.full(wk.shape, version[i]))
    return t, cks & MASK32


def _by_rank(mask, rank):
    idx = np.nonzero(mask)[0]
    return idx[np.argsort(rank[idx], kind="stable")]


def repair_oracle_epoch(eng, state, dev) -> dict:
    """One OCC repair epoch against numpy: executing its committed txns
    serially — the main round's winners by rank, then round 1's
    salvages by rank, then round 2's — gives the same table and read
    checksum; salvaged + fallback equal the main round's losers, and
    aborts equal the fallbacks."""
    from deneva_tpu_torch.engine import step as step_mod
    from deneva_tpu_torch.workloads.ycsb import TABLE
    calls: list = []
    out: list = []
    real = step_mod.run_repair

    def grab(*a, **k):
        calls.append(a)
        res = real(*a, **k)
        out.append(res)
        return res
    keys_ = ("read_checksum", "total_txn_commit_cnt", "total_txn_abort_cnt",
             "rep_salvaged_cnt", "rep_fallback_cnt", "rep_frontier_cnt")
    start = state.db[TABLE].columns["F0"].cpu().numpy().view(
        np.uint32).copy()
    pre = {k: int(state.stats[k]) for k in keys_}
    step_mod.run_repair = grab
    try:
        state = eng.step(state)
    finally:
        step_mod.run_repair = real
    torch.cuda.synchronize()
    bt, verdict, exec_commit = calls[0][5], calls[0][7], calls[0][10]
    salvaged, rounds = out[0][3].cpu().numpy(), out[0][4].cpu().numpy()
    act = bt.active.cpu().numpy()
    keys = bt.keys.cpu().numpy().astype(np.int64)
    isw = bt.is_write.cpu().numpy()
    rank = bt.rank.cpu().numpy()
    main = exec_commit.cpu().numpy() & act
    losers = verdict.abort.cpu().numpy() & act
    groups = [_by_rank(main, rank)] + [
        _by_rank(rounds == r, rank) for r in range(1, eng.cfg.repair_rounds
                                                    + 1)]
    table, cks = serial_apply(start, groups, keys, isw, rank)
    cap = eng.workload.n_rows
    got = state.db[TABLE].columns["F0"].cpu().numpy().view(np.uint32)
    if not np.array_equal(got[:cap], table[:cap]):
        fail("repair oracle: table differs from the serial execution")
    d = {k: (int(state.stats[k]) - pre[k]) & MASK32 for k in keys_}
    if d["read_checksum"] != cks:
        fail(f"repair oracle: checksum {d['read_checksum']} != serial {cks}")
    if d["total_txn_commit_cnt"] != int(main.sum() + salvaged.sum())             or d["rep_salvaged_cnt"] != int(salvaged.sum())             or d["rep_salvaged_cnt"] + d["rep_fallback_cnt"]             != int(losers.sum())             or d["total_txn_abort_cnt"] != d["rep_fallback_cnt"]:
        fail(f"repair oracle: counters {d} (main {int(main.sum())}, losers "
             f"{int(losers.sum())})")
    return {"main": int(main.sum()), "losers": int(losers.sum()),
            **{f"round{r}": int((rounds == r).sum())
               for r in range(1, eng.cfg.repair_rounds + 1)},
            "fallback": d["rep_fallback_cnt"],
            "frontier_lanes": d["rep_frontier_cnt"]}


def dgcc_oracle_epoch(eng, state, dev) -> dict:
    """One DGCC epoch against numpy: its committed txns executed serially
    in rank order give the same table and read checksum (the waves are
    a serialization of rank order); nothing aborts."""
    import dataclasses

    from deneva_tpu_torch.workloads.ycsb import TABLE
    be = eng.backend
    seen = {}

    def capture(cfg_, cc_state, batch, inc, stats=None):
        v, st = be.validate(cfg_, cc_state, batch, inc, stats=stats)
        seen["batch"], seen["verdict"] = batch, v
        return v, st
    keys_ = ("read_checksum", "total_txn_commit_cnt", "total_txn_abort_cnt",
             "defer_cnt")
    start = state.db[TABLE].columns["F0"].cpu().numpy().view(
        np.uint32).copy()
    pre = {k: int(state.stats[k]) for k in keys_}
    eng.backend = dataclasses.replace(be, validate=capture)
    try:
        state = eng.step(state)
    finally:
        eng.backend = be
    torch.cuda.synchronize()
    bt, v = seen["batch"], seen["verdict"]
    act = bt.active.cpu().numpy()
    rank = bt.rank.cpu().numpy()
    commit = v.commit.cpu().numpy() & act
    level = v.level.cpu().numpy()
    table, cks = serial_apply(start, [_by_rank(commit, rank)],
                              bt.keys.cpu().numpy().astype(np.int64),
                              bt.is_write.cpu().numpy(), rank)
    cap = eng.workload.n_rows
    got = state.db[TABLE].columns["F0"].cpu().numpy().view(np.uint32)
    if not np.array_equal(got[:cap], table[:cap]):
        fail("DGCC oracle: table differs from serial execution in rank "
             "order")
    d = {k: (int(state.stats[k]) - pre[k]) & MASK32 for k in keys_}
    if d["read_checksum"] != cks or d["total_txn_abort_cnt"] != 0             or d["total_txn_commit_cnt"] != int(commit.sum()):
        fail(f"DGCC oracle: counters {d}, serial checksum {cks}")
    return {"commits": int(commit.sum()), "defers": d["defer_cnt"],
            "waves": int(level[commit].max()) + 1}


def sync_free_epoch(eng, state, label: str):
    """One epoch with torch's sync debug mode raising on any operation
    that waits for the device: the epoch must not sync the host."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = eng.step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[no-sync] {label}: one epoch with no host sync", flush=True)
    return state


def phase_slice7_epochs(dev, card: str) -> None:
    """3 kernel epochs equal 3 plain epochs for repair (rounds 2) under
    the six sweep backends at ``repair_ablation``'s YCSB shape, for OCC
    repair at TPC-C 4 wh (escrow off), and for DGCC at YCSB theta 0.9 and
    TPC-C 4 wh; the repair and DGCC numpy oracle epochs; the cost of an
    empty DGCC pass."""
    for alg in SWEEP6:
        eng, st = epochs_equal(dev, repair_config(alg, 2), 3,
                               f"{alg} repair_ablation rounds 2")
        if alg == "OCC":
            st = sync_free_epoch(eng, st, "OCC repair rounds 2")
            info = repair_oracle_epoch(eng, st, dev)
            print(f"[repair-oracle] OCC rounds 2 epoch 5: {info} (card "
                  f"{card})", flush=True)
        del eng, st
        torch.cuda.empty_cache()
    tpcc_epochs_equal(dev, tpcc_config(4, "OCC", escrow_sweep=False,
                                       repair=True, repair_rounds=2), 3,
                      "OCC 4wh escrow off repair rounds 2")
    torch.cuda.empty_cache()
    eng, st = epochs_equal(dev, dgcc_config(0.9), 3, "DGCC theta 0.9")
    st = sync_free_epoch(eng, st, "DGCC theta 0.9")
    info = dgcc_oracle_epoch(eng, st, dev)
    print(f"[dgcc-oracle] theta 0.9 epoch 5: {info} (card {card})",
          flush=True)
    # an empty DGCC pass (a wave above the epoch's deepest): the masked
    # executor with the last-writer tournament, device and host time
    from deneva_tpu_torch.engine.step import init_device_stats
    from deneva_tpu_torch.ops import prng
    wl = eng.workload
    q = wl.generate(prng.split(prng.key_from_seed(31, dev))[1],
                    eng.cfg.epoch_batch)
    order = torch.arange(1, q.keys.shape[0] + 1, dtype=torch.int32,
                         device=dev)
    none = torch.zeros(q.keys.shape[0], dtype=torch.bool, device=dev)
    stats = init_device_stats(1, 1, dev)

    def empty_pass():
        wl.execute(st.db, q, none, order, stats, level_exec=False)
    dev_ms = cuda_ms(empty_pass)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        empty_pass()
    host_ms = (time.perf_counter() - t) / 20 * 1e3
    torch.cuda.synchronize()
    print(f"[dgcc-pass] an empty YCSB DGCC pass at B={eng.cfg.epoch_batch}: "
          f"device {dev_ms:.4f} ms, host {host_ms:.4f} ms; x{DGCC_PASSES} "
          f"passes per epoch (card {card})", flush=True)
    del eng, st
    torch.cuda.empty_cache()
    tpcc_epochs_equal(dev, tpcc_config(4, "DGCC"), 3, "DGCC 4wh")
    torch.cuda.empty_cache()


def slice7_checks(cfg, path: str, label: str, fields: dict, card: str):
    """The reference's anti-inert checks on a repair or DGCC run:
    salvages at rounds >= 1 and none at rounds 0; DGCC never aborts and
    chains past wave 0.  Prints commits per epoch beside txn/s."""
    extra = ""
    if cfg.repair:
        salv = fields["rep_salvaged_cnt"]
        if (salv > 0) != (cfg.repair_rounds > 0):
            fail(f"simulate {label}: rep_salvaged_cnt {salv} at rounds "
                 f"{cfg.repair_rounds}")
        extra = (f" salvaged={salv} fallback={fields['rep_fallback_cnt']} "
                 f"frontier={fields['rep_frontier_cnt']}")
    if "DGCC" in path:
        if fields["total_txn_abort_cnt"] != 0 or fields["dgcc_wave_max"] <= 1:
            fail(f"simulate {label}: aborts "
                 f"{fields['total_txn_abort_cnt']}, wave_max "
                 f"{fields['dgcc_wave_max']}")
        extra = (f" waves={fields['dgcc_wave_cnt']} wave_max="
                 f"{fields['dgcc_wave_max']} fallback="
                 f"{fields['dgcc_fallback_cnt']} edges="
                 f"{fields['dgcc_edge_cnt']}")
    print(f"[slice7] {label}: {fields['tput']:.1f} txn/s, "
          f"{fields['total_txn_commit_cnt'] / max(fields['epoch_cnt'], 1):.2f}"
          f" commits/epoch, abort_rate {fields['abort_rate']}{extra} "
          f"(card {card})", flush=True)


def counted(fn):
    """(fn's result, launches per kernel during it): counts set to 0 just
    before, read just after."""
    from deneva_tpu_torch import kernels
    ks = kernels.all_kernels()
    for k in ks.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {nm: k.launches for nm, k in ks.items()}


def check_launches(counts: dict, path: str, epochs: int, label: str):
    for nm, c in counts.items():
        want = PATH_LAUNCHES[path].get(nm, 0) * epochs
        if c != want:
            fail(f"{label}: {nm} launched {c} times in {epochs} epochs, "
                 f"expected {want}")


def phase_simulate(dev, cfg, path: str, label: str, card: str
                   ) -> tuple[dict, dict]:
    """``run_simulation`` with every launch count zeroed just before it;
    each kernel must launch its per-epoch count on ``path`` times the
    epochs run."""
    from deneva_tpu_torch.engine.driver import run_simulation
    from deneva_tpu_torch.stats import parse_summary
    with contextlib.ExitStack() as ctx:
        if cfg.device_parts > 1:
            from deneva_tpu_torch.parallel import use_mesh
            ctx.enter_context(use_mesh(mesh_of(dev, cfg.device_parts)))
        st, counts = counted(lambda: run_simulation(cfg, device=dev))
    fields = parse_summary(st.summary_line())
    commits = fields["total_txn_commit_cnt"]
    aborts = fields["total_txn_abort_cnt"]
    if commits <= 0 or (path not in MAY_ABORT
                        and (aborts > 0) != (path in ABORTING)):
        fail(f"simulate {label}: commits {commits} aborts {aborts}")
    check_launches(counts, path, st.epochs_run, f"simulate {label}")
    print(f"[simulate] {label}: {fields['tput']:.1f} committed txn/s on "
          f"{card}; epochs={st.epochs_run} commits={commits} "
          f"aborts={aborts} abort_rate={fields['abort_rate']} "
          f"unique_aborts={fields['unique_txn_abort_cnt']} "
          f"defers={fields.get('defer_cnt')}", flush=True)
    print(f"[simulate] {label}: {st.summary_line()}", flush=True)
    return counts, fields


def host_hot_spots(run, st, mode: str, n: int = 20):
    """The host's side of an epoch (``--profile``, TPC-C cells): how many
    times one epoch synchronizes with the device (torch's sync debug
    mode), and the port's functions that take the most host time over
    ``n`` epochs under cProfile."""
    import cProfile
    import pstats
    import warnings
    syncs = []
    real = warnings.showwarning
    warnings.showwarning = lambda msg, *a, **k: syncs.append(str(msg))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st = run(st, 1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        warnings.showwarning = real
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    st = run(st, n)
    prof.disable()
    host = (time.perf_counter() - t) / n
    torch.cuda.synchronize()
    # torch also warns once that the debug mode is a prototype; count
    # the synchronizing-operation warnings only
    n_sync = sum("called a synchronizing" in m for m in syncs)
    other = [m[:60] for m in syncs if "called a synchronizing" not in m]
    print(f"[profile] {mode}: {n_sync} host syncs in one epoch (other "
          f"warnings: {other}); host {host * 1e3:.4f} ms/epoch under "
          f"cProfile, by function (own time, then with callees, "
          f"ms/epoch):", flush=True)
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    for (fname, line, fn), (_, ncalls, tt, ct, _) in rows:
        where = fname.split("deneva_tpu_torch/")[-1] if "deneva_tpu_torch" \
            in fname else fn
        print(f"[profile]   {tt / n * 1e3:8.4f} {ct / n * 1e3:8.4f} "
              f"{ncalls / n:7.1f}x  {where}:{line} {fn}", flush=True)
    return st


def phase_profile(dev, cfg, mode: str, knobs_of=None,
                  path: str | None = None) -> None:
    """Where an epoch's time goes (``--profile`` only): host enqueue time
    and wall time per epoch, device time by kernel, and the device's idle
    share.  The profiler slows the host, so the idle share is taken
    against the unprofiled wall time per epoch; the share against the
    profiled window is printed beside it.  ``knobs_of(cfg)`` routes
    every epoch under those knobs (`Engine.run_ctrl`).  With ``path``,
    the profiled epochs' launch counts are held to its
    ``PATH_LAUNCHES``, and K11a's and K14c's device launches printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng, run, st = mesh_engine(dev, cfg)
    if knobs_of is not None:
        knobs = knobs_of(cfg)

        def run(s, n):
            return eng.run_ctrl(s, knobs, n)
    st = run(st, 20)
    torch.cuda.synchronize()
    n = 200
    t = time.perf_counter()
    st = run(st, n)
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"[profile] {mode}: host {host / n * 1e3:.4f} ms/epoch, wall "
          f"{wall / n * 1e3:.4f} ms/epoch ({n} epochs, no profiler)",
          flush=True)
    if mode.startswith(("TPCC", "PPS", "OCC repair", "DGCC",
                        "OCC ycsb_skew audited", "mesh", "router")):
        st = host_hot_spots(run, st, mode)
    m = 50
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        st, counts = counted(lambda: run(st, m))
        window = time.perf_counter() - t
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    if not by_name:
        print(f"[profile] {mode}: no device events recorded (not measured)",
              flush=True)
        return
    busy = sum(v[0] for v in by_name.values())
    ours = ("radix_", "pack_kernel", "scan_", "plan_kernel",
            "generate_kernel",
            "threefry_split", "incidence_kernel", "overlap_",
            "pack_edges", "first_fit",
            "watermark_check", "commit_max", "commit_ring", "version_read",
            "version_push", "pack_rows", "pack_cols", "earlier_edges",
            "wavefront_kernel",
            "precedence_kernel", "reach_kernel", "peel_kernel",
            "lookup_kernel", "scatter_add_", "append_kernel",
            "tpcc_generate", "merge_rank", "merge_place", "probe_kernel",
            "pps_generate", "wrote_kernel", "lanes_kernel", "lane_pack",
            "lane_unpack", "census_", "relax_kernel", "density_",
            "rank_kernel", "compact_", "observe_", "order_kernel",
            "count_kernel", "defer_kernel", "place_kernel", "fill_kernel",
            "forward_exec", "last_writer")
    mine = sum(v[0] for k, v in by_name.items()
               if any(o in k for o in ours))
    print(f"[profile] {mode}: device busy {busy / m / 1e3:.4f} ms/epoch "
          f"(hand kernels {mine / m / 1e3:.4f}, other {(busy - mine) / m / 1e3:.4f}"
          f", {sum(v[1] for v in by_name.values()) / m:.1f} device ops/epoch)"
          f"; idle share {1 - busy / m / (wall / n * 1e6):.4f} against the "
          f"unprofiled wall ({1 - busy / (window * 1e6):.4f} against the "
          f"profiled wall of {window / m * 1e3:.4f} ms/epoch)", flush=True)
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   {v[0] / m:9.2f} us/epoch  {v[1] / m:5.1f}x  "
              f"{k[:90]}", flush=True)
    if path is not None:
        check_launches(counts, path, m, f"profile {mode}")
        for nm, keys in (("K2_plan_scans", ("plan_kernel",)),
                         ("K11a_maat_reach", ("reach_",)),
                         ("K11b_maat_peel", ("peel_kernel",)),
                         ("K14c_scatter_add", ("scatter_add_",)),
                         ("K8_first_fit", ("pack_edges", "first_fit")),
                         ("K16_dgcc_relax", ("relax_kernel",)),
                         ("K3_forward_execute", ("forward_exec",)),
                         ("K10_last_writer", ("last_writer",))):
            ks = [k for k in by_name if any(x in k for x in keys)]
            dev_n = sum(by_name[k][1] for k in ks)
            dev_us = sum(by_name[k][0] for k in ks)
            if counts.get(nm):
                print(f"[profile] {mode}: {nm} {counts[nm] / m:.1f} "
                      f"launches/epoch (PATH_LAUNCHES {path}: "
                      f"{PATH_LAUNCHES[path].get(nm, 0)}), {dev_n / m:.1f} "
                      f"device kernels/epoch, {dev_us / m:.2f} us/epoch",
                      flush=True)


def order_index_window(dev, card: str) -> None:
    """``--order-index-window``: the 64-warehouse TPU_BATCH cell of
    ``tpcc_order_index`` at ``paper_base``'s real windows (10 s + 30 s),
    to see whether its 2^20-entry index overflows inside them; prints
    the epochs run when the driver refuses the run, and raises on."""
    from deneva_tpu_torch.engine import step
    from deneva_tpu_torch.engine.driver import run_simulation
    cfg = index_config(64, warmup_secs=10.0, done_secs=30.0)
    ran = [0, 0]
    real = step.Engine.run

    def run(self, state, n):
        state = real(self, state, n)
        ran[0] += n
        ran[1] = n
        return state
    step.Engine.run = run
    t = time.monotonic()
    try:
        st = run_simulation(cfg, device=dev)
    except RuntimeError as e:
        print(f"[order-index-window] refused after {ran[0]} epochs (last "
              f"chunk {ran[1]}) and {time.monotonic() - t:.1f} s, index "
              f"capacity {cfg.insert_table_cap} (card {card}): {e}",
              flush=True)
        raise
    finally:
        step.Engine.run = real
    print(f"[order-index-window] no overflow: {st.epochs_run} epochs in "
          f"{time.monotonic() - t:.1f} s (card {card})", flush=True)


# -- slice 8: the metrics and audit planes -----------------------------------

ARMED = {"audit": True, "metrics": True}
AUDIT_PIECES = (("base", "audit_lanes"), ("depgraph", "lane_sort"),
                ("depgraph", "audit_scans"), ("depgraph", "compact_edges"),
                ("base", "audit_stamps"))


def audited(cfg_fn, *a, cadence: int = 1, **kw):
    """``cfg_fn``'s configuration with the audit (``audit_cadence``, the
    reference's 2^16 buckets and 4,096-edge cap) and the metrics armed."""
    return cfg_fn(*a, audit=True, metrics=True, audit_cadence=cadence, **kw)


def slice8_cells(cadence: int = 1) -> dict:
    """The audited configurations at full width: OCC, MVCC and CALVIN at
    ``ycsb_skew`` (theta 0.9), TPU_BATCH at TPC-C 4 wh, DGCC at theta 0.9
    (32 levels) and OCC at ``repair_ablation`` rounds 2."""
    return {"OCC ycsb_skew": ("OCC+A", audited(skew_config, False, "OCC",
                                                cadence=cadence)),
            "CALVIN ycsb_skew": ("CALVIN+A", audited(
                skew_config, False, "CALVIN", cadence=cadence)),
            "TPU_BATCH tpcc 4wh": ("TPCC_CHAINED+A", audited(
                tpcc_config, 4, cadence=cadence)),
            "DGCC theta 0.9": ("DGCC+A", audited(dgcc_config, 0.9,
                                                  cadence=cadence)),
            "OCC repair rounds 2": ("OCC+R2+A", audited(
                repair_config, "OCC", 2, cadence=cadence)),
            "MVCC ycsb_skew": ("MVCC+A", audited(skew_config, False, "MVCC",
                                                  cadence=cadence))}


def make_engine(dev, cfg):
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads import get_workload
    return Engine(cfg, get_workload(cfg, device=dev))


def _clone_args(a):
    """The arguments with each dict of tensors (a stamp table) cloned."""
    return tuple({f: t.clone() for f, t in x.items()}
                 if isinstance(x, dict) else x for x in a)


@contextlib.contextmanager
def grab_pieces(specs, calls: dict):
    """Record (args, kwargs) of every call of each ``(module, name)`` and
    run it; a stamp table argument is cloned first (K17 updates it in
    place)."""
    saved = []
    for mod, name in specs:
        real = getattr(mod, name)

        def grab(*a, _real=real, _name=name, **k):
            calls.setdefault(_name, []).append((_clone_args(a), k))
            return _real(*a, **k)
        saved.append((mod, name, real))
        setattr(mod, name, grab)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def _equal_out(x, y) -> bool:
    if isinstance(x, dict):
        return all(torch.equal(x[f], y[f]) for f in x)
    if isinstance(x, (tuple, list)):
        return all(_equal_out(u, v) for u, v in zip(x, y))
    return torch.equal(x, y)


def phase_slice8_kernels(dev, rec: dict, card: str) -> None:
    """K13b on a metered OCC ``ycsb_skew`` epoch and on the forwarding main
    path's 65,536-txn batch; K17 (both launches), K15a, K15c-scan and
    K15c-compact on the inputs of one audited epoch of every slice-8
    configuration, and K15a in its wide mode on an audited DGCC epoch at
    ``epoch_batch=16384`` (the reference's bound).  Each exact against
    its plain version; the OCC epoch's times go into the kernels line,
    K13b's in two rows (the forwarding batch; B = 2,048)."""
    from deneva_tpu_torch.cc import base, depgraph
    mods = {"base": base, "depgraph": depgraph}
    # K13b, on the forwarding batch and at the sweep backends' B = 2,048
    for (label, args), nm in zip(k13b_inputs(dev, K13B_CELLS[:2]).items(),
                                 ("K13b_conflict_density",
                                  "K13b_conflict_density[B=2048]")):
        rec[nm].update(k13b_case(label, args, card))
        print_kernel(nm, rec[nm], card)
    torch.cuda.empty_cache()
    # K17, K15a, K15c on real audited epochs
    specs = [(mods[m], n) for m, n in AUDIT_PIECES]
    for label, (_path, cfg) in slice8_cells().items():
        eng = make_engine(dev, cfg)
        st = eng.run(eng.init_state(), 10)
        calls = {}
        with grab_pieces(specs, calls):
            st = eng.step(st)
        torch.cuda.synchronize()
        kern = {"audit_lanes": base.audit_lanes,
                "lane_sort": depgraph.lane_sort,
                "audit_scans": depgraph.audit_scans,
                "compact_edges": depgraph.compact_edges,
                "audit_stamps": base.audit_stamps}
        plain = {"audit_lanes": base.audit_lanes_plain,
                 "lane_sort": lambda k, p, t, n, **kw:
                 depgraph.lane_sort_plain(k, p, t),
                 "audit_scans": depgraph.audit_scans_plain,
                 "compact_edges": depgraph.compact_edges_plain,
                 "audit_stamps": base.audit_stamps_plain}
        outs = {}
        for nm in kern:
            a, k = calls[nm][0]
            x = kern[nm](*_clone_args(a), **k)
            y = plain[nm](*_clone_args(a), **k)
            if nm == "audit_lanes":
                # dead lanes: the kernel writes position 0, which no
                # output reads
                live = x[0] != depgraph.LANE_PAD
                same = torch.equal(x[0], y[0]) and torch.equal(x[2], y[2]) \
                    and torch.equal(x[1][live], y[1][live])
            else:
                same = _equal_out(x, y)
            if not same:
                fail(f"slice 8 {label}: {nm} differs from the plain version")
            outs[nm] = x
        bt, committed, order, lvl, ovis = calls["audit_lanes"][0][0][:5]
        b, a = bt.keys.shape
        n2 = 2 * b * a
        flags, e2, sbk, obs = outs["audit_scans"]
        edges, ebkt, cnt, dropped, wit = outs["compact_edges"]
        kept = min(int(cnt), eng.cfg.audit_edges_max)
        stamps = calls["audit_stamps"][0][0][0]
        kb = eng.cfg.audit_buckets
        ring = "vts" in stamps
        h = stamps["vts"].shape[1] if ring else 0
        sk, sp, sid = outs["lane_sort"]
        keys2, pos2, tid2 = calls["lane_sort"][0][0][:3]
        epoch = calls["audit_stamps"][0][0][7]
        new_st = base.audit_stamps_plain(stamps, sk, sp, sid, sbk, obs,
                                         bt.ts, epoch)[0]
        n_upd = int((new_st["epoch"] == epoch).sum())
        n_obs = int(obs.sum())
        st_t = {f: t.clone() for f, t in stamps.items()}
        okey = torch.where(committed, order, 2**31 - 1)
        slot = torch.cumsum(flags.to(torch.int32), 0) - 1
        tgt = torch.where(flags, torch.clamp(slot, max=eng.cfg.audit_edges_max),
                          eng.cfg.audit_edges_max).long()
        exp = torch.full((eng.cfg.audit_edges_max + 1,), -1,
                         dtype=torch.int32, device=dev)
        wl = ((sp & 1) == 1) & (sk != depgraph.LANE_PAD)
        sbl = sbk.long()
        wv = torch.where(wl, sp + 1, 0)
        top0 = torch.zeros(kb, dtype=torch.int32, device=dev)
        wid0 = torch.zeros_like(top0)
        sid1 = torch.where(wl, sid + 1, 0)
        n_lanes = int((sk != depgraph.LANE_PAD).sum())
        rows = {
            "K17_audit_observe[lanes]": (
                lambda: base.audit_lanes(bt, committed, order, lvl, ovis),
                lambda: base.audit_lanes_plain(bt, committed, order, lvl,
                                               ovis),
                lambda: torch.argsort(okey, stable=True),
                b * a * 12 + b * 9 + n2 * 16, b * b),
            "K15a_lane_sort": (
                lambda: depgraph.lane_sort(keys2, pos2, tid2, b,
                                           **calls["lane_sort"][0][1]),
                lambda: depgraph.lane_sort_plain(keys2, pos2, tid2),
                lambda: torch.sort(keys2 * (1 << 31) + pos2.to(torch.int64)),
                32 * n2, n2),
            "K15c_audit_scans": (
                lambda: depgraph.audit_scans(sk, sp, sid, kb),
                lambda: depgraph.audit_scans_plain(sk, sp, sid, kb), None,
                n2 * 16 + 2 * n2 * 5 + n2 * 5, 10 * n2),
            "K15c_compact_edges": (
                lambda: depgraph.compact_edges(flags, e2, sbk, lvl,
                                               eng.cfg.audit_edges_max),
                lambda: depgraph.compact_edges_plain(
                    flags, e2, sbk, lvl, eng.cfg.audit_edges_max),
                lambda: (torch.cumsum(flags, 0),
                         exp.index_copy_(0, tgt, e2)),
                2 * n2 + kept * 16 + eng.cfg.audit_edges_max * 8 + 12,
                2 * n2),
            # the lanes (key 8 B; position, id, bucket 4 B; observation
            # 1 B), the stamps read whole for vdig and written where a
            # bucket updates, the rings read at the observed buckets and
            # written where they update, the two digests
            "K17_audit_observe[stamps]": (
                lambda: base.audit_stamps(st_t, sk, sp, sid, sbk, obs,
                                          bt.ts, epoch),
                lambda: base.audit_stamps_plain(stamps, sk, sp, sid, sbk,
                                                obs, bt.ts, epoch),
                lambda: (top0.scatter_reduce_(0, sbl, wv, "amax"),
                         wid0.scatter_reduce_(0, sbl, sid1, "amax")),
                n2 * 21 + b * 4 + kb * 8 + n_upd * 8
                + (n_obs * h * 12 + n_upd * 16 if ring else 0) + 8,
                n2 + kb)}
        line = []
        for nm, (fn, pl, lib, nbytes, ops) in rows.items():
            r = {"max_abs_err": 0, "ms": cuda_ms(fn),
                 "plain_ms": cuda_ms(pl, iters=3, warmup=1),
                 "library_ms": None if lib is None else cuda_ms(lib)}
            bound(r, nbytes, ops)
            line.append(f"{nm} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                        f"library {r['library_ms']}, bound "
                        f"{r['bound_ms']:.6f})")
            if label == "OCC ycsb_skew" and nm != "K15a_lane_sort":
                rec[nm].update(r)
        if label == "OCC ycsb_skew":
            k17_rank(f"{label} epoch 11", committed, order, card)
        print(f"[slice8-kernels] {label} epoch 11: B={b} A={a} lanes={n2} "
              f"live={n_lanes} pos_max={int(pos2.max())} observed={n_obs} "
              f"buckets_stamped={n_upd} edges={int(cnt)} "
              f"dropped={int(dropped)} witnesses={int(wit)} rings={ring}: "
              + "; ".join(line) + f" (card {card})", flush=True)
        del eng, st, calls, outs
        torch.cuda.empty_cache()
    for nm in ("K17_audit_observe[lanes]", "K15c_audit_scans",
               "K15c_compact_edges", "K17_audit_observe[stamps]"):
        print_kernel(nm, rec[nm], card)
    k15a_wide(dev, card)


def k17_rank(label: str, committed, order, card: str) -> None:
    """K17's rank alone through its own entry point (``audit_rank``),
    exact against its plain version, beside a stable ``torch.argsort``
    of the order keys, both timed by CUDA events as ``cuda_ms`` times
    every kernel."""
    from deneva_tpu_torch.cc import base
    b = order.shape[0]
    if not torch.equal(base.audit_rank(committed, order),
                       base.audit_rank_plain(committed, order)):
        fail(f"K17 rank ({label}, B={b}) differs from the plain version")
    okey = torch.where(committed, order, base.INT32_MAX)
    ms = cuda_ms(lambda: base.audit_rank(committed, order))
    plain = cuda_ms(lambda: base.audit_rank_plain(committed, order),
                    iters=3, warmup=1)
    lib = cuda_ms(lambda: torch.argsort(okey, stable=True))
    # B order keys and flags in, B ranks out; the operations of the
    # cheapest algorithm known here, a radix sort's four digit passes over
    # B keys (the counting kernel's B^2 compares are its own cost, not
    # the function's)
    r = {}
    bound(r, 9 * b, 4 * b)
    print(f"[K17-rank] {label}: B={b} committed={int(committed.sum())} "
          f"{ms:.4f} ms, plain {plain:.4f} ms, stable torch.argsort "
          f"{lib:.4f} ms, bound {r['bound_ms']:.7f} ({r['bound_by']}); "
          f"exact (card {card})", flush=True)


def k15a_wide(dev, card: str, batch: int = 16384) -> None:
    """K15a's wide mode on an audited DGCC epoch at the reference's bound
    of ``epoch_batch`` (16,384): 32 levels of positions take 21 bits and
    the txn ids 14, past the packed word's 32.  K17's rank on that
    epoch's committed set."""
    from deneva_tpu_torch.cc import base, depgraph
    cfg = audited(dgcc_config, 0.9).replace(epoch_batch=batch,
                                             max_txn_in_flight=4 * batch)
    eng = make_engine(dev, cfg)
    st = eng.run(eng.init_state(), 2)
    calls = {}
    with grab_pieces(((depgraph, "lane_sort"), (base, "audit_lanes")),
                     calls):
        st = eng.step(st)
    torch.cuda.synchronize()
    (keys2, pos2, tid2, nt), kw = calls["lane_sort"][1]   # the audit's
    got = depgraph.lane_sort(keys2, pos2, tid2, nt, **kw)
    if not _equal_out(got, depgraph.lane_sort_plain(keys2, pos2, tid2)):
        fail("K15a wide: differs from the plain version")
    pb = (kw["pos_bound"] - 1).bit_length()
    tb = (nt - 1).bit_length()
    if pb + tb <= 32:
        fail(f"K15a wide: {pb} + {tb} bits fit the packed word")
    ms = cuda_ms(lambda: depgraph.lane_sort(keys2, pos2, tid2, nt, **kw))
    packed = keys2 * (1 << 31) + pos2.to(torch.int64)
    lib = cuda_ms(lambda: torch.sort(packed))
    print(f"[K15a-wide] audited DGCC epoch at B={batch}: {keys2.numel()} lanes, "
          f"pos {pb} + tid {tb} bits > 32: wide sort exact, {ms:.4f} ms, "
          f"torch.sort of the packed word {lib:.4f} ms (card {card})",
          flush=True)
    committed, order = calls["audit_lanes"][0][0][1:3]
    k17_rank(f"audited DGCC epoch at B={batch}", committed, order, card)
    del eng, st, calls
    torch.cuda.empty_cache()


# -- the numpy audit oracle ----------------------------------------------------

def np_ident(tables, keys):
    """combine_key in numpy (uint32)."""
    with np.errstate(over="ignore"):
        return (np.asarray(keys).astype(np.uint32) * np.uint32(2654435761)) \
            ^ (np.asarray(tables).astype(np.uint32) * np.uint32(0x9E3779B9))


def np_hash(ident, k):
    """bucket_hash(ident, k, family=0) in numpy."""
    with np.errstate(over="ignore"):
        h = np.asarray(ident).astype(np.uint32) ^ np.uint32(2654435761)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return (h & np.uint32(k - 1)).astype(np.int64)


def audit_oracle(bt, committed, order, lvl, order_vis, stamps, epoch, cfg):
    """One audited epoch serially per exact key, in numpy: each key's
    committed lanes by visibility position; a read's wr source is the
    latest writer before it and its rw target the first writer after it,
    a write's ww source the latest writer before it (self edges dropped);
    reads with no writer before them digest the pre-epoch stamps (under
    MVCC the newest ring boundary <= their ts); each audit bucket's new
    stamp is its latest writer.  Returns (edge multiset, rdig, new
    stamps, vdig)."""
    from collections import Counter
    t = {f: getattr(bt, f).cpu().numpy() for f in
         ("table_ids", "keys", "is_read", "is_write", "valid", "ts")}
    of = None if bt.order_free is None else bt.order_free.cpu().numpy()
    com, order, lvl = (x.cpu().numpy() for x in (committed, order, lvl))
    st = {f: v.cpu().numpy().copy() for f, v in stamps.items()}
    b, a = t["keys"].shape
    okey = np.where(com, order.astype(np.int64), 2**31 - 1)
    opos = np.empty(b, np.int64)
    opos[np.lexsort((np.arange(b), okey))] = np.arange(b)
    band = lvl.astype(np.int64) * (b + 2)
    wpos = (band + 1 + opos) * 2 + 1
    rpos = (band + 1 + opos) * 2 if order_vis else band * 2
    cm = t["valid"] & com[:, None]
    if of is not None:
        cm &= ~of
    ident = np_ident(t["table_ids"], t["keys"])
    groups: dict = {}
    for i, s in zip(*np.nonzero(cm)):
        key = int(ident[i, s])
        if key == 0xFFFFFFFF:                  # the dead sentinel
            continue
        g = groups.setdefault(key, [])
        if t["is_read"][i, s]:
            g.append((int(rpos[i]), 0, int(i)))
        if t["is_write"][i, s]:
            g.append((int(wpos[i]), 1, int(i)))
    kb = cfg.audit_buckets
    edges = Counter()
    m = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
    rdig = 0
    last = {}                                  # bucket -> (pos, writer)
    for key, lanes in groups.items():
        lanes.sort(key=lambda x: x[0])
        bk = int(np_hash(key, kb))
        prev = [-1] * len(lanes)
        w = -1
        for j, (_p, isw, tid) in enumerate(lanes):
            prev[j] = w
            if isw:
                w = tid
        nxt = -1
        for j in range(len(lanes) - 1, -1, -1):
            pos, isw, tid = lanes[j]
            if not isw and nxt >= 0 and nxt != tid:
                edges[(2, tid, nxt)] += 1
            if prev[j] >= 0 and prev[j] != tid:
                edges[(0 if isw else 1, prev[j], tid)] += 1
            if isw:
                nxt = tid
                if pos > last.get(bk, (-1, -1))[0]:
                    last[bk] = (pos, tid)
            elif prev[j] < 0:
                if "vts" in st:
                    ring = st["vts"][bk]
                    ok = (ring >= 0) & (ring <= t["ts"][tid])
                    sel = int(np.argmax(np.where(ok, ring, -1))) \
                        if ok.any() else -1
                    oe = int(st["vepoch"][bk, sel]) if sel >= 0 else -1
                    ow = int(st["vwriter"][bk, sel]) if sel >= 0 else -1
                else:
                    oe, ow = int(st["epoch"][bk]), int(st["writer"][bk])
                rdig += ((tid * m[0]) ^ (bk * m[1]) ^ ((oe & MASK32) * m[2])
                         ^ ((ow & MASK32) * m[3])) & MASK32
    for bk, (_p, wtid) in last.items():
        st["epoch"][bk] = epoch
        st["writer"][bk] = wtid
        if "vts" in st:
            h = st["vts"].shape[1]
            s = st["vpos"][bk] % h
            st["vts"][bk, s] = t["ts"][wtid]
            st["vepoch"][bk, s] = epoch
            st["vwriter"][bk, s] = wtid
            st["vpos"][bk] += 1
    with np.errstate(over="ignore"):
        vdig = int(((st["epoch"].astype(np.uint32) * np.uint32(m[0]))
                    ^ (st["writer"].astype(np.uint32) * np.uint32(m[1])))
                   .astype(np.uint64).sum()) & MASK32
    return edges, rdig & MASK32, st, vdig


def audit_oracle_epoch(eng, state, label: str, card: str):
    """One kernel epoch of an audited engine against `audit_oracle`: the
    exported edges (a multiset; when the cap dropped some, a sub-multiset
    of the cap's size), ``cnt``, ``rdig``, ``vdig`` and every stamp."""
    from collections import Counter

    from deneva_tpu_torch.cc import depgraph
    from deneva_tpu_torch.engine import step as step_mod
    seen = {}
    real = step_mod.audit_observe

    def grab(cfg, batch, committed, order, lvl, order_vis, stamps, epoch,
             n_levels, cadence=None):
        seen["args"] = (batch, committed, order, lvl, order_vis,
                        {f: v.clone() for f, v in stamps.items()},
                        int(epoch))
        out = real(cfg, batch, committed, order, lvl, order_vis, stamps,
                   epoch, n_levels, cadence=cadence)
        seen["out"] = out
        return out
    step_mod.audit_observe = grab
    try:
        state = eng.step(state)
    finally:
        step_mod.audit_observe = real
    torch.cuda.synchronize()
    bt, com, order, lvl, ovis, pre, epoch = seen["args"]
    stamps, edges, _ebkt, cnt, dropped, vdig, rdig, _wit = seen["out"]
    want, w_rdig, w_st, w_vdig = audit_oracle(bt, com, order, lvl, ovis, pre,
                                              epoch, eng.cfg)
    n = int(cnt)
    if n != sum(want.values()) or int(rdig) != w_rdig \
            or int(vdig) != w_vdig:
        fail(f"audit oracle {label}: cnt {n} rdig {int(rdig)} vdig "
             f"{int(vdig)} != {sum(want.values())} {w_rdig} {w_vdig}")
    kept = edges[edges >= 0]
    have = Counter((int(depgraph.edge_kind(e)), int(depgraph.edge_src(e)),
                    int(depgraph.edge_dst(e))) for e in kept.cpu())
    if int(dropped) == 0 and have != want:
        fail(f"audit oracle {label}: the edge multisets differ")
    if int(dropped) and (have - want or len(kept) != eng.cfg.audit_edges_max):
        fail(f"audit oracle {label}: the capped edges are no sub-multiset")
    for f, v in w_st.items():
        if not np.array_equal(stamps[f].cpu().numpy(), v):
            fail(f"audit oracle {label}: stamp table {f} differs")
    kinds = Counter(k for k, _s, _d in want.elements())
    print(f"[audit-oracle] {label} epoch {epoch}: {n} edges (ww "
          f"{kinds[0]}, wr {kinds[1]}, rw {kinds[2]}), dropped "
          f"{int(dropped)}, {int((lvl > 0).sum())} txns above level 0, "
          f"rdig {int(rdig)}, vdig {int(vdig)}, "
          f"{int((w_st['epoch'] == epoch).sum())} buckets stamped (card "
          f"{card})", flush=True)
    return state


def phase_slice8_epochs(dev, card: str) -> None:
    """Kernel epochs equal plain epochs for every slice-8 configuration at
    cadence 1, and OCC at cadence 8 (epoch 0 audited, 1-2 skipped) and
    with ``audit_mutate``; the numpy audit oracle on one epoch per
    visibility rule; armed and off OCC epochs leave equal rows; two
    sync-free armed epochs (one skipped, one audited); the mutation's
    excess witnesses sit in its window's epochs."""
    cells = slice8_cells()
    runs = [(f"{lb} audited", cfg) for lb, (_p, cfg) in cells.items()]
    runs += [("OCC ycsb_skew audited cadence 8",
              audited(skew_config, False, "OCC", cadence=8)),
             ("OCC ycsb_skew audit_mutate", audited(
                 skew_config, False, "OCC",
                 audit_mutate="occ-read-skip:1:2"))]
    oracle = {"OCC ycsb_skew audited": "level 0",
              "CALVIN ycsb_skew audited": "forwarding",
              "TPU_BATCH tpcc 4wh audited": "chained levels",
              "DGCC theta 0.9 audited": "chained waves",
              "OCC repair rounds 2 audited": "repair rounds",
              "MVCC ycsb_skew audited": "MVCC rings"}
    for label, cfg in runs:
        if cfg.workload.value == "TPCC":
            eng, st = tpcc_epochs_equal(dev, cfg, 3, label, tag="slice8")
        else:
            eng, st = epochs_equal(dev, cfg, 3, label)
        if label in oracle:
            st = audit_oracle_epoch(eng, st, f"{label} ({oracle[label]})",
                                    card)
        if label == "OCC ycsb_skew audited cadence 8":
            st = eng.run(st, 3)                       # to epoch 6
            st = sync_free_epoch(eng, st, "OCC audited, epoch 6 (skipped)")
            st = sync_free_epoch(eng, st, "OCC audited, epoch 7 (skipped)")
            st = sync_free_epoch(eng, st, "OCC audited, epoch 8 (audited)")
        del eng, st
        torch.cuda.empty_cache()
    # observation only: armed and off epochs leave the same rows
    from deneva_tpu_torch.convert import state_leaves
    states = []
    for armed in (False, True):
        eng = make_engine(dev, skew_config(False, "OCC", audit=armed,
                                           metrics=armed, audit_cadence=1))
        states.append(state_leaves(eng.run(eng.init_state(), 4)))
    off, on = states
    cap = ROWS
    for path, x in off.items():
        if path.startswith(("stats/audit_", "stats/conflict_density")):
            continue
        y = on[path]
        if path.startswith("db/") and x.ndim and x.shape[0] > cap:
            # the trash row takes the losers' writes in an unspecified
            # order (ROADMAP.md watch item 7)
            same = torch.equal(x[:cap], y[:cap]) \
                and torch.equal(x[cap + 1:], y[cap + 1:])
        else:
            same = torch.equal(x, y)
        if not same:
            fail(f"observation only: leaf {path} differs armed vs off")
    print(f"[slice8-epochs] OCC ycsb_skew: 4 armed epochs leave every row, "
          f"pool and verdict counter of the off run ({len(off)} leaves; "
          f"edges {int(on['stats/audit_edge_cnt'])}, density "
          f"{int(on['stats/conflict_density'].sum())})", flush=True)
    del states, off, on
    torch.cuda.empty_cache()
    # the mutation's window: from each state of the mutated trajectory,
    # one clean and one mutated epoch; their witness counts part exactly
    # on the window's epochs
    start, count = 3, 2
    cfg_m = audited(skew_config, False, "OCC",
                    audit_mutate=f"occ-read-skip:{start}:{count}")
    eng_m = make_engine(dev, cfg_m)
    eng_c = make_engine(dev, audited(skew_config, False, "OCC"))
    st = eng_m.init_state()
    extra = []
    for e in range(start + count + 2):
        sc = eng_c.step(copy.deepcopy(st))
        sm = eng_m.step(st)
        d = int(sm.stats["audit_wit_cnt"]) - int(sc.stats["audit_wit_cnt"])
        extra.append(d)
        inside = start <= e < start + count
        if (d > 0) != inside or d < 0:
            fail(f"audit_mutate: epoch {e} excess witnesses {d}")
        st = sm
    print(f"[slice8-mutate] OCC ycsb_skew occ-read-skip:{start}:{count}: "
          f"excess witnesses per epoch {extra} (window epochs only) (card "
          f"{card})", flush=True)
    del eng_m, eng_c, st, sc, sm
    torch.cuda.empty_cache()
    density_rank(dev, card)


def density_rank(dev, card: str) -> None:
    """``tests/test_metricsbus.py::test_density_ranks_order_like_abort_
    rates`` on the card at the paper's batch: OCC, 2,048 txns of 4
    accesses at 90% writes, 12 epochs from the load, at theta 0.6, 0.9
    and 0.99; the density summed over the epochs must rank like the
    aborts.  The reference's rule for that test sizes the bucket space to
    the table (2^16 buckets over 2^16 rows): with fewer buckets than rows
    hash-collision mass saturates the signal."""
    from deneva_tpu_torch.config import Config
    dens, aborts = [], []
    for t in (0.6, 0.9, 0.99):
        cfg = Config(cc_alg="OCC", epoch_batch=SKEW_BATCH,
                     max_txn_in_flight=2 * SKEW_BATCH,
                     conflict_buckets=1 << 16, synth_table_size=1 << 16,
                     req_per_query=4, max_accesses=4, zipf_theta=t,
                     write_perc=0.9, read_perc=0.1, metrics=True,
                     seed=7).validate()
        eng = make_engine(dev, cfg)
        st = eng.run(eng.init_state(), 12)
        dens.append(int(st.stats["conflict_density"].sum()))
        aborts.append(int(st.stats["total_txn_abort_cnt"]))
        del eng, st
    if np.argsort(dens).tolist() != np.argsort(aborts).tolist() \
            or dens[0] >= dens[2]:
        fail(f"density {dens} ranks unlike aborts {aborts}")
    print(f"[slice8-density] OCC B={SKEW_BATCH} K=2^16 over 2^16 rows, 12 "
          f"epochs at theta 0.6 / 0.9 / 0.99: density {dens}, aborts "
          f"{aborts} (same rank) (card {card})", flush=True)
    torch.cuda.empty_cache()


def slice8_checks(cfg, path: str, label: str, fields: dict, card: str):
    """The anti-inert checks of an armed run: density above zero; the
    audit counts edges where the visibility rule forwards or chains, and
    none is dropped at the reference's cap."""
    extra = ""
    if cfg.metrics:
        if fields["mb_density_total"] <= 0:
            fail(f"simulate {label}: mb_density_total "
                 f"{fields['mb_density_total']}")
        extra += (f" density {fields['mb_density_total']:.0f} "
                  f"({fields['mb_density_total'] / max(fields['epoch_cnt'], 1):.1f}"
                  f" per epoch)")
    if cfg.audit:
        if path.startswith(("CALVIN", "DGCC", "TPCC_CHAINED")) \
                and fields["audit_edge_cnt"] <= 0:
            fail(f"simulate {label}: audit_edge_cnt 0")
        extra += (f" edges {fields['audit_edge_cnt']:.0f} dropped "
                  f"{fields['audit_drop_cnt']:.0f} witnesses "
                  f"{fields['audit_wit_cnt']:.0f}")
    print(f"[slice8] {label}: {fields['tput']:.1f} txn/s, abort_rate "
          f"{fields['abort_rate']}{extra} (card {card})", flush=True)


def audit_overhead(dev, card: str, n: int = 300) -> None:
    """``--audit-overhead``: host milliseconds per epoch (wall, the epochs
    enqueued back to back and one synchronize at the end) of OCC and
    CALVIN at ``ycsb_skew`` off, with the metrics alone, and armed at
    ``audit_cadence`` 8 and 1, in turns (off, metrics, 8, 1, 1, 8,
    metrics, off) in one process on one card, each after 30 warm-up
    epochs from a fresh load."""
    order = ("off", "metrics", "cadence 8", "cadence 1")
    for alg in ("OCC", "CALVIN"):
        cfgs = {"off": skew_config(False, alg),
                "metrics": skew_config(False, alg, metrics=True),
                "cadence 8": audited(skew_config, False, alg, cadence=8),
                "cadence 1": audited(skew_config, False, alg)}
        ms = {k: [] for k in order}
        for label in order + order[::-1]:
            eng = make_engine(dev, cfgs[label])
            st = eng.run(eng.init_state(), 30)
            torch.cuda.synchronize()
            t = time.perf_counter()
            st = eng.run(st, n)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t) / n * 1e3)
            del eng, st
            torch.cuda.empty_cache()
        print(f"[audit-overhead] {alg} ycsb_skew ms/epoch over {n} epochs, "
              f"two turns each: " + "; ".join(
                  f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in ms.items())
              + f" (card {card})", flush=True)


def slice8_summary(fields: dict, card: str) -> None:
    """The slice-8 checks across runs: the mutated OCC run names more
    witnesses than the clean one; OCC's density per validated txn at
    theta 0.6, 0.9, 0.99 and the txn/s of the armed runs beside the off
    runs are written down, not gated."""
    clean = fields["OCC+A OCC ycsb_skew audited cadence 1"]["audit_wit_cnt"]
    bad = fields["OCC+A+M OCC ycsb_skew audited cadence 1 audit_mutate"][
        "audit_wit_cnt"]
    if bad <= clean:
        fail(f"audit_mutate: {bad} witnesses, clean run {clean}")
    dens, rates = [], []
    for t in (0.6, 0.9, 0.99):
        f = fields[f"OCC+D OCC ycsb_skew theta {t} metrics"]
        decided = f["total_txn_commit_cnt"] + f["total_txn_abort_cnt"] \
            + f["defer_cnt"]
        dens.append(f["mb_density_total"] / max(decided, 1))
        rates.append(f["abort_rate"])
    # not gated: 8,192 buckets over 2^24 rows saturate the bucket-space
    # signal (the reference sizes K >= rows for its ranking test; the
    # gated ranking runs in `density_rank`)
    print(f"[slice8] OCC ycsb_skew theta 0.6 / 0.9 / 0.99 (K = 8,192, "
          f"2^24 rows): density per validated txn "
          f"{[round(d, 3) for d in dens]}, abort rate {rates}; "
          f"audit_mutate witnesses {bad:.0f} against {clean:.0f} clean "
          f"(card {card})", flush=True)
    for alg, off in (("OCC", "OCC OCC ycsb_skew"),
                     ("CALVIN", "CALVIN fingerprint")):
        c8 = fields[f"{alg}+A {alg} ycsb_skew audited cadence 8"]["tput"]
        c1 = fields[f"{alg}+A {alg} ycsb_skew audited cadence 1"]["tput"]
        print(f"[slice8-overhead] {alg} ycsb_skew txn/s: off "
              f"{fields[off]['tput']:.1f}, "
              f"audit+metrics cadence 8 {c8:.1f}, cadence 1 {c1:.1f} (card "
              f"{card})", flush=True)


# -- slice 9: the mesh (device_parts > 1) on one card ----------------------

MESH_ROWS = 1 << 27             # the main path's 2^24 rows per node x 8


def mesh_of(dev, d: int):
    """A mesh of ``d`` shards, every one on this card."""
    from deneva_tpu_torch.parallel import make_mesh
    return make_mesh(d, devices=[dev] * d)


def mesh_config(d: int, **kw):
    """The forwarding main path (TPU_BATCH, full pool of 65,536, 10
    requests, theta 0.9, fingerprint rows) at 2^27 rows over ``d``
    shards: the paper's 2^24 rows per node, 8 nodes."""
    return config(False, synth_table_size=MESH_ROWS, device_parts=d, **kw)


def mesh_scaling_config(d: int, alg: str, **kw):
    """``mesh_scaling`` (``deneva_tpu/harness/experiments.py:459-487``):
    2^14 rows, 4 requests, ``epoch_batch=128`` over a pool of 1,024, 512
    buckets, theta 0.6, windows 0.5 s + 2 s, at ``device_parts=d``."""
    from deneva_tpu_torch.config import Config
    args = ["--synth_table_size=16384", "--req_per_query=4",
            "--max_accesses=4", "--epoch_batch=128",
            "--conflict_buckets=512", "--max_txn_in_flight=1024",
            "--zipf_theta=0.6", "--warmup_secs=0.5", "--done_secs=2.0",
            f"--device_parts={d}", f"--cc_alg={alg}", "--seed=7"]
    args += [f"--{k}={v}" for k, v in kw.items()]
    return Config.from_args(args)


def mesh_engine(dev, cfg):
    """(engine, run, placed initial state) of ``cfg`` over its mesh."""
    from deneva_tpu_torch.parallel import make_sharded_run
    eng = make_engine(dev, cfg)
    state = eng.init_state()
    if cfg.device_parts == 1:
        return eng, eng.run, state
    place, run = make_sharded_run(eng, mesh_of(dev, cfg.device_parts))
    return eng, run, place(state)


def filled_rows(tab, v: torch.Tensor) -> torch.Tensor:
    """A ring table's filled rows of column ``v``, block after block in
    cursor order; fails where a cursor wrapped."""
    if tab.mc_parts == 1:
        cnt, lb, cap = [int(tab.row_cnt)], 0, tab.capacity
    else:
        lb, cap, _ = tab.mc_block_rows()
        cnt = tab.row_cnt.tolist()
    if max(cnt) >= cap:
        fail(f"{tab.name}: a ring cursor wrapped")
    return torch.cat([v[d * lb:d * lb + c] for d, c in enumerate(cnt)])


def global_rows(tab, col: str) -> torch.Tensor:
    """A column's data rows in one-device order: a stacked table's blocks
    mapped back (`storage.table.mc_stacked_rows`); a ring table's filled
    rows sorted (per-block cursors order them differently from one
    cursor)."""
    from deneva_tpu_torch.storage.table import mc_stacked_rows
    v = tab.columns[col]
    if tab.ring:
        return torch.sort(filled_rows(tab, v)).values
    if tab.mc_parts == 1:
        return v[:tab.capacity]
    return v[mc_stacked_rows(tab)]


def same_as_one_device(base, state, label: str) -> int:
    """Every counter and every table's data rows (mapped back from the
    owner-major layout) of a mesh run equal the one-device run's."""
    for k, v in base.stats.items():
        if not torch.equal(v, state.stats[k]):
            fail(f"{label}: counter {k} differs from device_parts=1 "
                 f"({v.tolist()} vs {state.stats[k].tolist()})")
    rows = 0
    for name, t1 in base.db.items():
        t8 = state.db[name]
        for col in t1.columns:
            a, b = global_rows(t1, col), global_rows(t8, col)
            if not torch.equal(a, b):
                fail(f"{label}: {name}/{col} rows differ from "
                     "device_parts=1")
            rows += a.shape[0]
        if t1.ring and int(t1.row_cnt) != int(t8.row_cnt.sum()):
            fail(f"{label}: {name} holds another row count")
    return rows


def differing_leaf(sk, sp) -> str | None:
    """The first leaf of two states that differs, or None: every leaf
    exactly but each table's trash row (each block's, in the owner-major
    layout), which the masked scatter writes in an unspecified order."""
    from deneva_tpu_torch.convert import state_leaves
    lk, lp = state_leaves(sk), state_leaves(sp)
    for path, x in lk.items():
        y = lp[path]
        tab = sk.db.get(path.split("/")[1]) if path.startswith("db/") \
            else None
        if not hasattr(tab, "capacity") or x.ndim == 0 \
                or path.endswith("row_cnt"):
            if not torch.equal(x, y):
                return path
            continue
        keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        if tab.mc_parts > 1:
            lb, _, trash = tab.mc_block_rows()
            keep[trash::lb] = False
        else:
            keep[tab.capacity] = False
        if not torch.equal(x[keep], y[keep]):
            return path
    return None


def mesh_equal_epochs(dev, cfg, n: int, label: str):
    """``n`` epochs of ``cfg`` through the kernels equal ``n`` through the
    plain versions, every leaf but each block's trash row (the masked
    scatter writes it in an unspecified order).  Returns the kernel state
    and the kernels' launches in those epochs."""
    t = time.monotonic()
    eng_k, run_k, sk = mesh_engine(dev, cfg)
    eng_p = make_engine(dev, cfg)
    run_p = eng_p.run
    if cfg.device_parts > 1:
        from deneva_tpu_torch.parallel import make_sharded_run
        run_p = make_sharded_run(eng_p, mesh_of(dev, cfg.device_parts))[1]
    sp = copy.deepcopy(sk)
    sk, counts = counted(lambda: run_k(sk, n))
    with plain_path(eng_p.workload):
        sp = run_p(sp, n)
    torch.cuda.synchronize()
    bad = differing_leaf(sk, sp)
    if bad:
        fail(f"{label}: leaf {bad} differs between kernel and plain epochs")
    del sp
    print(f"[mesh-epochs] {label}: {n} kernel epochs == {n} plain epochs "
          f"in {time.monotonic() - t:.1f} s", flush=True)
    return eng_k, run_k, sk, counts


def phase_slice9_kernels(dev, rec: dict, card: str) -> None:
    """K18a and K18b against their plain versions on each shard's call of
    a real main-path epoch at D = 8 and 2^27 rows (after two epochs, so
    the pool holds txns of several ages)."""
    from deneva_tpu_torch.ops import forward
    cfg = mesh_config(8)
    eng, run, st = mesh_engine(dev, cfg)
    st = run(st, 2)
    ca, cb = [], []
    with grab_calls(forward, "mc_slice_defer", ca), \
            grab_calls(forward, "mc_pack_blocks", cb):
        st = run(st, 1)
    torch.cuda.synchronize()
    if len(ca) != 8 or len(cb) != 8:
        fail(f"K18: {len(ca)} / {len(cb)} calls in one D = 8 epoch")
    n_dfr = []
    for a, b in zip(ca, cb):
        dfr, order = forward.mc_slice_defer(*a)
        dfr_p, order_p = forward.mc_slice_defer_plain(*a)
        if not (torch.equal(dfr, dfr_p) and torch.equal(order, order_p)):
            fail("K18a differs from plain")
        got = forward.mc_pack_blocks(*b)
        want = forward.mc_pack_blocks_plain(*b[:6], *b[7:])
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail("K18b differs from plain")
        n_dfr.append(int(dfr.sum()))
    keys, valid, ts, d, cap = ca[0]
    bd, a = keys.shape
    b = cb[0]
    lanes = bd * a
    owner = torch.where(valid, keys.to(torch.int64) % d, d).reshape(-1)
    word = (owner << 32) | ts[:, None].expand(bd, a).reshape(-1).to(
        torch.int64)
    lib = cuda_ms(lambda: torch.sort(word, stable=True))
    rec["K18a_mc_defer"].update(
        max_abs_err=0, ms=cuda_ms(lambda: forward.mc_slice_defer(*ca[0])),
        plain_ms=cuda_ms(lambda: forward.mc_slice_defer_plain(*ca[0]),
                         iters=5),
        library_ms=lib)
    # keys, valid and ts in; the defer flags and the order out; a count
    # and an owner per lane, a compare and an add per txn and owner
    bound(rec["K18a_mc_defer"], 5 * lanes + 4 * bd + bd + 4 * bd,
          2 * lanes + 2 * bd * d)
    # K18a at D = 4 (slices of 16,384 txns)
    a4 = k18a_inputs(dev, (4,))["D=4"]
    bd4 = a4[0].shape[0]
    owner4 = torch.where(a4[1], a4[0].to(torch.int64) % 4, 4).reshape(-1)
    word4 = (owner4 << 32) | a4[2][:, None].expand(bd4, a).reshape(-1).to(
        torch.int64)
    rec["K18a_mc_defer[D=4]"].update(
        max_abs_err=0, ms=k18a_case("D=4", a4, card),
        plain_ms=cuda_ms(lambda: forward.mc_slice_defer_plain(*a4),
                         iters=5),
        library_ms=cuda_ms(lambda: torch.sort(word4, stable=True)))
    bound(rec["K18a_mc_defer[D=4]"], 5 * bd4 * a + 4 * bd4 + bd4 + 4 * bd4,
          2 * bd4 * a + 2 * bd4 * 4)
    del a4, owner4, word4
    rec["K18b_mc_pack"].update(
        max_abs_err=0, ms=cuda_ms(lambda: forward.mc_pack_blocks(*b)),
        plain_ms=cuda_ms(lambda: forward.mc_pack_blocks_plain(
            *b[:6], *b[7:]), iters=5),
        library_ms=lib)
    # keys, valid, write flags, rank, flags and order in; D blocks of
    # (key, rank, write) out
    bound(rec["K18b_mc_pack"], 6 * lanes + 4 * bd + bd + 4 * bd
          + 9 * d * cap, 3 * lanes + 2 * bd * d)
    print(f"[K18] D=8 at 2^27 rows: slices of {bd} txns x {a} lanes, "
          f"pair_cap {cap}, defers per shard {n_dfr}", flush=True)
    for nm in ("K18a_mc_defer", "K18a_mc_defer[D=4]", "K18b_mc_pack"):
        print_kernel(nm, rec[nm], card)
    del eng, st, ca, cb
    torch.cuda.empty_cache()


def phase_slice9_epochs(dev, card: str) -> None:
    """The mesh on one card: the main path at 2^27 rows over D = 1, 2, 4
    and 8 shards (kernel epochs equal plain epochs; every counter and
    every data row equal D = 1's); the tight-capacity defers and the
    replicated-plan branch; ``mesh_scaling``'s cells, TPC-C at 64
    warehouses and PPS at D = 8 against D = 1."""
    from deneva_tpu_torch.ops import mc_pair_cap
    from deneva_tpu_torch.parallel import a2a_bytes_per_epoch
    n = 3
    base = None
    for d in (1, 2, 4, 8):
        cfg = mesh_config(d)
        _, _, st, counts = mesh_equal_epochs(dev, cfg, n, f"D={d} 2^27")
        s = {k: int(v.sum()) for k, v in st.stats.items()}
        if s["total_txn_abort_cnt"] or s["defer_cnt"]:
            fail(f"[mesh] D={d}: aborts {s['total_txn_abort_cnt']} defers "
                 f"{s['defer_cnt']}: the identity with D=1 needs none")
        want = PATH_LAUNCHES["TPU_BATCH"] if d == 1 else PATH_LAUNCHES[
            f"MESH{d}" if mc_pair_cap(BATCH, REQ, d, cfg.mc_plan_capacity)
            else f"MESH_REPL{d}"]
        for nm, c in counts.items():
            if c != n * want.get(nm, 0):
                fail(f"[mesh] D={d}: {nm} launched {c} times in {n} epochs")
        if d == 1:
            base = st
            rows = 0
        else:
            rows = same_as_one_device(base, st, f"[mesh] D={d}")
        print(f"[mesh] D={d} ({d} shards on one card, {card}): pair_cap "
              f"{mc_pair_cap(BATCH, REQ, d, cfg.mc_plan_capacity)}, K18a "
              f"{counts['K18a_mc_defer']} K18b {counts['K18b_mc_pack']} "
              f"K1 {counts['K1_sort_lanes']} launches, defer_cnt "
              f"{s['defer_cnt']}, commits {s['total_txn_commit_cnt']}, "
              f"a2a_bytes_per_epoch {a2a_bytes_per_epoch(cfg, BATCH)}; "
              f"counters and {rows} data rows == D=1", flush=True)
        del st
        torch.cuda.empty_cache()
    # the replicated-plan branch at D = 8: one epoch, no K18
    cfg = mesh_config(8, mc_plan_capacity=0)
    _, _, st, counts = mesh_equal_epochs(dev, cfg, 1, "D=8 2^27 "
                                         "mc_plan_capacity=0")
    if counts["K18a_mc_defer"] or counts["K1_sort_lanes"] != 8:
        fail("[mesh] the replicated plan launched K18 or not K1 per shard")
    first = make_engine(dev, mesh_config(1))
    one = first.run(first.init_state(), 1)
    same_as_one_device(one, st, "[mesh] D=8 replicated plan")
    print(f"[mesh] D=8 mc_plan_capacity=0: 1 epoch == D=1's, K1 "
          f"{counts['K1_sort_lanes']} K18a {counts['K18a_mc_defer']}",
          flush=True)
    del st, one, first, base
    torch.cuda.empty_cache()
    # tight capacity (tests/test_parallel.py:197-216): defers, no abort,
    # every admitted txn committed or still in flight
    cfg = config(False, epoch_batch=4096, max_txn_in_flight=4096,
                 synth_table_size=4096, req_per_query=4, max_accesses=4,
                 conflict_buckets=1024, device_parts=8,
                 mc_plan_capacity=0.25)
    _, run, st, counts = mesh_equal_epochs(dev, cfg, 3, "tight capacity")
    st = run(st, 5)
    s = {k: int(v.sum()) for k, v in st.stats.items()}
    inflight = int(st.pool.occupied.sum())
    if not (s["defer_cnt"] > 0 and s["total_txn_abort_cnt"] == 0
            and s["total_txn_commit_cnt"] + inflight == s["admitted_cnt"]):
        fail(f"[mesh] tight capacity: {s} in flight {inflight}")
    print(f"[mesh-tight] D=8 mc_plan_capacity=0.25, 8 epochs: defer_cnt "
          f"{s['defer_cnt']}, commits {s['total_txn_commit_cnt']}, aborts "
          f"0, in flight {inflight}, admitted {s['admitted_cnt']}; K18a "
          f"{counts['K18a_mc_defer']} launches in 3", flush=True)
    del st
    # the generic path: mesh_scaling's cells, TPC-C, PPS
    for alg in ("TPU_BATCH", "CALVIN"):
        eng = make_engine(dev, mesh_scaling_config(1, alg))
        one = eng.run(eng.init_state(), 10)
        for d in (2, 4, 8):
            _, run, st = mesh_engine(dev, mesh_scaling_config(d, alg))
            same_as_one_device(one, run(st, 10),
                               f"[mesh] mesh_scaling {alg} D={d}")
        print(f"[mesh] mesh_scaling {alg}: D=2/4/8 == D=1 over 10 epochs",
              flush=True)
    for label, cfg1 in (("TPC-C 64wh TPU_BATCH", tpcc_config(64)),
                        ("TPC-C 64wh NO_WAIT", tpcc_config(64, "NO_WAIT")),
                        ("PPS TPU_BATCH", pps_config()),
                        ("PPS MAAT", pps_config("MAAT"))):
        t = time.monotonic()
        eng = make_engine(dev, cfg1)
        st0 = eng.init_state()
        sums = None
        if cfg1.workload == "TPCC":
            sums = [float(st0.db[nm].columns[c][:st0.db[nm].capacity]
                          .double().sum())
                    for nm, c in (("DISTRICT", "D_YTD"),
                                  ("WAREHOUSE", "W_YTD"),
                                  ("CUSTOMER", "C_BALANCE"))]
        one = eng.run(st0, 3)
        _, run, st = mesh_engine(dev, cfg1.replace(device_parts=8))
        st = run(st, 3)
        same_as_one_device(one, st, f"[mesh] {label} D=8")
        info = ""
        if sums is not None:
            info = f"; invariants {tpcc_invariants(flat_state(st), *sums)}"
        print(f"[mesh] {label}: D=8 == D=1 over 3 epochs (commits "
              f"{int(st.stats['total_txn_commit_cnt'])}) in "
              f"{time.monotonic() - t:.1f} s{info}", flush=True)
        del one, st, st0, eng
        torch.cuda.empty_cache()


# -- slice 11: partitioned keyspaces and the contention router --------------

PART = 4                        # part_cnt of the slice's cells
ROUTER_BUCKETS = 1 << 18        # the router cell's conflict_buckets


def part_cfg(cfg_fn, *a, **kw):
    """``cfg_fn``'s cell over ``part_cnt = 4`` partitions of four times
    its keys: node 0 stores the paper's per-node table (2^24 YCSB rows,
    or a quarter of TPC-C's warehouses / PPS's keys)."""
    if cfg_fn in (config, occ_config, skew_config):
        kw.setdefault("synth_table_size", PART * ROWS)
    return cfg_fn(*a, part_cnt=PART, **kw)


def router_cfg(**kw):
    """The router's cell: the ``ycsb_skew`` shape (B = 2,048 over a pool
    of 10,000, 10 requests, dual hashing) over 2^26 keys in 4
    partitions at theta 0.6, with the metrics plane, the audit plane at
    cadence 1 and repair (2 rounds), routed (``ctrl``, escrow exemptions
    off as its pin requires).  The bucket space is 2^18: at 8,192
    buckets the epoch's 20,480 lanes leave almost no txn of a mixed
    epoch without a cross-group bucket, and nearly every one defers."""
    kw = {"metrics": True, "audit": True, "audit_cadence": 1,
          "repair": True, "repair_rounds": 2, "ctrl": True,
          "escrow_order_free": False, "zipf_theta": 0.6, **kw}
    return part_cfg(skew_config, False, kw.pop("cc_alg", "OCC"),
                    **kw).replace(conflict_buckets=ROUTER_BUCKETS)


def untouched_pad(state, label: str) -> None:
    """Every table's trash and pad rows (and the version ring's) still
    hold the loader's 0: no store of the port writes them."""
    from deneva_tpu_torch.storage.table import DeviceTable, VersionRing
    from deneva_tpu_torch.workloads.ycsb import TABLE
    for name, t in state.db.items():
        if isinstance(t, DeviceTable):
            for c, v in t.columns.items():
                if v[t.capacity:].any():
                    fail(f"{label}: {name}.{c} trash or pad row written")
        elif isinstance(t, VersionRing):
            cap = state.db[TABLE].capacity
            if t.wts[cap * t.depth:].any():
                fail(f"{label}: the version ring's trash rows written")


def kernel_vs_plain(dev, cfg, run, n: int, path: str | None, label: str,
                    total: dict):
    """``run(engine, state, n)`` on a kernel engine and on a plain one
    from the same state: every leaf equal, trash and pad rows included
    (both leave them 0).  With ``path`` the kernel run launches its count
    per epoch; its launches add into ``total``.  Returns the kernel
    engine, its state, its launches and the number of leaves."""
    from deneva_tpu_torch.convert import state_leaves
    ek, ep = tpcc_engine(dev, cfg), tpcc_engine(dev, cfg)
    sk = ek.init_state()
    sp = copy.deepcopy(sk)
    sk, counts = counted(lambda: run(ek, sk, n))
    if path is not None:
        check_launches(counts, path, n, label)
    for nm, c in counts.items():
        row = k8_row(nm, cfg.epoch_batch)
        total[row] = total.get(row, 0) + c
    with plain_path(ep.workload):
        sp = run(ep, sp, n)
    torch.cuda.synchronize()
    lk, lp = state_leaves(sk), state_leaves(sp)
    for p_, x in lk.items():
        if not torch.equal(x, lp[p_]):
            fail(f"{label}: leaf {p_} differs between kernel and plain "
                 "epochs")
    untouched_pad(sk, label)
    n_leaves = len(lk)
    del ep, sp, lk, lp
    torch.cuda.empty_cache()
    return ek, sk, counts, n_leaves


def part_epochs(dev, cfg, path: str, n: int, label: str, card: str,
                total: dict) -> None:
    """``n`` kernel epochs at part_cnt = 4 equal ``n`` plain epochs
    (`kernel_vs_plain`); the kernel run launches ``path``'s count per
    epoch."""
    t = time.monotonic()
    ek, sk, _c, n_leaves = kernel_vs_plain(
        dev, cfg, lambda e, s, m: e.run(s, m), n, path, f"[part] {label}",
        total)
    planned = ek.workload.plan(sk.db, sk.pool.queries)
    foreign = int(((planned["owner"] != cfg.node_id)
                   & planned["valid"]).sum())
    lanes = int(planned["valid"].sum())
    dens = sk.stats["conflict_density"].tolist() if cfg.metrics else None
    print(f"[part] {label}: {n} kernel epochs == {n} plain epochs "
          f"({n_leaves} leaves, trash and pad rows 0); commits "
          f"{int(sk.stats['total_txn_commit_cnt'])} aborts "
          f"{int(sk.stats['total_txn_abort_cnt'])}; pool lanes non-owned "
          f"{foreign} of {lanes}; density {dens} in "
          f"{time.monotonic() - t:.1f} s on {card}", flush=True)
    del ek, sk
    torch.cuda.empty_cache()


def phase_part(dev, card: str) -> dict:
    """[part]: epochs at part_cnt = 4, kernel against plain; YCSB's
    forwarding epoch also against the numpy serial oracle.  Returns the
    kernel runs' launches."""
    total: dict[str, int] = {}
    for full in (False, True):
        mode = "full_row" if full else "fingerprint"
        part_epochs(dev, part_cfg(config, full, metrics=True), "TPU_BATCH+D",
                    2, f"YCSB forwarding 2^26 keys {mode}", card, total)
    for alg, path in (("OCC", "OCC+D"), ("MVCC", "MVCC")):
        extra = {"metrics": True} if alg == "OCC" else {}
        part_epochs(dev, part_cfg(skew_config, False, alg, **extra), path, 3,
                    f"YCSB {alg} ycsb_skew 2^26 keys", card, total)
    part_epochs(dev, part_cfg(tpcc_config, 64), "TPCC_CHAINED", 2,
                "TPC-C 64 wh (16 local)", card, total)
    part_epochs(dev, part_cfg(pps_config), "PPS_CHAINED", 2,
                "PPS pps_scaling", card, total)
    # the forwarding epoch against serial execution: a non-owned read
    # folds the trash row's 0 unless forwarded
    cfg = part_cfg(config, False)
    eng = tpcc_engine(dev, cfg)
    st = eng.run(eng.init_state(), 2)
    part_oracle_epoch(eng, st, dev)
    del eng, st
    torch.cuda.empty_cache()
    return total


def part_oracle_epoch(eng, state, dev) -> None:
    """One forwarding epoch at part_cnt = 4 against serial execution in
    rank order over the whole keyspace: owned reads fold their slot's
    epoch-start value (or their forwarded writer's), non-owned reads the
    trash row's 0 unless forwarded; owned keys' last writers land, the
    trash row stays 0."""
    from deneva_tpu_torch.workloads.ycsb import TABLE
    p = eng.cfg.part_cnt
    start = state.db[TABLE].columns["F0"].clone()
    pre = int(state.stats["read_checksum"])
    state = eng.step(state)
    torch.cuda.synchronize()
    keys = state.pool.queries.keys.cpu().numpy().astype(np.int64)
    isw = state.pool.queries.is_write.cpu().numpy()
    seq = state.pool.seq.cpu().numpy().astype(np.int64)
    lk, lw = keys.reshape(-1), isw.reshape(-1)
    comp = (lk << 32) | np.repeat(seq, keys.shape[1])
    wc = np.sort(comp[lw])
    rk, rc = lk[~lw], comp[~lw]
    pos = np.searchsorted(wc, rc, side="left") - 1
    prev = wc[np.maximum(pos, 0)]
    fwd = np.where((pos >= 0) & ((prev >> 32) == rk), prev & MASK32, -1)
    owned = rk % p == 0
    rows = start.cpu().numpy().view(np.uint32)
    vals = np.where(fwd >= 0, np_fingerprint(rk, np.maximum(fwd, 0)),
                    np.where(owned, rows[np.where(owned, rk // p, 0)], 0))
    cks = int(vals.astype(np.uint64).sum()) & MASK32
    got = (int(state.stats["read_checksum"]) - pre) & MASK32
    if got != cks:
        fail(f"[part] oracle: checksum {got} != serial {cks}")
    wkey = wc >> 32
    last = np.r_[wkey[1:] != wkey[:-1], True]
    win_k, win_r = wkey[last], wc[last] & MASK32
    mine = win_k % p == 0
    expect = rows.copy()
    expect[win_k[mine] // p] = np_fingerprint(win_k[mine], win_r[mine])
    if not np.array_equal(
            state.db[TABLE].columns["F0"].cpu().numpy().view(np.uint32),
            expect):
        fail("[part] oracle: table differs from the serial apply")
    print(f"[part] oracle epoch ok: reads {len(rk)} (non-owned "
          f"{int((~owned).sum())}, forwarded {int((fwd >= 0).sum())}), "
          f"owned keys written {int(mine.sum())}", flush=True)


def k21_library(inc, batch, group, n_groups: int):
    """The reference's 2 + 4G einsums as bf16 ``torch.einsum`` (timed
    only: bf16 cannot hold the larger masses exactly)."""
    u1, w1 = inc.u1, inc.w1
    act = batch.active.to(torch.bfloat16)
    tot_w = torch.einsum("bk,b->k", w1, act)
    tot_u = torch.einsum("bk,b->k", u1, act)
    conf = torch.zeros(group.shape, dtype=torch.float32, device=u1.device)
    for g in range(n_groups):
        m = act * (group == g).to(torch.bfloat16)
        oth_w = tot_w - torch.einsum("bk,b->k", w1, m)
        oth_u = tot_u - torch.einsum("bk,b->k", u1, m)
        c_g = torch.einsum("bk,k->b", u1, oth_w).float() \
            + torch.einsum("bk,k->b", w1, oth_u).float()
        conf = torch.where(group == g, c_g, conf)
    return batch.active & (conf > 0.5)


def phase_k21(dev, rec: dict, card: str) -> None:
    """[K21]: the cross-group defer against its plain version on a
    generated ``ycsb_skew`` batch at part_cnt = 4 (B = 2,048, 10
    accesses), groups from the knobs [0, 1, 2, 2] (G = 3) and
    [0, 1, 2, 3] (G = 4), at K = 8,192 and at K = 64 (buckets collide)."""
    from deneva_tpu_torch.cc import base, router
    from deneva_tpu_torch.ops import prng
    cfg = router_cfg()
    wl = tpcc_engine(dev, cfg).workload
    q = wl.generate(prng.key_from_seed(21, dev), SKEW_BATCH)
    p = wl.plan(None, q)
    g = torch.Generator(device="cpu").manual_seed(21)
    active = (torch.rand(SKEW_BATCH, generator=g) < 0.9).to(dev)
    ts = torch.arange(1, SKEW_BATCH + 1, dtype=torch.int32, device=dev)
    bt = base.AccessBatch(
        table_ids=p["table_ids"], keys=p["keys"], is_read=p["is_read"],
        is_write=p["is_write"], valid=p["valid"], ts=ts, rank=ts - 1,
        active=active)
    b, a = bt.keys.shape
    r = rec["K21_cross_group_defer"]
    worst = 0
    for k in (BUCKETS, 64, ROUTER_BUCKETS):
        inc = base.build_incidence(bt, k, True, views=("u", "w"))
        for assign in ([0, 1, 2, 2], [0, 1, 2, 3]):
            n_g = 4 if 3 in assign else 3
            kn = router.knobs_from_decision(cfg, assign, [0] * PART, 1, 1,
                                            dev)
            grp = router.txn_backend(kn, p["owner"])
            out = router.cross_group_defer(inc, bt, grp, n_g)
            ref = router.cross_group_defer_plain(inc, bt, grp, n_g)
            err = int((out != ref).sum())
            if err:
                fail(f"K21 (K={k}, G={n_g}): {err} txns differ from plain")
            worst = max(worst, err)
            print(f"[K21] K={k} G={n_g}: exact; deferred "
                  f"{int(out.sum())} of {int(active.sum())} active",
                  flush=True)
            if k == BUCKETS and n_g == 4:
                r.update(max_abs_err=worst,
                         ms=cuda_ms(lambda: router.cross_group_defer(
                             inc, bt, grp, n_g)),
                         plain_ms=cuda_ms(lambda: router.
                                          cross_group_defer_plain(
                                              inc, bt, grp, n_g)),
                         library_ms=cuda_ms(lambda: k21_library(
                             inc, bt, grp, n_g)))
                # the function's traffic: lanes (bucket, three flags)
                # read and B x (active, group) read, out written, once;
                # the count tables are the kernel's scratch
                bound(r, b * a * 7 + b * 6, b * a * 4)
    r["max_abs_err"] = worst
    print_kernel("K21_cross_group_defer", r, card)


def capture_mixed(eng, state, knobs):
    """One routed epoch with the mixed branch's inputs and verdict
    captured: (state', {batch, group, crossdef, groups, verdict})."""
    from deneva_tpu_torch.cc import router
    from deneva_tpu_torch.engine import step as step_mod
    seen = {}
    k21, runl = router.cross_group_defer, step_mod._run_levels

    def cgd(inc, batch, group, n_groups=3):
        out = k21(inc, batch, group, n_groups)
        seen.update(batch=batch, group=group, crossdef=out, groups=n_groups)
        return out

    def levels(cfg, wl, db, queries, exec_commit, verdict, stats, **kw):
        seen["verdict"] = verdict
        return runl(cfg, wl, db, queries, exec_commit, verdict, stats, **kw)
    router.cross_group_defer, step_mod._run_levels = cgd, levels
    try:
        state = eng.step(state, knobs)
    finally:
        router.cross_group_defer, step_mod._run_levels = k21, runl
    torch.cuda.synchronize()
    return state, seen


def mixed_oracle(cfg, seen: dict) -> dict:
    """The committed set of one mixed epoch in numpy, in the (coarsened)
    bucket space: K21's defers re-derived from the lanes; no two
    committed txns of different groups conflict (family 1, either way);
    inside each group the backend's own rule holds (NO_WAIT: no conflict
    either way; OCC: no earlier committed writer of a later committed
    txn's access; TPU_BATCH: none inside one level; each under both
    hash families)."""
    bt, v = seen["batch"], seen["verdict"]
    keys = bt.keys.cpu().numpy().astype(np.int64)
    isw, isr = bt.is_write.cpu().numpy(), bt.is_read.cpu().numpy()
    valid = bt.valid.cpu().numpy()
    act = bt.active.cpu().numpy()
    grp = seen["group"].cpu().numpy()
    rank = bt.rank.cpu().numpy()
    commit = v.commit.cpu().numpy() & act
    level = v.level.cpu().numpy()
    b, k, n_g = len(rank), cfg.conflict_buckets, seen["groups"]
    lane_u = valid & act[:, None] & (isr | isw)
    lane_w = valid & act[:, None] & isw
    rows = np.repeat(np.arange(b), keys.shape[1])

    def dense(cols, lanes):
        m = np.zeros((b, k), np.float32)
        sel = lanes.reshape(-1)
        m[rows[sel], cols.reshape(-1)[sel]] = 1
        return m
    fam = [(dense(np_bucket(keys, f, k), lane_u),
            dense(np_bucket(keys, f, k), lane_w)) for f in (0, 1)]
    u1, w1 = fam[0]
    # K21 from its definition
    tot_u, tot_w = u1.sum(0), w1.sum(0)
    want = np.zeros(b, bool)
    for g in range(n_g):
        m = grp == g
        ow = tot_w - w1[m].sum(0)
        ou = tot_u - u1[m].sum(0)
        hit = (u1 @ (ow > 0)) + (w1 @ (ou > 0)) > 0
        want |= m & hit
    want &= act
    if not np.array_equal(want, seen["crossdef"].cpu().numpy()):
        fail("router oracle: K21's defers differ from their definition")
    c = np.flatnonzero(commit)
    uw = [(fu[c] @ fw[c].T) > 0 for fu, fw in fam]   # [i, j]: U_i meets W_j
    both = uw[0] & uw[1]
    gi = grp[c]
    cross = gi[:, None] != gi[None, :]
    if (uw[0] & cross).any() or (uw[0].T & cross).any():
        fail("router oracle: two committed txns of different groups "
             "conflict")
    from deneva_tpu_torch.cc.router import candidates
    for g, alg in enumerate(candidates(cfg)):
        m = (gi[:, None] == g) & (gi[None, :] == g)
        np.fill_diagonal(m, False)
        if alg.value == "NO_WAIT":
            bad = both & m
        elif alg.value == "OCC":
            # j committed before i (by rank) and writes what i accesses
            rc = rank[c]
            bad = both & m & (rc[None, :] < rc[:, None])
        elif alg.value == "TPU_BATCH":
            lc = level[c]
            bad = both & m & (lc[:, None] == lc[None, :])
        else:
            continue
        if bad.any():
            fail(f"router oracle: committed {alg.value} txns conflict "
                 f"({int(bad.sum())} pairs)")
    return {"active": int(act.sum()), "commit": int(commit.sum()),
            "crossdef": int(want.sum()),
            "by_group": [int((commit & (grp == g)).sum())
                         for g in range(n_g)]}


def routed_equal(dev, cfg, knobs, n: int, label: str, card: str,
                 path: str | None, total: dict):
    """``n`` routed kernel epochs equal ``n`` routed plain epochs on every
    leaf; with ``path`` the kernel run launches its count per epoch.
    Returns the kernel engine and state."""
    t = time.monotonic()
    ek, sk, counts, n_leaves = kernel_vs_plain(
        dev, cfg, lambda e, s, m: e.run_ctrl(s, knobs, m), n, path,
        f"[router] {label}", total)
    st = {k_: int(v.sum()) for k_, v in sk.stats.items()}
    print(f"[router] {label}: {n} kernel epochs == {n} plain epochs "
          f"({n_leaves} leaves); commits {st['total_txn_commit_cnt']} aborts "
          f"{st['total_txn_abort_cnt']} defers {st['defer_cnt']} salvaged "
          f"{st['rep_salvaged_cnt']} waves {st['dgcc_wave_cnt']} K21 "
          f"{counts['K21_cross_group_defer']} in "
          f"{time.monotonic() - t:.1f} s on {card}", flush=True)
    return ek, sk


def phase_router(dev, card: str) -> dict:
    """[router]: routed epochs at the router's cell.  (i) static knobs
    equal the unrouted step leaf by leaf; (ii) mixed [0, 1, 2, 2] with
    gshift [0, 2, 0, 0], repair_cap 1, audit_cadence 2 and (iii)
    ctrl_dgcc's [0, 1, 2, 3], each kernel against plain, then one more
    mixed epoch against the numpy oracle of its committed set.  Returns
    the kernel runs' launches."""
    from deneva_tpu_torch.cc import router
    from deneva_tpu_torch.convert import state_leaves
    total: dict[str, int] = {}
    t = time.monotonic()
    cfg = router_cfg()
    e1, e2 = tpcc_engine(dev, cfg), tpcc_engine(dev, cfg)
    s1 = e1.init_state()
    s2 = copy.deepcopy(s1)
    s1 = e1.run(s1, 3)
    s2, counts = counted(lambda: e2.run_ctrl(
        s2, router.static_knobs(cfg, dev), 3))
    check_launches(counts, "OCC+R2+A", 3, "[router] static knobs")
    l1, l2 = state_leaves(s1), state_leaves(s2)
    for p_, x in l1.items():
        if not torch.equal(x, l2[p_]):
            fail(f"[router] static knobs: leaf {p_} differs from the "
                 "unrouted epochs")
    print(f"[router] static knobs: 3 routed epochs == 3 unrouted epochs "
          f"({len(l1)} leaves) in {time.monotonic() - t:.1f} s",
          flush=True)
    del e1, e2, s1, s2, l1, l2
    torch.cuda.empty_cache()
    for label, extra, assign, gshift, path in (
            ("mixed", {}, [0, 1, 2, 2], [0, 2, 0, 0], "ROUTED_MIXED"),
            ("mixed ctrl_dgcc", {"ctrl_dgcc": True}, [0, 1, 2, 3],
             [0, 2, 0, 0], "ROUTED_MIXED_DGCC")):
        cfg = router_cfg(**extra)
        kn = router.knobs_from_decision(cfg, assign, gshift, 1, 2, dev)
        eng, st = routed_equal(dev, cfg, kn, 3, label, card, path, total)
        st, seen = capture_mixed(eng, st, kn)
        o = mixed_oracle(cfg, seen)
        print(f"[router] {label} oracle epoch ok: {o}", flush=True)
        del eng, st, seen
        torch.cuda.empty_cache()
    return total


def phase_ctrl_simulate(dev, card: str) -> dict:
    """[ctrl-simulate]: ``run_simulation`` with the controller armed on the
    router's cell; its ``[ctrl]`` lines parse with the port's
    ``parse_ctrl`` and replay with its ``replay_decisions``.  Returns the
    run's launches."""
    import io

    from deneva_tpu_torch.engine.driver import run_simulation
    from deneva_tpu_torch.runtime.controller import replay_decisions
    from deneva_tpu_torch.stats import parse_ctrl, parse_summary
    cfg = router_cfg(warmup_secs=0.5, done_secs=1.5)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st, counts = counted(lambda: run_simulation(cfg, device=dev))
    lines = buf.getvalue().splitlines()
    for ln in lines:
        if ln.startswith("[ctrl]"):
            print(ln, flush=True)
    rows = parse_ctrl(lines)
    fields = parse_summary(st.summary_line())
    if not rows or fields.get("ctrl_decisions", 0) <= 0 \
            or fields["ctrl_decisions"] != len(rows):
        fail(f"[ctrl-simulate] {len(rows)} [ctrl] lines, ctrl_decisions "
             f"{fields.get('ctrl_decisions')}")
    bad = replay_decisions(cfg, rows)
    if bad:
        fail(f"[ctrl-simulate] the decisions do not replay: {bad[:3]}")
    if fields["total_txn_commit_cnt"] <= 0:
        fail("[ctrl-simulate] nothing committed")
    used = {nm: c for nm, c in counts.items() if c}
    print(f"[ctrl-simulate] {fields['tput']:.1f} committed txn/s on {card}; "
          f"epochs={st.epochs_run} decisions={len(rows)} (replayed clean) "
          f"assignments={sorted({r['assign'] for r in rows})} "
          f"launches={used}", flush=True)
    print(f"[ctrl-simulate] {st.summary_line()}", flush=True)
    return {k8_row(nm, cfg.epoch_batch): c for nm, c in counts.items()}


def flat_state(state):
    """The state with each stacked table in one-device form (non-ring
    tables mapped back, ring tables' blocks concatenated in cursor
    order), for the TPC-C invariants."""
    import types

    from deneva_tpu_torch.storage.table import DeviceTable, mc_stacked_rows
    db = {}
    for name, tab in state.db.items():
        if not isinstance(tab, DeviceTable) or tab.mc_parts == 1:
            db[name] = tab
            continue
        if tab.ring:
            cols = {c: filled_rows(tab, v) for c, v in tab.columns.items()}
        else:
            at = mc_stacked_rows(tab)
            cols = {c: v[at] for c, v in tab.columns.items()}
        db[name] = DeviceTable(columns=cols,
                               row_cnt=tab.row_cnt.sum().to(torch.int32),
                               name=tab.name, capacity=tab.capacity,
                               full_row=tab.full_row, ring=tab.ring)
    return types.SimpleNamespace(db=db)


def phase_slice12(dev, card: str) -> None:
    """K14d per table on a real 64-warehouse epoch, and K17's rank at the
    OCC ``ycsb_skew`` audited epoch and the audited DGCC epoch at B =
    16,384 (``--slice12`` runs only these)."""
    from deneva_tpu_torch.cc import base
    eng = tpcc_engine(dev, tpcc_config(64))
    state, calls = capture_writes(eng, eng.run(eng.init_state(), 2))
    k14d_cases(dev, state, calls, {"K14d_append": {}}, card)
    del eng, state, calls
    torch.cuda.empty_cache()
    eng = make_engine(dev, audited(skew_config, False, "OCC"))
    st = eng.run(eng.init_state(), 10)
    calls = {}
    with grab_pieces(((base, "audit_lanes"),), calls):
        st = eng.step(st)
    torch.cuda.synchronize()
    k17_rank("OCC ycsb_skew epoch 11", *calls["audit_lanes"][0][0][1:3],
             card)
    del eng, st, calls
    torch.cuda.empty_cache()
    k15a_wide(dev, card)


SLICE13_PROFILES = (("MAAT fingerprint", "MAAT", "skew"),
                    ("MAAT ycsb_hot", "MAAT", "hot"),
                    ("TPCC TPU_BATCH 64wh", "TPCC_CHAINED", "tpcc64"),
                    ("TPCC NO_WAIT 4wh", "TPCC_SWEEP", "tpcc4"))


def slice13_profile_cfg(which: str):
    return {"skew": lambda: skew_config(False, "MAAT"),
            "hot": lambda: hot_config(False),
            "tpcc64": lambda: tpcc_config(64),
            "tpcc4": lambda: tpcc_config(4, "NO_WAIT")}[which]()


def phase_slice13(dev, card: str) -> None:
    """K11a's two calls on the ``ycsb_skew`` MAAT epoch 4 (over live0 with
    and without counts, over the survivors of the peel with counts), on
    the structured graphs and on a TPC-C 4 wh MAAT epoch, at each group
    size (with ``--k11-parent DIR``, each also beside the kernel of the
    checkout at DIR); K14c one table at
    a time and Payment's three tables in one launch at 64 and 4
    warehouses (``--slice13`` runs only these, and with ``--profile``
    the MAAT and TPC-C cells' profiles)."""
    from deneva_tpu_torch.cc import maat
    from deneva_tpu_torch.ops import conflict
    cfg, cap, p, live0 = maat_points(dev, epochs=4)
    b = SKEW_BATCH
    _, un = conflict.precedence_levels(p, live0, cfg.sweep_rounds)
    sr = k11_call(p, live0, un, b, "first call, over live0", card)[0]
    k11_call(p, live0, un, b, "first call, over live0, no counts", card,
             counts=False)
    ab = maat.peel(p, live0, sr, cap["batch"].rank, cfg.sweep_rounds,
                   cfg.maat_peel_rounds, un, bits=k11a_bits(p, live0, un))
    k11_call(p, live0 & ~ab, un, b, "second call, over live0 & ~aborted",
             card)
    inputs = {"ycsb_skew epoch 4 first call, over live0": (p, live0, un),
              "ycsb_skew epoch 4 second call, over live0 & ~aborted":
              (p, live0 & ~ab, un)}
    del cap
    k11_structured(dev, card)
    inputs.update(tpcc_maat_reach(dev, card))
    if "--k11-parent" in sys.argv:
        inputs.update({f"graph {nm}": tuple(t.to(dev) for t in v)
                       for nm, v in k11_graphs(b).items()})
        vs_parent({k: ("K11a", v) for k, v in inputs.items()},
                  sys.argv[sys.argv.index("--k11-parent") + 1], card, "K11")
    del inputs, p, live0
    torch.cuda.empty_cache()
    for wh in (64, 4):
        eng = tpcc_engine(dev, tpcc_config(wh))
        state, calls = capture_writes(eng, eng.run(eng.init_state(), 2))
        k14c_cases(dev, state, calls, {"K14c_scatter_add": {}}, card,
                   f"{wh}wh")
        del eng, state, calls
        torch.cuda.empty_cache()
    if "--profile" in sys.argv:
        for label, path, which in SLICE13_PROFILES:
            phase_profile(dev, slice13_profile_cfg(which), label, path=path)
            torch.cuda.empty_cache()


def cluster_costs(card: str) -> None:
    """``--cluster-costs``: build and run ``probes/cluster_costs.cu`` (a
    stand-alone probe, not in the kernel library): device time of a
    cluster barrier in four forms and of back-to-back launches."""
    from deneva_tpu_torch import kernels
    src = kernels.CSRC.parent / "probes" / "cluster_costs.cu"
    exe = kernels.BUILD_DIR / "cluster_costs"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([kernels._nvcc(), kernels.ARCH, "-O3", "-std=c++17",
                        str(src), "-o", str(exe)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cluster_costs.cu: {r.stdout[-1000:]}{r.stderr[-1000:]}")
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300)
    print(r.stdout.rstrip() + f" (card {card})", flush=True)
    if r.returncode != 0:
        fail(f"cluster_costs: exit {r.returncode}: {r.stderr[-1000:]}")


SLICE14_PROFILES = (("OCC fingerprint", "OCC", "occ"),
                    ("NO_WAIT fingerprint", "NO_WAIT", "nowait"),
                    ("DGCC theta 0.9", "DGCC", "dgcc"))


def slice14_profile_cfg(which: str):
    return {"occ": lambda: occ_config(False),
            "nowait": lambda: skew_config(False, "NO_WAIT"),
            "dgcc": lambda: dgcc_config(0.9)}[which]()


def phase_slice14(dev, card: str) -> None:
    """K8 on the OCC comparator's conflicts (B = 1,024) and on
    ``ycsb_skew``'s (B = 2,048), K16 on the ``dgcc_contention`` epochs at
    theta 0.6, 0.9 and 0.99 at each cluster size, each exact against its
    plain version and timed (``--slice14`` runs only these); with
    ``--k14-parent DIR`` each beside the kernels of the checkout at DIR,
    and with ``--profile`` the OCC comparator's, ``ycsb_skew`` NO_WAIT's,
    DGCC theta 0.9's and the routed cell's profiles."""
    from deneva_tpu_torch.cc import dgcc
    from deneva_tpu_torch.ops import conflict
    rounds = occ_config(False).sweep_rounds
    inputs = {}
    for b, ins in ((OCC_BATCH, sweep_conflicts(dev, occ_config(False),
                                               OCC_BATCH, 13)),
                   (SKEW_BATCH, skew_conflicts(dev))):
        uw = conflict.overlap(*ins)
        r: dict = {}
        k8_case(uw, rounds, r, card)
        print_kernel(f"K8_first_fit[B={b}]", r, card)
        inputs[f"K8 B={b}"] = ("K8", k8_inputs(uw) + (rounds,))
        del ins
    for theta in (0.6, 0.9, 0.99):
        args = relax_inputs(dev, theta)
        want = dgcc.relax_plain(*args)
        ms = {}
        n, b = args[1].numel(), args[4]
        for top in (1, 2, 4, 8):
            c = dgcc.relax_layout(n, b, top)[0]
            got = dgcc._relax(*args, top)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                fail(f"K16 theta {theta}, C = {c}: differs from plain")
            ms[c] = cuda_ms(lambda top=top: dgcc._relax(*args, top))
        its = int(want[2])
        print(f"[K16] dgcc_contention theta {theta} epoch 11: lanes={n} "
              f"live={int(args[3].sum())} txns={b} rounds run={its}: "
              + ", ".join(f"C={c} {t:.4f} ms ({t / its * 1e3:.2f} us a "
                          "round)" for c, t in ms.items())
              + f"; the library's C={dgcc.relax_layout(n, b)[0]} (card "
              f"{card})", flush=True)
        inputs[f"K16 theta {theta}"] = ("K16", args)
    if "--k14-parent" in sys.argv:
        vs_parent(inputs, sys.argv[sys.argv.index("--k14-parent") + 1], card,
                  "K14")
    del inputs
    torch.cuda.empty_cache()
    if "--profile" in sys.argv:
        for label, path, which in SLICE14_PROFILES:
            phase_profile(dev, slice14_profile_cfg(which), label, path=path)
            torch.cuda.empty_cache()
        from deneva_tpu_torch.cc.router import knobs_from_decision
        phase_profile(dev, router_cfg(), "router mixed [0,1,2,2]",
                      lambda c: knobs_from_decision(
                          c, [0, 1, 2, 2], [0, 2, 0, 0], 1, 2, dev),
                      path="ROUTED_MIXED")


def fwd_plan(dev, cfg, batch: int, seed: int) -> tuple:
    """(plan, slots) of a forwarding epoch: ``batch`` txns generated under
    ``cfg`` from ``seed`` (ranks 1..batch, as the pool stamps them), sorted
    and scanned by K1 and K2, slots from the 2^24-row index."""
    from deneva_tpu_torch.ops import forward, prng
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    wl = YCSBWorkload(cfg, device=dev)
    q = wl.generate(prng.split(prng.key_from_seed(seed, dev))[1], batch)
    r = (1 + torch.arange(batch, dtype=torch.int32, device=dev)
         ).repeat_interleave(q.keys.shape[1])
    plan = forward.plan_scans(forward.sort_lanes(
        q.keys.reshape(-1).contiguous(), r,
        q.is_write.reshape(-1).contiguous()))
    return plan, wl.index.lookup(plan.keys)


def probe_lib(name: str):
    """(loaded library, path) of ``probes/<name>.cu``, built by ``nvcc``
    into its own shared library under ``_build/`` (not the kernel
    library), with the kernels' headers on the include path."""
    import ctypes
    from deneva_tpu_torch import kernels
    src = kernels.CSRC.parent / "probes" / f"{name}.cu"
    so = kernels.BUILD_DIR / f"{name}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([kernels._nvcc(), kernels.ARCH, "-O3", "-std=c++17",
                        "-Xcompiler", "-fPIC", "-shared",
                        f"-I{kernels.CSRC}", str(src), "-o", str(so)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"{name}.cu: {r.stdout[-1000:]}{r.stderr[-1000:]}")
    return ctypes.CDLL(str(so)), so


def k3_probe(dev, plan, slots, card: str) -> None:
    """``--slice15``'s first step: the slice-1 K3 taken apart on the main
    path's plan.  ``probes/k3_costs.cu`` (not in the kernel library) is
    built into its own shared library; its copy of the slice-1 gather is
    timed with and without its per-block atomics, beside the checksum
    memset, the winners' store and the three together, in both table
    modes; then an empty launch and a cooperative launch of the occupancy
    grid with 0, 1 and 9 grid barriers."""
    import ctypes
    from deneva_tpu_torch import kernels
    from deneva_tpu_torch.workloads import ycsb
    lib, _ = probe_lib("k3_costs")
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    for nm, a in (("k3p_gather_blocks", [i_, i_]),
                  ("k3p_gather", [p_, i_, p_, p_, p_, p_, p_, i_, p_, i_,
                                  p_]),
                  ("k3p_memset", [p_, p_]),
                  ("k3p_store", [p_, i_, p_, p_, p_, p_, i_, i_, p_]),
                  ("k3p_empty", [i_, p_]), ("k3p_coop_grid", [i_]),
                  ("k3p_grid_sync", [i_, i_, i_, p_])):
        getattr(lib, nm).argtypes = a
        getattr(lib, nm).restype = i_

    def call(nm, *a):
        e = getattr(lib, nm)(*a)
        if e != 0:
            fail(f"{nm}: CUDA error {e}")
    n = plan.keys.numel()
    ptr, st = kernels.ptr, kernels.stream(plan.keys)
    pk = [ptr(t) for t in (plan.keys, plan.is_read, plan.is_write, plan.fwd,
                           slots)]
    for full in (0, 1):
        f0, cap = k3_table(full, dev, fresh=True)
        tup = f0.shape[1] if full else 0
        blocks = lib.k3p_gather_blocks(n, tup)
        acc = torch.zeros(2 + 2 * blocks, dtype=torch.int32, device=dev)

        def gather(atomics, f0=f0, tup=tup, acc=acc):
            call("k3p_gather", ptr(f0), tup, *pk, n, ptr(acc), atomics, st)

        def store(f0=f0, tup=tup):
            call("k3p_store", ptr(f0), tup, ptr(plan.keys), ptr(plan.rank),
                 ptr(plan.win), ptr(slots), n, cap, st)

        def memset(acc=acc):
            call("k3p_memset", ptr(acc), st)
        # the probe's copy computes the plain version's totals, with its
        # atomics and from its partials
        gather(1)
        gather(0)
        torch.cuda.synchronize()
        tot = acc.to(torch.int64) & MASK32
        parts = tot[2:].reshape(-1, 2).sum(0) & MASK32
        _, cks, wcnt = ycsb._forward_execute_f0_plain(
            f0.clone(), plan, slots, cap, mono=True)
        if [int(tot[0]), int(tot[1])] != [int(cks), int(wcnt)] or \
                [int(parts[0]), int(parts[1])] != [int(cks), int(wcnt)]:
            fail(f"k3_costs gather ({'full row' if full else 'fingerprint'})"
                 " differs from the plain version's totals")
        t = {"gather": cuda_ms(lambda: gather(1)),
             "gather, no atomics": cuda_ms(lambda: gather(0)),
             "memset": cuda_ms(memset), "store": cuda_ms(store),
             "memset + gather + store": cuda_ms(
                 lambda: (memset(), gather(1), store()))}
        print(f"[K3-probe] main path, {'full row' if full else 'fingerprint'}"
              f": {n} lanes, gather grid {blocks} x 256 ({2 * blocks} "
              f"same-address atomics a call); " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in t.items())
              + f"; the atomics {t['gather'] - t['gather, no atomics']:.4f} "
              f"ms (card {card})", flush=True)
        del f0, acc
        torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for threads, blocks in ((256, 0), (512, 0), (1024, 0), (1024, sms)):
        grid = blocks or lib.k3p_coop_grid(threads)
        t = {} if threads != 256 else {
            "empty launch": cuda_ms(lambda: call("k3p_empty", grid, st))}
        for k in (0, 1, 9):
            t[f"cooperative, {k} grid barriers"] = cuda_ms(
                lambda k=k: call("k3p_grid_sync", grid, threads, k, st))
        per = (t["cooperative, 9 grid barriers"]
               - t["cooperative, 1 grid barriers"]) / 8
        print(f"[K3-probe] launches of {grid} x {threads} threads"
              f"{'' if blocks else ' (the occupancy grid)'}: " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in t.items())
              + f"; {per * 1e3:.2f} us a grid barrier (card {card})",
              flush=True)


K3_SHAPES = (("main path", lambda: config(False), BATCH, 11),
             ("ycsb_skew", lambda: skew_config(False, "CALVIN"), SKEW_BATCH,
              17),
             ("ycsb_hot", lambda: hot_config(False, "CALVIN"), SKEW_BATCH,
              19))


def k3_cases(dev, card: str) -> dict:
    """K3 in both table modes on the main path's plan (655,360 lanes, zipf
    0.9), a ``ycsb_skew`` plan (20,480 lanes) and a ``ycsb_hot`` plan
    (20,480 lanes, 90% of them on 100 keys), each exact against its plain
    version (table bytes, checksum, write count) from a fresh table, then
    timed; the probe first, on the main path's plan.  Returns the inputs
    by label for ``vs_parent``."""
    inputs = {}
    for label, cfg_fn, batch, seed in K3_SHAPES:
        plan, slots = fwd_plan(dev, cfg_fn(), batch, seed)
        if label == "main path":
            k3_probe(dev, plan, slots, card)
        n = plan.keys.numel()
        hottest = int(torch.unique_consecutive(
            plan.keys, return_counts=True)[1].max())
        for full in (0, 1):
            mode = "full row" if full else "fingerprint"
            args = (full, plan.keys, plan.rank, plan.is_read, plan.is_write,
                    plan.fwd, plan.win, slots)
            f0k, ck, wk = k3_run(*args, fresh=True)
            f0p, cp, wp = k3_run(*args, plain=True, fresh=True)
            if not (torch.equal(f0k, f0p) and int(ck) == int(cp)
                    and int(wk) == int(wp)):
                fail(f"K3 ({label}, {mode}) differs from plain")
            del f0k, f0p
            r = {"ms": cuda_ms(lambda: k3_run(*args))}
            bound(r, *k3_work(plan, slots, k3_table(full, dev)[0].shape[1]
                              if full else 0))
            print(f"[K3] {label}, {mode}: lanes={n} "
                  f"reads={int(plan.is_read.sum())} forwarded="
                  f"{int((plan.is_read & (plan.fwd >= 0)).sum())} "
                  f"winners={int(plan.win.sum())} hottest key {hottest} "
                  f"lanes; {r['ms']:.4f} ms, bound {r['bound_ms']:.6f} "
                  f"({r['bound_by']}) (card {card})", flush=True)
            inputs[f"K3 {label} {mode}"] = ("K3", args)
            if label == "main path":
                k3_phases(args, r["ms"], card)
        torch.cuda.empty_cache()
    return inputs


def k3_phases(args: tuple, ms: float, card: str) -> None:
    """K3's phases by its inputs: the same plan with no winner (no
    stores), with no read (no gathers) and with neither (the launch, the
    plan's loads and the grid barrier), each timed."""
    full, keys, rank, rd, wr, fwd, win, slots = args
    none_r, none_w = torch.zeros_like(rd), torch.zeros_like(win)
    t = {nm: cuda_ms(lambda a=a: k3_run(full, keys, rank, a[0], wr, fwd,
                                        a[1], slots))
         for nm, a in (("no stores", (rd, none_w)),
                       ("no gathers", (none_r, win)),
                       ("neither", (none_r, none_w)))}
    print(f"[K3-phases] main path, {'full row' if full else 'fingerprint'}: "
          f"all {ms:.4f} ms, " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in t.items())
          + f"; gathers ~{t['no stores'] - t['neither']:.4f}, stores "
          f"~{t['no gathers'] - t['neither']:.4f} (card {card})", flush=True)


def k10_tpcc_stock(dev) -> tuple:
    """K10's inputs on a TPC-C stock batch: epoch 3's call of a
    4-warehouse NO_WAIT run (2,048 txns x 15 items = 30,720 lanes)."""
    from deneva_tpu_torch.ops import scatter
    eng = tpcc_engine(dev, tpcc_config(4, "NO_WAIT"))
    st = eng.run(eng.init_state(), 2)
    calls: list = []
    with grab_calls(scatter, "last_writer", calls):
        eng.step(st)
    torch.cuda.synchronize()
    return max(calls, key=lambda a: a[0].numel())


def k10_cases(dev, card: str) -> dict:
    """K10 at the OCC comparator's 10,240 lanes, ``ycsb_skew``'s 20,480 (an
    epoch's committed writes), TPC-C's stock batch of 30,720 and the
    arena's 131,072 (and 65,536), each exact against its plain version
    and the sort yardstick, timed as the library lays it out, at each
    CTA count and in the global-table regime.  Returns the inputs by
    label for ``vs_parent``."""
    from deneva_tpu_torch.ops import scatter
    cases = {"OCC comparator epoch": k10_epoch(dev, occ_config(False),
                                               OCC_BATCH, 13),
             "ycsb_skew epoch": k10_epoch(dev, skew_config(False, "OCC"),
                                          SKEW_BATCH, 17),
             "TPC-C stock batch": k10_tpcc_stock(dev),
             "arena, 65,536 lanes": k10_arena(dev, 1 << 16),
             "arena": k10_arena(dev)}
    inputs = {}
    for label, (sl, od, mk, cp) in cases.items():
        k10_check(label, sl, od, mk, cp)
        n = sl.numel()
        r = {"ms": cuda_ms(lambda: scatter.last_writer(sl, od, mk, cp)),
             "library_ms": cuda_ms(lambda: lw_library(sl, od, mk, cp))}
        bound(r, 10 * n, 4 * n)
        forms = ""
        if hasattr(scatter, "last_writer_layout"):
            want = scatter.last_writer_plain(sl, od, mk, cp)
            ms = []
            for ctas in (1, 2, 4, 8, 16, 32, 64, 128, -1):
                if not torch.equal(scatter._last_writer(sl, od, mk, ctas),
                                   want):
                    fail(f"K10 ({label}) at {ctas} CTAs differs from plain")
                ms.append(f"{f'C={ctas}' if ctas > 0 else 'global table'} "
                          + f"{cuda_ms(lambda c=ctas: scatter._last_writer(sl, od, mk, c)):.4f}")
            c, t, g = scatter.last_writer_layout(n, sl.device)
            forms = (f"; the library's layout: " + (
                f"global table of {g} entries" if g else
                f"{c} CTAs of {t} entries") + "; by layout: " + ", ".join(ms))
        if label == "ycsb_skew epoch":
            none = torch.zeros_like(mk)
            one = [t[:1] for t in (sl, od, mk)]
            print(f"[K10-phases] {label}: all {r['ms']:.4f} ms, no masked "
                  f"lane {cuda_ms(lambda: scatter.last_writer(sl, od, none, cp)):.4f}"
                  f", one lane {cuda_ms(lambda: scatter.last_writer(*one, cp)):.4f}"
                  f" (card {card})", flush=True)
        masked = mk.nonzero().squeeze(1)
        print(f"[K10] {label}: N={n} masked={masked.numel()} distinct slots="
              f"{int(torch.unique(sl[masked]).numel())} "
              f"winners={int(scatter.last_writer_plain(sl, od, mk, cp).sum())};"
              f" {r['ms']:.4f} ms (sort yardstick {r['library_ms']:.4f}; "
              f"bound {r['bound_ms']:.6f}, {r['bound_by']}){forms} "
              f"(card {card})", flush=True)
        inputs[f"K10 {label} N={n}"] = ("K10", (sl, od, mk, cp))
    return inputs


SLICE15_PROFILES = (("fingerprint", "TPU_BATCH", lambda: config(False)),
                    ("full_row", "TPU_BATCH", lambda: config(True)),
                    ("NO_WAIT fingerprint", "NO_WAIT",
                     lambda: skew_config(False, "NO_WAIT")),
                    ("DGCC theta 0.9", "DGCC", lambda: dgcc_config(0.9)))


def phase_slice15(dev, card: str) -> None:
    """K3's probe, then K3 and K10 at their shapes (``k3_cases``,
    ``k10_cases``), each exact against its plain version and timed
    (``--slice15`` runs only these); with ``--k15-parent DIR`` each
    beside the kernels of the checkout at DIR on the same inputs, and
    with ``--profile`` the forwarding cells' (both modes), ``ycsb_skew``
    NO_WAIT's and DGCC theta 0.9's profiles."""
    inputs = k3_cases(dev, card)
    inputs.update(k10_cases(dev, card))
    if "--k15-parent" in sys.argv:
        vs_parent(inputs, sys.argv[sys.argv.index("--k15-parent") + 1], card,
                  "K15")
    del inputs
    _K3_TABLES.clear()
    torch.cuda.empty_cache()
    if "--profile" in sys.argv:
        for label, path, cfg_fn in SLICE15_PROFILES:
            phase_profile(dev, cfg_fn(), label, path=path)
            torch.cuda.empty_cache()


def peel_trace(p, live0, on_cycle0, rank, rounds: int, peel_rounds: int,
               gate) -> list[dict]:
    """What K11b's rounds do on one input, from boolean matrices on the
    input's device: per peel round, the level-sweep rounds each direction
    runs before its fixpoint or empty-set exit (bits.cuh `level_sweep`,
    the one-block kernel: the P sweep, then the P^T sweep unless the first
    leaves no candidate), |F| at each exit, the candidates and the
    victims; and the exchanges of the cluster kernel, whose two sweeps
    advance together and stop at their fixpoints or when no candidate is
    left (``x``).  The aborted set it ends with is checked against
    ``peel_plain``.  Empty when the gate is off."""
    from deneva_tpu_torch.cc import maat
    if not bool(gate.any()):
        return []
    sub = p & live0[:, None] & live0[None, :]
    preds = (sub.T.contiguous(), sub)    # rows: predecessors under P, P^T
    sym, gt = sub | sub.T, maat.younger(rank)
    aborted = torch.zeros_like(live0)

    def step(d, f):
        return f & (preds[d] & f[None, :]).any(dim=1)

    def sweep(d, f):
        """level_sweep from F: (F at exit, rounds run)."""
        prev, ran = -1, 0
        for _ in range(rounds):
            n = int(f.sum())
            if n == 0 or n == prev:
                break
            prev, ran, f = n, ran + 1, step(d, f)
        return f, ran

    out = []
    for _ in range(peel_rounds):
        f0 = live0 & ~aborted
        ff, rf = sweep(0, f0)
        uf = ff & on_cycle0
        fr, rr = sweep(1, f0) if bool(uf.any()) else (None, 0)
        cand = uf & fr if fr is not None else uf
        # the cluster kernel: both sweeps in the same exchanges
        x, fc, act = 0, [f0, f0], [rounds > 0, rounds > 0]
        if bool((f0 & on_cycle0).any()):
            for r in range(rounds):
                fn = [step(d, fc[d]) if act[d] else fc[d] for d in (0, 1)]
                x += 1
                for d in (0, 1):
                    if act[d] and (torch.equal(fn[d], fc[d])
                                   or not bool(fn[d].any())
                                   or r == rounds - 1):
                        act[d] = False
                fc = fn
                if not bool((fn[0] & fn[1] & on_cycle0).any()) or not any(act):
                    break
        row = {"sweep_f": rf, "F_f": int(ff.sum()), "sweep_r": rr,
               "F_r": -1 if fr is None else int(fr.sum()),
               "candidates": int(cand.sum()), "x": x}
        if not bool(cand.any()):
            row["victims"] = 0
            out.append(row)
            break
        nb = sym & cand[:, None] & cand[None, :]
        victims = cand & ~(nb & gt).any(dim=1)
        row["victims"] = int(victims.sum())
        out.append(row)
        aborted = aborted | victims
    want = maat.peel_plain(p, live0, on_cycle0, rank, rounds, peel_rounds,
                           gate)
    if not torch.equal(aborted, want):
        fail("peel_trace's aborted set differs from peel_plain")
    return out


# K11b's inputs for --slice16: (label, config, first epoch to take)
K11B_SHAPES = (("ycsb_skew epoch 4", lambda: skew_config(False, "MAAT"), 4),
               ("ycsb_hot", lambda: hot_config(False), 4),
               ("B=8192", lambda: operating_config("MAAT", 8192), 1))


def operating_config(alg: str, batch: int, **kw):
    """An ``operating_points`` cell (``experiments.py:151-162``): the
    ``ycsb_skew`` settings at theta 0.9 with ``epoch_batch`` = ``batch``
    over the same pool of 10,000."""
    return config(False, cc_alg=alg, epoch_batch=batch,
                  max_txn_in_flight=SKEW_POOL, conflict_buckets=BUCKETS,
                  conflict_exact=True, watermark_buckets=1 << 20,
                  mvcc_his_len=4, **kw)


def k11b_inputs(dev) -> dict:
    """K11b's arguments as ``validate_maat`` hands them over: (P, live0,
    on_cycle0, rank, rounds, peel_rounds, gate) of ``ycsb_skew``'s epoch 4
    (`maat_points`' epoch, the kernel table's input), of the first
    ``ycsb_hot`` epoch from epoch 4 on whose level gate is set, and of the
    first such MAAT epoch at ``operating_points``' B = 8,192 (``paper_base``
    at theta 0.9), each engine from a fresh state."""
    from deneva_tpu_torch.cc import maat
    out = {}
    for label, cfg_fn, first in K11B_SHAPES:
        eng = make_engine(dev, cfg_fn())
        st, calls = eng.init_state(), []
        with grab_calls(maat, "peel", calls):
            for e in range(1, 16):
                st = eng.step(st)
                if e >= first and bool(calls[-1][6].any()):
                    break
            else:
                fail(f"K11b {label}: no epoch up to 15 set the level gate")
        torch.cuda.synchronize()
        out[f"{label}" + ("" if e == first else f" (epoch {e})")] = \
            tuple(calls[-1][:7])
        del eng, st, calls
        torch.cuda.empty_cache()
    return out


def k11b_bytes(b: int) -> int:
    """The bytes K11b must move at B = ``b``: K11a's bits of P's rows and
    columns (2 b ceil(b / 32) int32 words), live0, on_cycle0 and the gate
    (1 B a txn each) and the ranks (4 B) in, the aborts (1 B) out."""
    return 2 * b * -(-b // 32) * 4 + 3 * b + 4 * b + b


def k11a_bits(p, live0, gate):
    """K11a's scratch after its call over ``(p, live0, gate)``: P's rows
    and columns packed over live0, which `maat.peel` reads."""
    from deneva_tpu_torch.cc import maat
    bits = maat.reach_scratch(p.shape[0], p.device)
    maat.reach_stats(p, live0, gate, False, bits=bits)
    return bits


def k11b_case(label: str, args: tuple, card: str,
              sizes: bool = False) -> tuple:
    """K11b on one input exactly against ``peel_plain``, as
    ``validate_maat`` runs it (on the bits of K11a's call over live0), its
    counts against `peel_trace`'s, timed; with ``sizes`` also at each
    cluster size.  Returns (aborted, ms)."""
    from deneva_tpu_torch.cc import maat
    p, live0, oc, rank, rounds, peel_rounds, gate = args
    b = p.shape[0]
    want = maat.peel_plain(*args)
    bits = k11a_bits(p, live0, gate)
    stats = torch.zeros(4, dtype=torch.int32, device=p.device)
    for got in (maat.peel(*args, bits=bits),
                maat._peel(*args, bits=bits, stats=stats)):
        if not torch.equal(got, want):
            fail(f"K11b ({label}) differs from plain")
    tr = peel_trace(*args)
    counts = [sum(1 for r in tr if r["candidates"]),
              sum(r["x"] for r in tr), sum(r["victims"] for r in tr)]
    if bool(gate.any()) and stats[:3].tolist() != counts:
        fail(f"K11b ({label}) counts {stats.tolist()} differ from "
             f"peel_trace's {counts}")
    ms = cuda_ms(lambda: maat.peel(*args, bits=bits))
    lim = {}
    bound(lim, k11b_bytes(b),
          2 * int((p & live0[:, None] & live0[None, :]).sum()))
    c, shared, _ = maat.peel_layout(b)
    by = ""
    if sizes:
        t = {}
        for top in (1, 2, 4, 8, 16):
            ct = maat.peel_layout(b, top)[0]
            if ct in t:
                continue
            if not torch.equal(maat._peel(*args, bits=bits, max_ctas=top),
                               want):
                fail(f"K11b ({label}) at {ct} CTAs differs from plain")
            t[ct] = cuda_ms(lambda top=top: maat._peel(*args, bits=bits,
                                                       max_ctas=top))
        by = "; by cluster: " + ", ".join(f"C={k} {v:.4f}"
                                          for k, v in t.items())
    print(f"[K11b] {label}: B={b} peel rounds with candidates {counts[0]}, "
          f"sweep exchanges {counts[1]}, victims {counts[2]}; cluster of "
          f"{c} CTAs, rows in {'shared memory' if shared else 'L2'}; "
          f"{ms:.4f} ms on K11a's bits ({ms / max(1, counts[0] + counts[1]) * 1e3:.2f}"
          f" us an exchange), bound {lim['bound_ms']:.6f} ms "
          f"({lim['bound_by']}, {lim['bytes']} bytes){by} (card {card})",
          flush=True)
    return want, ms


def k11b_one_block_top() -> int:
    """The largest B the one-block K11b (PR 4-15) took: its sets, (6
    ceil(B / 32) + B) int32 words, within 200 KiB of shared memory."""
    b = 200 * 1024 // 4
    while 6 * -(-b // 32) + b > 200 * 1024 // 4:
        b -= 1
    return b


def k11b_layout_top(max_ctas: int = 0) -> int:
    """The largest B K11b's layout takes (`maat.peel_layout`, by
    bisection; a larger B raises)."""
    from deneva_tpu_torch.cc import maat

    def takes(b):
        try:
            maat.peel_layout(b, max_ctas)
        except ValueError:
            return False
        return True
    lo, hi = 1, 1 << 22
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if takes(mid) else (lo, mid)
    return lo


def k11b_layout_edges(card: str) -> None:
    """``[K11b-layout]``: the largest B K11b's layout takes on this card,
    with its cluster there, beside the one-block kernel's largest B and
    K11a's (`maat.reach_group`, which raises past it); and the layout at
    the path's shapes."""
    from deneva_tpu_torch.cc import maat
    top = k11b_layout_top()
    k11a = 1
    while True:
        try:
            maat.reach_group(k11a + 1)
        except ValueError:
            break
        k11a += 1
    shapes = ", ".join(f"B={b}: {maat.peel_layout(b)[0]} CTAs, rows in "
                       f"{'shared memory' if maat.peel_layout(b)[1] else 'L2'}"
                       for b in (16, 2048, 8192, k11b_one_block_top(), top))
    print(f"[K11b-layout] largest B {top} (the one-block kernel's "
          f"{k11b_one_block_top()}, K11a's {k11a}); {shapes} (card {card})",
          flush=True)


def k11b_rounds(inputs: dict, card: str) -> None:
    """``[K11b-rounds]``: `peel_trace` on each input, and the kernel of this
    tree at the path's settings, at one peel round and at one peel round
    without sweeps (``rounds`` 0: the launch, staging and one victim
    pass), by CUDA events: what a peel round and a sweep round
    cost."""
    from deneva_tpu_torch.cc import maat
    for label, args in inputs.items():
        p, live0, oc, rank, rounds, peel_rounds, gate = args
        tr = peel_trace(*args)
        bits = k11a_bits(p, live0, gate)
        sweeps = sum(r["sweep_f"] + r["sweep_r"] for r in tr)
        x = sum(r["x"] for r in tr)
        victims = sum(r["victims"] for r in tr)
        t = {(r, q): cuda_ms(lambda r=r, q=q: maat.peel(
                 p, live0, oc, rank, r, q, gate, bits=bits), iters=5)
             for r, q in ((rounds, peel_rounds), (rounds, 1), (0, 1))}
        one = tr[0]["sweep_f"] + tr[0]["sweep_r"] if tr else 0
        per = (t[(rounds, 1)] - t[(0, 1)]) / one * 1e3 if one else 0.0
        print(f"[K11b-rounds] {label}: B={p.shape[0]} "
              f"live0={int(live0.sum())} on_cycle0={int(oc.sum())} "
              f"edges={int((p & live0[:, None] & live0[None, :]).sum())}; "
              f"{len(tr)} peel rounds ran of {peel_rounds}, one-block "
              f"sweep rounds {sweeps} in all, cluster exchanges {x} sweep + "
              f"{sum(1 for r in tr if r['candidates'])} victim, victims "
              f"{victims}; ms at ({rounds}, {peel_rounds}) "
              f"{t[(rounds, peel_rounds)]:.4f}, at ({rounds}, 1) "
              f"{t[(rounds, 1)]:.4f}, at (0, 1) {t[(0, 1)]:.4f}: a sweep "
              f"round of peel round 1 ~{per:.2f} us (card {card})",
              flush=True)
        for i, r in enumerate(tr):
            print(f"[K11b-rounds]   {label} peel round {i + 1}: P sweep "
                  f"{r['sweep_f']} rounds, |F| {r['F_f']}; P^T sweep "
                  f"{r['sweep_r']} rounds, |F| {r['F_r']}; candidates "
                  f"{r['candidates']}, victims {r['victims']}; cluster "
                  f"exchanges {r['x']}", flush=True)


def k2_inputs(dev) -> dict:
    """K2's sorted words at its path shapes: the main path's 655,360 lanes,
    a ``ycsb_skew`` batch's 20,480 and IDX_BTREE's 655,360 (K1's output
    on a generated batch, ranks 1..B as the pool stamps them)."""
    from deneva_tpu_torch.ops import forward, prng
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    out = {}
    for label, cfg_fn, batch, seed in (
            ("main path", lambda: config(False), BATCH, 11),
            ("ycsb_skew", lambda: skew_config(False, "CALVIN"), SKEW_BATCH,
             17),
            ("IDX_BTREE", btree_config, BATCH, 23)):
        wl = YCSBWorkload(cfg_fn(), device=dev)
        q = wl.generate(prng.split(prng.key_from_seed(seed, dev))[1], batch)
        r = (1 + torch.arange(batch, dtype=torch.int32, device=dev)
             ).repeat_interleave(q.keys.shape[1])
        words = forward.sort_lanes(q.keys.reshape(-1).contiguous(), r,
                                   q.is_write.reshape(-1).contiguous())
        out[f"{label} N={words.numel()}"] = (words,)
        del wl
    return out


def k2_case(words, r: dict, label: str, card: str) -> None:
    """K2 on ``words`` exactly against ``plan_scans_plain``, timed beside
    it; the bound counts the words read once and the six fields written
    once (23 bytes a lane)."""
    from deneva_tpu_torch.ops import forward
    got, want = forward.plan_scans(words), forward.plan_scans_plain(words)
    err = 0
    for f in ("keys", "rank", "is_read", "is_write", "fwd", "win"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            fail(f"K2 ({label}) {f} differs from plain")
        err = max(err, max_abs(getattr(got, f), getattr(want, f)))
    n = words.numel()
    r.update(max_abs_err=err, ms=cuda_ms(lambda: forward.plan_scans(words)),
             plain_ms=cuda_ms(lambda: forward.plan_scans_plain(words),
                              iters=5), library_ms=None)
    bound(r, 23 * n, 8 * n)
    keys = want.keys
    hot = int(torch.unique_consecutive(keys, return_counts=True)[1].max())
    print(f"[K2] {label}: lanes={n} writes={int(want.is_write.sum())} "
          f"forwarded={int((want.fwd >= 0).sum())} "
          f"winners={int(want.win.sum())} hottest key {hot} lanes; "
          f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}; bound "
          f"{r['bound_ms']:.6f}, {r['bound_by']}) (card {card})", flush=True)


SLICE16_PROFILES = (("MAAT fingerprint", "MAAT", lambda: skew_config(
                        False, "MAAT")),
                    ("MAAT ycsb_hot", "MAAT", lambda: hot_config(False)),
                    ("fingerprint", "TPU_BATCH", lambda: config(False)))


def phase_slice16(dev, card: str) -> None:
    """``[K11b-rounds]`` and K11b on its three inputs (`k11b_inputs`), K2
    at its three shapes (`k2_inputs`), each exact against its plain
    version and timed (``--slice16`` runs only these); with
    ``--slice16-parent DIR`` each, and K11a over the same epochs' live0,
    beside the kernels of the checkout at DIR on the same inputs, and
    with ``--profile`` the MAAT ``ycsb_skew``, MAAT ``ycsb_hot`` and
    forwarding fingerprint profiles."""
    k11b_layout_edges(card)
    peel_in = k11b_inputs(dev)
    k11b_rounds(peel_in, card)
    inputs = {}
    for label, args in peel_in.items():
        k11b_case(label, args, card, sizes=True)
        inputs[f"K11b {label}"] = ("K11b", args)
        # K11a, whose packed bits K11b now reads, is timed beside its parent
        inputs[f"K11a {label}, over live0"] = ("K11a", (args[0], args[1],
                                                        args[6]))
    for label, args in k2_inputs(dev).items():
        k2_case(args[0], {}, label, card)
        inputs[f"K2 {label}"] = ("K2", args)
    if "--slice16-parent" in sys.argv:
        vs_parent(inputs, sys.argv[sys.argv.index("--slice16-parent") + 1],
                  card, "slice16")
    del inputs, peel_in
    torch.cuda.empty_cache()
    if "--profile" in sys.argv:
        for label, path, cfg_fn in SLICE16_PROFILES:
            phase_profile(dev, cfg_fn(), label, path=path)
            torch.cuda.empty_cache()


# K13b's inputs for --slice17 (label -> (config, mixed router knobs)):
# the forwarding main path's metered batch, the metered OCC ycsb_skew
# epoch and the router's mixed epoch over 2^18 buckets
K13B_CELLS = (("forwarding 65,536 x 10", lambda: config(False, metrics=True),
               False),
              ("OCC ycsb_skew 2,048 x 10",
               lambda: skew_config(False, "OCC", metrics=True), False),
              ("router mixed 2,048 x 10, 2^18 buckets", router_cfg, True))


def k13b_inputs(dev, cells=K13B_CELLS) -> dict:
    """label -> K13b's arguments (`k13b_run`'s) as the sixth epoch of each
    cell hands them to ``conflict_density``."""
    from deneva_tpu_torch.cc import base
    from deneva_tpu_torch.cc.router import knobs_from_decision
    out = {}
    for label, cfg_fn, mixed in cells:
        cfg = cfg_fn()
        eng, run, st = mesh_engine(dev, cfg)
        if mixed:
            knobs = knobs_from_decision(cfg, [0, 1, 2, 2], [0, 2, 0, 0], 1,
                                        2, dev)

            def run(s, n, eng=eng, knobs=knobs):
                return eng.run_ctrl(s, knobs, n)
        st = run(st, 5)
        calls: dict = {}
        with grab_pieces(((base, "conflict_density"),), calls):
            st = run(st, 1)
        torch.cuda.synchronize()
        (c, bt, owner, arm), _ = calls["conflict_density"][0]
        out[label] = (bt.table_ids, bt.keys, bt.valid, bt.is_read,
                      bt.is_write, bt.active, owner, c.conflict_buckets,
                      max(c.part_cnt, 1), int(arm))
        del eng, st, calls
        torch.cuda.empty_cache()
    return out


def k13b_run(table_ids, keys, valid, is_read, is_write, active, owner,
             k: int, p: int, arm: int, plain: bool = False):
    """K13b (or its plain version) on one batch's lanes, as
    ``conflict_density`` takes them from the engine."""
    from types import SimpleNamespace
    from deneva_tpu_torch.cc import base
    bt = base.AccessBatch(table_ids=table_ids, keys=keys, is_read=is_read,
                          is_write=is_write, valid=valid, ts=None, rank=None,
                          active=active)
    cfg = SimpleNamespace(conflict_buckets=k, part_cnt=p)
    if plain:
        return base.conflict_density_plain(cfg, bt, owner, bool(arm))
    return base.conflict_density(cfg, bt, owner, bool(arm))


def k13b_phases(inputs: dict, card: str) -> None:
    """``[K13b-phases]``: this tree's K13b on variants of its inputs — as
    run, with no valid lane (the launch, its two barriers, the flags'
    loads and the block tables) and with every lane on a key of its own
    (no hot bucket) — each exact against the plain version, with the
    regime the library picks; then cooperative launches of 512-thread
    blocks with 0, 1 and 2 grid barriers and a plain empty launch
    (``probes/k3_costs.cu``)."""
    import ctypes
    from deneva_tpu_torch.cc import base
    for label, args in inputs.items():
        tid, keys, valid, isr, isw, active, owner, k, p, arm = args
        distinct = torch.arange(keys.numel(), dtype=torch.int32,
                                device=keys.device).reshape(keys.shape)
        variants = {"as run": args,
                    "no valid lane": (tid, keys, torch.zeros_like(valid),
                                      *args[3:]),
                    "distinct keys": (tid, distinct, *args[2:])}
        t = {}
        for nm, a in variants.items():
            if not torch.equal(k13b_run(*a), k13b_run(*a, plain=True)):
                fail(f"[K13b-phases] {label} {nm}: differs from plain")
            t[nm] = cuda_ms(lambda a=a: k13b_run(*a))
        words, dense, grid = base.conflict_density_layout(*keys.shape, k)
        print(f"[K13b-phases] {label}: "
              f"{'dense' if dense else 'direct'} regime, {grid} x 512, "
              f"{words} histogram words; " + ", ".join(
                  f"{nm} {v:.4f} ms" for nm, v in t.items())
              + f" (card {card})", flush=True)
    lib, _ = probe_lib("k3_costs")
    lib.k3p_grid_sync.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.k3p_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for blocks in (43, 132, 528):
        t = {f"{n} barriers": cuda_ms(lambda n=n: lib.k3p_grid_sync(
            blocks, 512, n, st)) for n in (0, 1, 2)}
        t["plain empty launch"] = cuda_ms(lambda: lib.k3p_empty(blocks, st))
        print(f"[K13b-phases] cooperative launch of {blocks} x 512: "
              + ", ".join(f"{nm} {v:.4f} ms" for nm, v in t.items())
              + f" (card {card})", flush=True)


def k13b_case(label: str, args: tuple, card: str) -> dict:
    """K13b on ``args`` exactly against its plain version on both arms,
    timed beside it and beside two ``bincount`` + gathers; the record of
    a kernels-line row."""
    from deneva_tpu_torch.ops.hashing import bucket_hash, combine_key
    tid, keys, valid, _, isw, active, owner, k, p, arm = args
    for a in (arm, 1 - arm):
        other = args[:-1] + (a,)
        got, want = k13b_run(*other), k13b_run(*other, plain=True)
        if not torch.equal(got, want):
            fail(f"K13b {label} (arm {a}): differs from the plain version")
        if a == arm:
            err, dens = max_abs(got, want), int(got.sum())
    b, na = keys.shape
    bk = bucket_hash(combine_key(tid, keys), k).reshape(-1).long()
    v = (valid & active[:, None]).reshape(-1)
    w = v & isw.reshape(-1)

    def lib():
        wc = torch.bincount(bk, weights=w.float(), minlength=k)
        uc = torch.bincount(bk, weights=v.float(), minlength=k)
        return wc[bk], uc[bk]
    r = {"max_abs_err": err, "ms": cuda_ms(lambda: k13b_run(*args)),
         "plain_ms": cuda_ms(lambda: k13b_run(*args, plain=True), iters=3,
                             warmup=1),
         "library_ms": cuda_ms(lib)}
    # lanes: table id, key and owner (4 B), valid, read and write flags
    # (1 B); the txn flags; P counts out; a hash and a few compares a lane
    bound(r, b * na * 15 + b + 4 * p, 16 * b * na)
    print(f"[K13b] {label}: B={b} A={na} K={k} P={p} arm={arm} contending "
          f"lanes {dens} of {int(v.sum())}; {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f}, bincount + gathers {r['library_ms']:.4f}, "
          f"bound {r['bound_ms']:.6f}) (card {card})", flush=True)
    return r


def k13b_split(lib, inputs: dict, card: str) -> None:
    """``[K13b-split]``: the slice-8 K13b's four stream operations (its
    copy in the probe), each alone and all four, on each input; all four
    are first held to the plain version."""
    import ctypes
    from deneva_tpu_torch import kernels
    fn = lib.k17p_density
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    for label, args in inputs.items():
        tid, keys, valid, isr, isw, active, owner, k, p, arm = args
        b, a = keys.shape
        scratch = torch.empty(2 * k + b * a, dtype=torch.int32,
                              device=keys.device)
        out = torch.empty(p, dtype=torch.int32, device=keys.device)
        ptrs = [kernels.ptr(t) for t in (tid, keys, valid, isr, isw, active,
                                         owner)]

        def call(ops):
            e = fn(ops, *ptrs, b, a, k, p, arm, kernels.ptr(scratch),
                   kernels.ptr(out), kernels.stream(keys))
            if e != 0:
                fail(f"k17p_density: CUDA error {e}")
        call(15)
        torch.cuda.synchronize()
        if not torch.equal(out, k13b_run(*args, plain=True)):
            fail(f"[K13b-split] the probe's copy differs from plain on "
                 f"{label}")
        t = {nm: cuda_ms(lambda ops=ops: call(ops))
             for nm, ops in (("histograms' memset", 1), ("counts' memset", 2),
                             ("histogram pass", 4), ("verdict pass", 8),
                             ("all four", 15))}
        print(f"[K13b-split] {label}: B={b} A={a} K={k} P={p}; " + ", ".join(
            f"{nm} {v:.4f} ms" for nm, v in t.items())
            + f"; the four alone sum to {sum(t.values()) - t['all four']:.4f}"
            f" (card {card})", flush=True)
        del scratch, out


# K4b's inputs for --slice17: label -> (configuration, txns).  The HOT
# row is the kernels line's K4b[hot] input.
K4B_CASES = {
    "zipf 0.9, 65,536 x 10": (lambda: config(False), BATCH),
    "theta 0, 65,536 x 10": (lambda: config(False, zipf_theta=0.0), BATCH),
    "ycsb_hot, 2,048 x 10": (lambda: hot_config(False), SKEW_BATCH),
    "HOT, key_order, txn_write_perc 0.25, 65,536 x 10": (
        lambda: config(False, skew_method="HOT", data_perc=100,
                       access_perc=0.9, key_order=True,
                       txn_write_perc=0.25), BATCH),
    "zipf 0.9, key_order, txn_write_perc 0.25, 65,536 x 10": (
        lambda: config(False, key_order=True, txn_write_perc=0.25), BATCH),
    # the sweep backends' zipf epoch (1 draw a thread), then sizes on
    # either side of the 4-draws-a-thread switch (~33,800 txns of 10 at
    # 660 blocks)
    "ycsb_skew zipf 0.9, 2,048 x 10": (
        lambda: skew_config(False, "OCC"), SKEW_BATCH),
    "zipf 0.9, 16,384 x 10": (lambda: config(False), 16384),
    "zipf 0.9, 32,768 x 10": (lambda: config(False), 32768),
    "zipf 0.9, 49,152 x 10": (lambda: config(False), 49152),
}
_K4B_WL: dict = {}


def k4b_run(rng, n: int, label: str, plain: bool = False):
    """K4b (or its plain version) under ``K4B_CASES[label]``'s
    configuration: (keys, write flags) of ``n`` txns."""
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    if label not in _K4B_WL:
        _K4B_WL[label] = YCSBWorkload(K4B_CASES[label][0](),
                                      device=rng.device)
    wl = _K4B_WL[label]
    q = wl.generate_plain(rng, n) if plain else wl.generate(rng, n)
    return q.keys, q.is_write


def k4b_case(label: str, rng, card: str) -> dict:
    """K4b on ``label``'s input exactly against its plain version, timed
    beside it; the bound counts its hashes (the zipf power at 40 ops)."""
    n = K4B_CASES[label][1]
    got, want = k4b_run(rng, n, label), k4b_run(rng, n, label, plain=True)
    for x, y, f in zip(got, want, ("keys", "write flags")):
        if not torch.equal(x, y):
            fail(f"K4b {label}: {f} differ from plain")
    cfg = _K4B_WL[label].cfg
    if cfg.key_order and not bool((got[0][:, 1:] >= got[0][:, :-1]).all()):
        fail(f"K4b {label}: a txn's keys are not ascending")
    r = {"max_abs_err": max(max_abs(got[0], want[0]),
                            max_abs(got[1], want[1])),
         "ms": cuda_ms(lambda: k4b_run(rng, n, label)),
         "plain_ms": cuda_ms(lambda: k4b_run(rng, n, label, plain=True),
                             iters=3, warmup=1),
         "library_ms": None}
    draws = n * cfg.req_per_query
    hot = cfg.skew_method == "HOT"
    per = (4 * THREEFRY_OPS + 20) if hot else (2 * THREEFRY_OPS + 40)
    rows = (n * THREEFRY_OPS if cfg.txn_write_perc < 1.0 else 0) + (
        n * cfg.req_per_query ** 2 if cfg.key_order else 0)
    bound(r, 16 + 5 * draws, draws * per + rows)
    print(f"[K4b] {label}: {draws} draws; {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f}; bound {r['bound_ms']:.6f}, "
          f"{r['bound_by']}) (card {card})", flush=True)
    return r


SASS_FP64 = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")
SASS_INT = ("IADD3", "IADD", "IMAD", "IMUL", "LOP3", "LOP", "SHF", "SHL",
            "SHR", "ISETP", "IMNMX", "LEA", "POPC", "FLO", "BREV", "PRMT",
            "SEL", "IABS", "SGXT", "BMSK", "VIADD", "VIMNMX", "ISCADD",
            "BFE", "BFI", "IDP", "IDP4A")
SASS_FP32 = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET",
             "MUFU", "FCHK", "FRND", "FSWZADD", "F2I", "I2F", "F2F", "I2I",
             "F2FP")


def sass_mix(so, wanted: tuple) -> dict:
    """Static SASS instruction counts by pipe (integer, fp32, fp64, other)
    and by opcode (``ops``), by mangled name, of each function of the
    library ``so`` whose name holds one of ``wanted``, from ``cuobjdump
    -sass``; {} where the toolkit has no cuobjdump."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        r = subprocess.run([exe, "-sass", str(so)], capture_output=True,
                           text=True, timeout=300)
    except OSError:
        return {}
    if r.returncode != 0:
        return {}
    out, cur = {}, None
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            cur = name if any(w in name for w in wanted) else None
            if cur is not None:
                out[cur] = {"int": 0, "fp32": 0, "fp64": 0, "other": 0,
                            "ops": {}}
            continue
        m = ins.search(ln) if cur is not None else None
        if not m:
            continue
        op = m.group(1)
        base = op.split(".")[0]
        if base in SASS_FP64 or ("64" in op and base in ("F2F", "F2I", "I2F",
                                                         "MUFU")):
            pipe = "fp64"
        elif base in SASS_INT:
            pipe = "int"
        elif base in SASS_FP32:
            pipe = "fp32"
        else:
            pipe = "other"
        out[cur][pipe] += 1
        out[cur]["ops"][base] = out[cur]["ops"].get(base, 0) + 1
    return out


def sass_line(v: dict) -> str:
    """A function's pipe counts and its 12 most frequent opcodes."""
    top = sorted(v["ops"].items(), key=lambda kv: -kv[1])[:12]
    return (", ".join(f"{p} {v[p]}" for p in ("int", "fp32", "fp64",
                                                "other"))
            + "; " + " ".join(f"{o}:{c}" for o, c in top))


def sm_clock_ghz() -> float:
    """The card's largest SM clock (``nvidia-smi clocks.max.sm``), GHz."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    return float(r.stdout.split()[0]) / 1e3


# the H100's pipe rates per SM and clock: 64 INT32, 128 FP32, 64 FP64
PIPE_PER_SM = {"int": 64, "fp32": 128, "fp64": 64}
K4B_PIECES = (("empty launch", 1), ("prologue alone", 2),
              ("hashes, no power", 3), ("power alone", 4), ("whole", 0))


def old_gen_params(wl) -> tuple:
    """The slice-4 K4b's sampler arguments: theta_zero, n, zetan, eta,
    alpha, thresh1, hot_max, access_perc."""
    s, f = wl.sampler, np.float32
    if hasattr(s, "hot_max"):
        return (0, f(0), f(0), f(0), f(0), f(0), s.hot_max,
                f(s.access_perc))
    p = s.f32_params
    return (int(p["theta_zero"]), p["n"], p.get("zetan", f(0)),
            p.get("eta", f(0)), p.get("alpha", f(0)), p.get("thresh1", f(0)),
            0, f(0))


def k4b_split(lib, so, rngs: dict, card: str) -> None:
    """``[K4b-split]``: the slice-4 K4b (its copy in the probe) whole and
    in pieces on the main path's zipf draws, ``ycsb_hot``'s and the HOT
    row's, the row sort alone where key_order is on; then each piece's
    static SASS counts by pipe and the instruction floor they imply."""
    import ctypes
    from deneva_tpu_torch import kernels
    fn = lib.k17p_generate
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [I, P, I, I, I, I, F, F, F, F, F, I, F, F, I, F, I, P, P,
                   P]
    fn.restype = I
    per_draw: dict = {}
    for label in ("zipf 0.9, 65,536 x 10", "ycsb_hot, 2,048 x 10",
                  "HOT, key_order, txn_write_perc 0.25, 65,536 x 10"):
        rng, n = rngs[label], K4B_CASES[label][1]
        k4b_run(rng, 1, label)             # the workload, cached
        wl = _K4B_WL[label]
        cfg = wl.cfg
        req = cfg.req_per_query
        keys = torch.empty((n, req), dtype=torch.int32, device=rng.device)
        isw = torch.empty((n, req), dtype=torch.bool, device=rng.device)

        def call(piece, order=int(cfg.key_order)):
            e = fn(piece, kernels.ptr(rng), n, req, wl.n_rows,
                   *old_gen_params(wl), np.float32(cfg.write_perc),
                   int(cfg.txn_write_perc < 1.0),
                   np.float32(cfg.txn_write_perc), order, kernels.ptr(keys),
                   kernels.ptr(isw), kernels.stream(rng))
            if e != 0:
                fail(f"k17p_generate: CUDA error {e}")
        call(0)
        torch.cuda.synchronize()
        want = k4b_run(rng, n, label, plain=True)
        if not (torch.equal(keys, want[0]) and torch.equal(isw, want[1])):
            fail(f"[K4b-split] the probe's copy differs from plain on "
                 f"{label}")
        pieces = K4B_PIECES if cfg.skew_method != "HOT" else \
            tuple(x for x in K4B_PIECES if x[1] not in (3, 4))
        t = {nm: cuda_ms(lambda pc=pc: call(pc)) for nm, pc in pieces}
        if cfg.key_order:
            call(0, order=0)
            raw = keys.clone()
            copy_ms = cuda_ms(lambda: keys.copy_(raw))
            t["row sort alone"] = cuda_ms(
                lambda: (keys.copy_(raw), call(5))) - copy_ms
        print(f"[K4b-split] {label}: {n * req} draws, grid "
              f"{(n * req + 255) // 256} x 256; " + ", ".join(
                  f"{nm} {v:.4f} ms" for nm, v in t.items())
              + f" (card {card})", flush=True)
        del keys, isw
    mix = sass_mix(so, ("generate_kernel", "sort_rows_kernel",
                        "density_hist_kernel", "density_conf_kernel"))
    if not mix:
        print("[K4b-split] SASS counts: not measured (no cuobjdump)",
              flush=True)
        return
    ghz = sm_clock_ghz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key, v in mix.items():
        print(f"[K4b-split] SASS {key}: {sass_line(v)} (static, whole "
              f"function)", flush=True)
    def pick(sub):
        return next((v for k, v in mix.items() if sub in k), None)
    whole, pro, nopow = (pick(f"generate_kernelILi{pc}ELb1")
                         for pc in (0, 2, 3))
    if whole and pro and nopow:
        # a zipf draw runs the zipf-only loop body once: the whole kernel
        # less its prologue (static counts; the power's rare branches
        # included); the power is the whole less the hashes without it
        draws = BATCH * REQ
        for what, a, b in (("a zipf draw", whole, pro),
                           ("its power", whole, nopow)):
            per = {p: max(a[p] - b[p], 0) for p in PIPE_PER_SM}
            floors = {p: draws * per[p] / (PIPE_PER_SM[p] * sms * ghz *
                                           1e9) * 1e3 for p in per}
            print(f"[K4b-split] {what} (static SASS, the slice-4 kernel's "
                  f"zipf branch): {per}; at {sms} SMs x {ghz:.3f} GHz and "
                  f"{PIPE_PER_SM} a clock and SM, {draws} draws' dispatch "
                  f"floor " + ", ".join(f"{p} {v:.4f} ms"
                                        for p, v in floors.items())
                  + f" (card {card})", flush=True)


def phase_slice17(dev, card: str) -> None:
    """``[K13b-split]`` and ``[K4b-split]`` (the slice-8 K13b and the
    slice-4 K4b taken apart in ``probes/k13b_k4b_costs.cu``), then
    ``[K13b]`` on its three inputs (`k13b_inputs`) and ``[K4b]`` on its
    nine (`K4B_CASES`), each exact against its plain version and timed
    (``--slice17`` runs only these); with ``--slice17-parent DIR`` each
    beside the kernels of the checkout at DIR on the same inputs, and
    with ``--profile`` the audited and metered OCC ``ycsb_skew``,
    ``part_cnt = 4``, forwarding fingerprint and ``ycsb_hot`` profiles."""
    from deneva_tpu_torch.ops import prng
    lib, so = probe_lib("k13b_k4b_costs")
    dens = k13b_inputs(dev)
    k13b_split(lib, dens, card)
    rngs = {label: prng.split(prng.key_from_seed(23 + i, dev))[1]
            for i, label in enumerate(K4B_CASES)}
    k4b_split(lib, so, rngs, card)
    inputs = {}
    for label, args in dens.items():
        k13b_case(label, args, card)
        inputs[f"K13b {label}"] = ("K13b", args)
    k13b_phases(dens, card)
    for label, rng in rngs.items():
        k4b_case(label, rng, card)
        inputs[f"K4b {label}"] = ("K4b", (rng, K4B_CASES[label][1], label))
    from deneva_tpu_torch import kernels
    mix = sass_mix(next(kernels.BUILD_DIR.glob("libdeneva_kernels_*.so")),
                   ("15generate_kernel", "density_kernel"))
    for key, v in mix.items():
        print(f"[K4b] SASS of this tree's {key}: {sass_line(v)} (static)",
              flush=True)
    if "--slice17-parent" in sys.argv:
        vs_parent(inputs, sys.argv[sys.argv.index("--slice17-parent") + 1],
                  card, "slice17")
    del inputs, dens
    _K4B_WL.clear()
    torch.cuda.empty_cache()
    if "--profile" in sys.argv:
        for label, path, cfg_fn in SLICE17_PROFILES:
            phase_profile(dev, cfg_fn(), label, path=path)
            torch.cuda.empty_cache()
        if "--slice17-parent" in sys.argv:
            # the same cells' profiles on the parent's package, in a child
            root = sys.argv[sys.argv.index("--slice17-parent") + 1]
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--parent-profile", root],
                               capture_output=True, text=True, timeout=1200)
            if r.returncode != 0:
                fail(f"the parent's profiles at {root}: {r.stderr[-2000:]}")
            for ln in r.stdout.splitlines():
                if ln.startswith("[profile]") and "  " not in ln[:12]:
                    print(ln.replace("[profile]", "[slice17-parent-profile]",
                                     1), flush=True)


def parent_profile(root: str) -> int:
    """``--parent-profile``: ``SLICE17_PROFILES`` (``SLICE18_PROFILES``
    with ``--slice18``) on the package at ``root`` (the parent
    commit)."""
    sys.path.insert(0, os.path.abspath(root))
    from deneva_tpu_torch import kernels
    if not kernels.__file__.startswith(os.path.abspath(root)):
        fail(f"--parent-profile imported {kernels.__file__}, not the tree "
             f"at {root}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cells = SLICE18_PROFILES if "--slice18" in sys.argv else SLICE17_PROFILES
    for label, path, cfg_fn in cells:
        phase_profile(dev, cfg_fn(), label, path=path)
        torch.cuda.empty_cache()
    return 0


SLICE17_PROFILES = (
    ("OCC ycsb_skew audited cadence 1", "OCC+A",
     lambda: audited(skew_config, False, "OCC")),
    ("part_cnt 4 forwarding fingerprint", None,
     lambda: part_cfg(config, False, metrics=True)),
    ("fingerprint", "TPU_BATCH", lambda: config(False)),
    ("MAAT ycsb_hot", "MAAT", lambda: hot_config(False)))


# -- slice 18: K9b and K18a ---------------------------------------------------

def k9b_inputs(dev, shapes=K11B_SHAPES) -> dict:
    """K9b's arguments as ``validate_maat`` hands them over, (P, live0,
    sweep_rounds), on `K11B_SHAPES`' epochs (or ``shapes``): ``ycsb_skew``'s
    epoch 4, the first ``ycsb_hot`` epoch from 4 on whose level gate is
    set, and the first such ``operating_points`` MAAT epoch at B = 8,192,
    each engine from a fresh state."""
    from deneva_tpu_torch.cc import maat
    from deneva_tpu_torch.ops import conflict
    out = {}
    for label, cfg_fn, first in shapes:
        eng = make_engine(dev, cfg_fn())
        st, calls, peels = eng.init_state(), [], []
        with grab_calls(conflict, "precedence_levels", calls), \
                grab_calls(maat, "peel", peels):
            for e in range(1, 16):
                st = eng.step(st)
                if e >= first and bool(peels[-1][6].any()):
                    break
            else:
                fail(f"K9b {label}: no epoch up to 15 set the level gate")
        torch.cuda.synchronize()
        out[label + ("" if e == first else f" (epoch {e})")] = \
            tuple(calls[-1])
        del eng, st, calls, peels
        torch.cuda.empty_cache()
    return out


def k9b_bytes(b: int) -> int:
    """The bytes K9b must move at B = ``b``: P read once, the active flags
    in, the levels (4 B) and the flags (1 B) out."""
    return b * b + b + 5 * b


def k9b_split(lib, inputs: dict, card: str) -> None:
    """``[K9b-split]`` and ``[K9b-rounds]``: the slice-4 K9b (its copy in
    the probe) on each input, held to the plain version: ``pack_cols``
    alone, the sweep alone, both; the rounds its sweep ran and |F_r| at
    the top of each.  Then P's strips (``ycsb_skew``'s at B = 2,048, the
    B = 8,192 epoch's): B^2 / k bytes through one CTA with 16-byte loads
    and by bulk copies, the column strip of B / k columns through one
    CTA and k strips through k CTAs at once, k = 4, 8, 16."""
    import ctypes
    from deneva_tpu_torch import kernels
    from deneva_tpu_torch.ops import conflict
    fn = lib.k18p_levels
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    strip = lib.k18p_strip
    strip.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    strip.restype = ctypes.c_int
    for label, (p, live0, rounds) in inputs.items():
        b = p.shape[0]
        dev = p.device
        bits = torch.empty((b, -(-b // 32)), dtype=torch.int32, device=dev)
        lv = torch.empty(b, dtype=torch.int32, device=dev)
        un = torch.empty(b, dtype=torch.bool, device=dev)
        stats = torch.zeros(1 + rounds, dtype=torch.int32, device=dev)
        s = kernels.stream(p)

        def call(piece, st=None):
            e = fn(piece, kernels.ptr(p), kernels.ptr(live0), b, rounds,
                   kernels.ptr(bits), kernels.ptr(lv), kernels.ptr(un),
                   None if st is None else kernels.ptr(st), s)
            if e != 0:
                fail(f"k18p_levels: CUDA error {e}")
        call(3, stats)
        torch.cuda.synchronize()
        want = conflict.precedence_levels_plain(p, live0, rounds)
        if not (torch.equal(lv, want[0]) and torch.equal(un, want[1])):
            fail(f"[K9b-split] the probe's slice-4 K9b differs from plain "
                 f"on {label}")
        t = {nm: cuda_ms(lambda piece=piece: call(piece))
             for nm, piece in (("pack_cols", 1), ("sweep", 2),
                               ("both", 3))}
        ran = int(stats[0])
        sizes = stats[1:1 + min(rounds, ran + 1)].tolist()
        print(f"[K9b-split] {label}: B={b} rounds={rounds} active="
              f"{int(live0.sum())}; " + ", ".join(
                  f"{nm} {v:.4f} ms" for nm, v in t.items())
              + f" (card {card})", flush=True)
        print(f"[K9b-rounds] {label}: the slice-4 sweep ran {ran} rounds "
              f"of {rounds}; |F_r| at the top of each: {sizes}; unstable "
              f"{int(want[1].sum())}; the sweep's ms a round "
              f"{t['sweep'] / max(ran, 1):.4f} (card {card})", flush=True)
        if b % 256 == 0 and b in (SKEW_BATCH, 8192):
            out = torch.zeros(1, dtype=torch.int32, device=dev)
            parts = []
            for k in (4, 8, 16):
                for mode, nm in ((0, "flat 16 B"), (1, "bulk"),
                                 (2, "cols, one CTA"), (3, f"cols, {k} CTAs")):
                    if b >= 8192 and mode < 3 and k < 16:
                        continue
                    def one(mode=mode, k=k):
                        e = strip(mode, kernels.ptr(p), b, k,
                                  kernels.ptr(out), s)
                        if e != 0:
                            fail(f"k18p_strip: CUDA error {e}")
                    parts.append(f"1/{k} {nm} {cuda_ms(one):.4f}")
            pk = lib.k18p_pack
            pk.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + \
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
            pk.restype = ctypes.c_int
            depth = []
            for dp, nm in enumerate(("loads", "+ bits staged",
                                     "+ transpose, rows stored",
                                     "+ witnesses, F_1")):
                def one(dp=dp):
                    e = pk(dp, kernels.ptr(p), kernels.ptr(live0), b, 16,
                           kernels.ptr(out), s)
                    if e != 0:
                        fail(f"k18p_pack: CUDA error {e}")
                if b == SKEW_BATCH:
                    depth.append(f"{nm} {cuda_ms(one):.4f}")
            if depth:
                print(f"[K9b-split] {label}: K9b's pack over 16 blocks, "
                      f"cut at each depth: " + ", ".join(depth)
                      + f" ms (card {card})", flush=True)
            print(f"[K9b-split] {label} strips of P ({b * b} bytes): "
                  + ", ".join(parts) + f"; pack_cols {t['pack_cols']:.4f} "
                  f"ms (card {card})", flush=True)
        del bits, lv, un, stats


K9B_REGIMES = ((0, "staged"), (1, "L2"))


def k9b_case(label: str, args: tuple, card: str, sizes: bool = False
             ) -> float:
    """K9b on one input exactly against ``precedence_levels_plain``, in
    the layout the library picks, timed; with ``sizes`` also at each
    cluster size in each regime that takes it.  Returns the ms."""
    from deneva_tpu_torch.ops import conflict
    p, live0, rounds = args
    b = p.shape[0]
    want = conflict.precedence_levels_plain(p, live0, rounds)

    def check(*kw):
        got = conflict.precedence_levels(p, live0, rounds, *kw)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"K9b ({label}, layout {kw or 'auto'}) differs from plain")
    check()
    ctas, staged, _ = conflict.precedence_levels_layout(b)
    ms = cuda_ms(lambda: conflict.precedence_levels(p, live0, rounds))
    line = (f"[K9b] {label}: B={b} rounds={rounds} active="
            f"{int(live0.sum())} unstable={int(want[1].sum())}; "
            f"{ctas} CTAs, {'staged' if staged else 'L2'}: {ms:.4f} ms")
    if sizes:
        parts = []
        for regime, nm in K9B_REGIMES:
            for c in (1, 2, 4, 8, 16):
                try:
                    conflict.precedence_levels_layout(b, c, regime)
                except ValueError:
                    continue
                check(c, regime)
                ms_c = cuda_ms(lambda c=c, r=regime: conflict.precedence_levels(
                    p, live0, rounds, c, r))
                parts.append(f"{nm} C={c} {ms_c:.4f}")
        line += "; " + ", ".join(parts)
    print(line + f" (card {card})", flush=True)
    return ms


def stamp_phases(st: list, names: tuple) -> str:
    """A kernel's phase stamps (``csrc/common.cuh``: globaltimer ns at
    entry and exit, then clocks at each boundary) as µs a phase: each
    phase's share of the clocks times the timed ns."""
    ns = st[1] - st[0]
    clocks = st[2 + len(names)] - st[2]
    us = [(st[3 + i] - st[2 + i]) / max(clocks, 1) * ns / 1e3
          for i in range(len(names))]
    return ", ".join(f"{nm} {u:.2f}" for nm, u in zip(names, us)) + \
        f" (entry to exit {ns / 1e3:.2f} µs)"


def k9b_phases(label: str, args: tuple, card: str) -> None:
    """``[K9b-phases]``: CTA 0's phase stamps of one call in the library's
    layout, and the call at rounds = 0 (the launch alone: no pack, no
    round) and rounds = 1 (the pack and F_1's exchange)."""
    from deneva_tpu_torch.ops import conflict
    p, live0, rounds = args
    st = torch.zeros(8, dtype=torch.int64, device=p.device)
    conflict.precedence_levels(p, live0, rounds, stamps=st)
    st = st.tolist()
    t0 = cuda_ms(lambda: conflict.precedence_levels(p, live0, 0))
    t1 = cuda_ms(lambda: conflict.precedence_levels(p, live0, 1))
    print(f"[K9b-phases] {label}: " + stamp_phases(
        st, ("setup", "pack", "F_1 exchange", "rounds"))
        + f"; {st[7]} rounds exchanged; call at rounds 0 {t0:.4f} ms, at "
        f"rounds 1 {t1:.4f} (card {card})", flush=True)


def k18a_phases(label: str, args: tuple, card: str) -> None:
    """``[K18a-phases]``: block 0's phase stamps of one call."""
    from deneva_tpu_torch.ops import forward
    st = torch.zeros(13, dtype=torch.int64, device=args[0].device)
    forward.mc_slice_defer(*args, stamps=st)
    st = st.tolist()
    if st[12] != 2:
        print(f"[K18a-phases] {label}: {st[12]} passes (stamps cover two)",
              flush=True)
        return
    print(f"[K18a-phases] {label}: " + stamp_phases(
        st, ("ts histograms", "lanes", "barrier", "digit bases", "pass 1",
             "barrier", "pass 2", "barrier", "scans and test"))
        + f" (card {card})", flush=True)


def k18a_inputs(dev, ds=(8, 4)) -> dict:
    """K18a's arguments on real main-path epochs at 2^27 rows (after two
    epochs, so the pool holds txns of several ages): the first shard
    call at each D of ``ds`` (8 and 4), and with D = 4 a slice of 32,768
    txns at D = 2 (two D = 4 slices side by side at the pair_cap of an
    even share, since ``mc_plan_capacity``'s default plans D = 2
    replicated)."""
    from deneva_tpu_torch.ops import forward, mc_pair_cap
    out = {}
    for d in ds:
        eng, run, st = mesh_engine(dev, mesh_config(d))
        st = run(st, 2)
        ca = []
        with grab_calls(forward, "mc_slice_defer", ca):
            st = run(st, 1)
        torch.cuda.synchronize()
        if len(ca) != d:
            fail(f"K18a: {len(ca)} calls in one D = {d} epoch")
        out[f"D={d}"] = ca[0]
        if d == 4 and len(ds) > 1:
            k, v, ts = (torch.cat([ca[0][i], ca[1][i]]) for i in range(3))
            out["D=2"] = (k, v, ts, 2,
                          mc_pair_cap(2 * k.shape[0], k.shape[1], 2, 1.0))
        del eng, run, st, ca
        torch.cuda.empty_cache()
    return out


def ts_bytes_varying(ts: torch.Tensor) -> int:
    """The bytes of (ts xor 2^31) that differ across the slice: the radix
    passes K18a makes."""
    u = (ts.to(torch.int64) + 2**31) & 0xFFFFFFFF
    return sum(int(((u >> (8 * p)) & 255).unique().numel() > 1)
               for p in range(4))


def k18a_case(label: str, args: tuple, card: str) -> float:
    """K18a on one input exactly against ``mc_slice_defer_plain``, timed,
    with its grid and passes.  Returns the ms."""
    from deneva_tpu_torch.ops import forward
    k, v, ts, d, cap = args
    bd, a = k.shape
    want = forward.mc_slice_defer_plain(*args)
    got = forward.mc_slice_defer(*args)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        fail(f"K18a ({label}) differs from plain")
    grid, tiles, _ = forward.mc_defer_layout(bd, a, d)
    ms = cuda_ms(lambda: forward.mc_slice_defer(*args))
    print(f"[K18a] {label}: bD={bd} A={a} D={d} pair_cap={cap}, defers "
          f"{int(want[0].sum())}, ts span {int(ts.max()) - int(ts.min())} "
          f"({ts_bytes_varying(ts)} radix passes); one cooperative launch "
          f"of {grid} blocks over {tiles} tiles: {ms:.4f} ms (card {card})",
          flush=True)
    return ms


def k18a_split(lib, inputs: dict, card: str) -> None:
    """``[K18a-split]``: the slice-9 K18a (its copy in the probe) on each
    input, held to the plain version: its six stream operations each
    alone and all six; then an empty cooperative launch of 8, 16 and 32
    blocks of 1,024 threads (the new kernel's grids at D = 8, 4, 2) with
    0 to 4 grid barriers."""
    import ctypes
    from deneva_tpu_torch import kernels
    from deneva_tpu_torch.ops import forward
    fn = lib.k18p_defer
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    for label, (k, v, ts, d, cap) in inputs.items():
        bd, a = k.shape
        dev = k.device
        dfr = torch.empty(bd, dtype=torch.bool, device=dev)
        order = torch.empty(bd, dtype=torch.int32, device=dev)
        cnt = torch.empty(d * (bd + 1), dtype=torch.int32, device=dev)
        rank = torch.empty(bd, dtype=torch.int32, device=dev)
        ptrs = [kernels.ptr(x) for x in (k, v, ts)]

        def call(ops):
            e = fn(ops, *ptrs, bd, a, d, cap, kernels.ptr(dfr),
                   kernels.ptr(order), kernels.ptr(cnt), kernels.ptr(rank),
                   kernels.stream(k))
            if e != 0:
                fail(f"k18p_defer: CUDA error {e}")
        call(63)
        torch.cuda.synchronize()
        want = forward.mc_slice_defer_plain(k, v, ts, d, cap)
        if not (torch.equal(dfr, want[0]) and torch.equal(order, want[1])):
            fail(f"[K18a-split] the probe's slice-9 K18a differs from plain "
                 f"on {label}")
        t = {"memset": cuda_ms(lambda: call(1)),
             "rank": cuda_ms(lambda: call(2))}
        call(3)                 # a fresh rank for the order's writes
        t.update({nm: cuda_ms(lambda ops=ops: call(ops))
                  for nm, ops in (("order", 4), ("count rows", 8),
                                  ("row scans", 16), ("test", 32),
                                  ("all six", 63))})
        print(f"[K18a-split] {label}: bD={bd} A={a} D={d}; " + ", ".join(
            f"{nm} {x:.4f} ms" for nm, x in t.items())
            + f"; the six alone sum to {sum(t.values()) - t['all six']:.4f} "
            f"(card {card})", flush=True)
        del dfr, order, cnt, rank
    fb = lib.k18p_barriers
    fb.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fb.restype = ctypes.c_int
    s = kernels.stream(torch.empty(1, device="cuda"))
    for grid in (8, 16, 32):
        t = []
        for n in range(5):
            def one(n=n):
                e = fb(grid, 1024, n, None, s)
                if e != 0:
                    fail(f"k18p_barriers: CUDA error {e}")
            t.append(f"{n} barriers {cuda_ms(one):.4f}")
        print(f"[K18a-split] an empty cooperative launch of {grid} blocks of "
              f"1,024 threads: " + ", ".join(t) + f" ms (card {card})",
              flush=True)


SLICE18_PROFILES = (
    ("MAAT fingerprint", "MAAT", lambda: skew_config(False, "MAAT")),
    ("MAAT ycsb_hot", "MAAT", lambda: hot_config(False)),
    ("mesh 2^27 D=8", "MESH8", lambda: mesh_config(8)))


def phase_slice18(dev, card: str) -> None:
    """``[K9b-split]``, ``[K9b-rounds]`` and ``[K18a-split]`` (the slice-4
    K9b and the slice-9 K18a taken apart in ``probes/k9b_k18a_costs.cu``),
    then ``[K9b]`` on `k9b_inputs` at each cluster size and regime and
    ``[K18a]`` on `k18a_inputs`, each exact against its plain version and
    timed (``--slice18`` runs only these); with ``--slice18-parent DIR``
    each beside the kernels of the checkout at DIR on the same inputs,
    and with ``--profile`` the MAAT ``ycsb_skew``, MAAT ``ycsb_hot`` and
    mesh D = 8 profiles (and the parent's, with ``--slice18-parent``)."""
    lib, _ = probe_lib("k9b_k18a_costs")
    levels = k9b_inputs(dev)
    k9b_split(lib, levels, card)
    mc = k18a_inputs(dev)
    k18a_split(lib, mc, card)
    inputs = {}
    for label, args in levels.items():
        k9b_case(label, args, card, sizes=True)
        k9b_phases(label, args, card)
        inputs[f"K9b {label}"] = ("K9b", args)
    for label, args in mc.items():
        k18a_case(label, args, card)
        k18a_phases(label, args, card)
        inputs[f"K18a {label}"] = ("K18a", args)
    if "--slice18-parent" in sys.argv:
        vs_parent(inputs, sys.argv[sys.argv.index("--slice18-parent") + 1],
                  card, "slice18")
    del inputs, levels, mc
    torch.cuda.empty_cache()
    if "--profile" in sys.argv:
        for label, path, cfg_fn in SLICE18_PROFILES:
            phase_profile(dev, cfg_fn(), label, path=path)
            torch.cuda.empty_cache()
        if "--slice18-parent" in sys.argv:
            root = sys.argv[sys.argv.index("--slice18-parent") + 1]
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--parent-profile", root, "--slice18"],
                               capture_output=True, text=True, timeout=1200)
            if r.returncode != 0:
                fail(f"the parent's profiles at {root}: {r.stderr[-2000:]}")
            for ln in r.stdout.splitlines():
                if ln.startswith("[profile]") and "  " not in ln[:12]:
                    print(ln.replace("[profile]", "[slice18-parent-profile]",
                                     1), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if "--parent-child" in sys.argv:
        i = sys.argv.index("--parent-child")
        return parent_child(sys.argv[i + 1], sys.argv[i + 2])
    if "--parent-profile" in sys.argv:
        return parent_profile(
            sys.argv[sys.argv.index("--parent-profile") + 1])
    import deneva_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.monotonic()
    info = phase_device()
    phase_build()
    if "--order-index-window" in sys.argv:
        order_index_window(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--audit-overhead" in sys.argv:
        audit_overhead(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--cluster-costs" in sys.argv:
        cluster_costs(info["card"])
        if "--slice14" not in sys.argv:
            print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
            return 0
    if "--slice18" in sys.argv:
        phase_slice18(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--slice17" in sys.argv:
        phase_slice17(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--slice16" in sys.argv:
        phase_slice16(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--slice15" in sys.argv:
        phase_slice15(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--slice14" in sys.argv:
        phase_slice14(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--slice13" in sys.argv:
        phase_slice13(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--slice12" in sys.argv:
        phase_slice12(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    if "--slice11" in sys.argv:
        phase_k21(dev, {"K21_cross_group_defer": {}}, info["card"])
        phase_part(dev, info["card"])
        phase_router(dev, info["card"])
        phase_ctrl_simulate(dev, info["card"])
        print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    rec = {nm: {} for nm in ("K1_sort_lanes", "K2_plan_scans",
                             "K3_forward_execute[fingerprint]",
                             "K3_forward_execute[full_row]",
                             "K4a_threefry_split", "K4b_ycsb_generate",
                             "K5K6_build_incidence", "K7_overlap",
                             "K8_first_fit", "K8_first_fit[B=2048]",
                             "K10_last_writer", "K10_last_writer[N=20480]",
                             "K12a_watermark_check", "K12b_commit_watermarks",
                             "K12c_version_read", "K12d_version_push",
                             "K4b_ycsb_generate[hot]",
                             "K9a_wavefront_levels", "K9b_precedence_levels",
                             "K9b_precedence_levels[B=8192]",
                             "K11a_maat_reach", "K11b_maat_peel",
                             "K14b_sorted_lookup", "K14a_hash_lookup",
                             "K14c_scatter_add", "K14d_append",
                             "K19_tpcc_generate", "K14e_index_merge",
                             "K14e_sorted_probe", "K20_pps_generate",
                             "K13a_repair_frontier", "K15a_lane_sort",
                             "K15b_seg_scans", "K16_dgcc_relax",
                             "K13b_conflict_density",
                             "K13b_conflict_density[B=2048]",
                             "K15c_audit_scans",
                             "K15c_compact_edges",
                             "K17_audit_observe[lanes]",
                             "K17_audit_observe[stamps]",
                             "K18a_mc_defer", "K18a_mc_defer[D=4]",
                             "K18b_mc_pack", "K21_cross_group_defer")}
    phase_kernels(dev, rec, info["card"])
    phase_sweep_kernels(dev, rec, info["card"])
    phase_to_kernels(dev, rec, info["card"])
    torch.cuda.empty_cache()
    phase_slice4_kernels(dev, rec, info["card"])
    torch.cuda.empty_cache()
    phase_tpcc_kernels(dev, rec, info["card"])
    torch.cuda.empty_cache()
    phase_slice6_kernels(dev, rec, info["card"])
    torch.cuda.empty_cache()
    phase_slice7_kernels(dev, rec, info["card"])
    torch.cuda.empty_cache()
    phase_slice8_kernels(dev, rec, info["card"])
    torch.cuda.empty_cache()
    phase_slice9_kernels(dev, rec, info["card"])
    phase_k21(dev, rec, info["card"])
    for full in (False, True):
        phase_epochs(dev, full)
        torch.cuda.empty_cache()
    for full in (False, True):
        phase_sweep_epochs(dev, full)
        torch.cuda.empty_cache()
    phase_lock_to_epochs(dev)
    torch.cuda.empty_cache()
    phase_lock_to_oracles(dev)
    torch.cuda.empty_cache()
    phase_slice4_epochs(dev)
    torch.cuda.empty_cache()
    phase_tpcc_epochs(dev, info["card"])
    torch.cuda.empty_cache()
    probe_launches = phase_slice6_epochs(dev, info["card"])
    phase_slice7_epochs(dev, info["card"])
    phase_slice8_epochs(dev, info["card"])
    torch.cuda.empty_cache()
    phase_slice9_epochs(dev, info["card"])
    torch.cuda.empty_cache()
    launches: dict[str, int] = {}
    # slice 11: the partitioned cells, the routed epochs and the armed
    # controller's run; their kernel runs count on the main path, by the
    # rows of their cells' batches (`k8_row`)
    for counts in (phase_part(dev, info["card"]),
                   phase_router(dev, info["card"]),
                   phase_ctrl_simulate(dev, info["card"])):
        for key, c in counts.items():
            if key in rec:
                launches[key] = launches.get(key, 0) + c
    torch.cuda.empty_cache()
    tput = {}
    fields_of: dict[str, dict] = {}
    win = {"warmup_secs": 1.0, "done_secs": 3.0}
    runs = [("TPU_BATCH", "fingerprint", config(False, **win)),
            ("TPU_BATCH", "full_row", config(True, **win)),
            ("OCC", "fingerprint", occ_config(False, **win)),
            ("NOCC", "fingerprint", occ_config(False, "NOCC", **win))]
    runs += [(alg, "fingerprint", skew_config(False, alg, **win))
             for alg in ("NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC",
                         "CALVIN", "MAAT")]
    runs += [("MAAT", "ycsb_hot", hot_config(False, **win)),
             ("MAAT", "operating_points B=8192",
              operating_config("MAAT", 8192, **win)),
             ("MODES", "SIMPLE", modes_config("SIMPLE", **win)),
             ("MODES", "QRY_ONLY", modes_config("QRY_ONLY", **win)),
             ("BTREE", "fingerprint", btree_config(**win))]
    runs += [("TPCC_CHAINED", "tpcc 64wh", tpcc_config(64, **win)),
             ("TPCC_CHAINED", "tpcc 4wh", tpcc_config(4, **win)),
             ("TPCC_CHAINED", "CALVIN tpcc 4wh",
              tpcc_config(4, "CALVIN", **win)),
             ("TPCC_SWEEP", "NO_WAIT tpcc 4wh",
              tpcc_config(4, "NO_WAIT", **win)),
             ("TPCC_SWEEP", "OCC tpcc 4wh", tpcc_config(4, "OCC", **win)),
             ("TPCC_TO", "MVCC tpcc 4wh", tpcc_config(4, "MVCC", **win))]
    # tpcc_escrow's other algorithms and its escrow-off cells
    runs += [("TPCC_TO", "TIMESTAMP tpcc 4wh",
              tpcc_config(4, "TIMESTAMP", **win)),
             ("TPCC_SWEEP", "WAIT_DIE tpcc 4wh",
              tpcc_config(4, "WAIT_DIE", **win)),
             ("TPCC_MAAT", "MAAT tpcc 4wh", tpcc_config(4, "MAAT", **win))]
    runs += [(path, f"{alg} tpcc 4wh escrow off",
              tpcc_config(4, alg, escrow_sweep=False, **win))
             for path, alg in (("TPCC_SWEEP", "NO_WAIT"),
                               ("TPCC_SWEEP", "OCC"), ("TPCC_TO", "MVCC"))]
    # tpcc_order_index: TPU_BATCH and CALVIN at 4, 16 and 64 warehouses,
    # the index off and on (the off cells not run above)
    for wh in (4, 16, 64):
        for alg in ("TPU_BATCH", "CALVIN"):
            if wh == 16 or (wh == 64 and alg == "CALVIN"):
                runs.append(("TPCC_CHAINED", f"{alg} tpcc {wh}wh",
                             tpcc_config(wh, alg, **win)))
            runs.append(("TPCC_CHAINED_IDX", f"{alg} tpcc {wh}wh order index",
                         index_config(wh, alg, **win)))
    # pps_scaling (all eight algorithms) and escrow_ablation's PPS cells
    pps_paths = {"TPU_BATCH": "PPS_CHAINED", "CALVIN": "PPS_CHAINED",
                 "NO_WAIT": "PPS_SWEEP", "WAIT_DIE": "PPS_SWEEP",
                 "OCC": "PPS_SWEEP", "TIMESTAMP": "PPS_TO", "MVCC": "PPS_TO",
                 "MAAT": "PPS_MAAT"}
    runs += [(path, f"{alg} pps", pps_config(alg, **win))
             for alg, path in pps_paths.items()]
    runs += [("PPS_CHAINED", f"{alg} pps escrow_ablation escrow "
              f"{'on' if esc else 'off'}",
              pps_config(alg, epoch_batch=1024, exec_subrounds=4,
                         escrow_order_free=esc, **win))
             for alg in ("TPU_BATCH", "CALVIN") for esc in (True, False)]
    # repair_ablation: YCSB under OCC and MAAT with repair off (whose
    # launches are the rounds-0 path's) and at rounds 0, 1, 2, NO_WAIT
    # and TIMESTAMP at rounds 2; TPC-C 4 wh escrow off under OCC at
    # rounds 2 (its repair-off cell is "OCC tpcc 4wh escrow off" above)
    for alg in ("OCC", "MAAT"):
        runs.append((f"{alg}+R0", f"{alg} repair_ablation repair off",
                     repair_config(alg, None, **win)))
        runs += [(f"{alg}+R{r}", f"{alg} repair_ablation rounds {r}",
                  repair_config(alg, r, **win)) for r in (0, 1, 2)]
    runs += [(f"{alg}+R2", f"{alg} repair_ablation rounds 2",
              repair_config(alg, 2, **win)) for alg in ("NO_WAIT", "TIMESTAMP")]
    runs.append(("TPCC_SWEEP+R2", "OCC tpcc 4wh escrow off repair rounds 2",
                 tpcc_config(4, "OCC", escrow_sweep=False, repair=True,
                             repair_rounds=2, **win)))
    # dgcc_contention's DGCC cells: theta 0, 0.6, 0.9, 0.99 at 90% writes
    # and 30% writes at theta 0.9; DGCC at TPC-C 4 wh
    runs += [("DGCC", f"DGCC dgcc_contention theta {t} writes 0.9",
              dgcc_config(t, **win)) for t in (0.0, 0.6, 0.9, 0.99)]
    runs += [("DGCC", "DGCC dgcc_contention theta 0.9 writes 0.3",
              dgcc_config(0.9, 0.3, **win)),
             ("TPCC_DGCC", "DGCC tpcc 4wh", tpcc_config(4, "DGCC", **win))]
    # slice 8: the audited cells at cadence 1 (OCC and CALVIN also at the
    # default 8, beside their off runs), OCC with the mutation over the
    # whole run, and the metrics plane alone on the forwarding main path
    # and on OCC at three skews
    runs.append(("OCC", "OCC ycsb_skew", skew_config(False, "OCC", **win)))
    for lb, (path, cfg) in slice8_cells().items():
        runs.append((path, f"{lb} audited cadence 1",
                     cfg.replace(warmup_secs=1.0, done_secs=3.0)))
    for alg, path in (("OCC", "OCC+A"), ("CALVIN", "CALVIN+A")):
        runs.append((path, f"{alg} ycsb_skew audited cadence 8",
                     audited(skew_config, False, alg, cadence=8, **win)))
    runs.append(("OCC+A+M", "OCC ycsb_skew audited cadence 1 audit_mutate",
                 audited(skew_config, False, "OCC",
                         audit_mutate="occ-read-skip:0:1000000000", **win)))
    runs.append(("TPU_BATCH+D", "TPU_BATCH forwarding 65,536 metrics",
                 config(False, metrics=True, **win)))
    runs += [("OCC+D", f"OCC ycsb_skew theta {t} metrics",
              skew_config(False, "OCC", zipf_theta=t, metrics=True, **win))
             for t in (0.6, 0.9, 0.99)]
    # slice 9: the mesh on one card.  The main path at 2^27 rows as one
    # shard and as 8 shards sharing the card; mesh_scaling's cells; TPC-C
    # at 64 warehouses and PPS over 8 shards
    from deneva_tpu_torch.ops import mc_pair_cap
    runs += [("TPU_BATCH", "mesh 2^27 D=1", mesh_config(1, **win)),
             ("MESH8", "mesh 2^27 D=8", mesh_config(8, **win)),
             ("MESH4", "mesh 2^27 D=4", mesh_config(4, **win))]
    for d in (1, 2, 4, 8):
        for alg in ("TPU_BATCH", "CALVIN"):
            cfg = mesh_scaling_config(d, alg)
            path = alg if d == 1 else (
                "MESH" if mc_pair_cap(cfg.epoch_batch, cfg.req_per_query, d,
                                      cfg.mc_plan_capacity)
                else "MESH_REPL") + str(d)
            runs.append((path, f"mesh_scaling {alg} D={d}", cfg))
    runs += [("TPCC_CHAINED@8", "tpcc 64wh D=8",
              tpcc_config(64, device_parts=8, **win)),
             ("TPCC_SWEEP@8", "NO_WAIT tpcc 64wh D=8",
              tpcc_config(64, "NO_WAIT", device_parts=8, **win)),
             ("PPS_CHAINED@8", "pps D=8", pps_config(device_parts=8, **win)),
             ("PPS_MAAT@8", "MAAT pps D=8",
              pps_config("MAAT", device_parts=8, **win))]
    # the earlier slices' cells run short windows (0.5 s + 1 s), which
    # keeps the whole run near half its time limit; the main path, its
    # OCC comparator and the mesh's timed runs keep 1 s + 3 s
    keep = {("TPU_BATCH", "fingerprint"), ("TPU_BATCH", "full_row"),
            ("OCC", "fingerprint"), ("NOCC", "fingerprint"),
            ("TPU_BATCH", "mesh 2^27 D=1"), ("MESH8", "mesh 2^27 D=8")}
    runs = [(p, lb, c if (p, lb) in keep or c.done_secs != 3.0
             else c.replace(warmup_secs=0.5, done_secs=1.0))
            for p, lb, c in runs]
    for path, label, cfg in runs:
        mode = "full_row" if cfg.sim_full_row else "fingerprint"
        counts, fields = phase_simulate(dev, cfg, path, f"{path} {label}",
                                        info["card"])
        tput[(path, label)] = fields["tput"]
        if ("+R" in path or "DGCC" in path) and not cfg.audit:
            slice7_checks(cfg, path, label, fields, info["card"])
        if cfg.metrics or cfg.audit:
            slice8_checks(cfg, path, label, fields, info["card"])
        fields_of[f"{path} {label}"] = fields
        for nm, c in counts.items():
            key = nm
            if nm == "K3_forward_execute":
                key = f"{nm}[{mode}]"
            elif nm == "K4b_ycsb_generate" and cfg.skew_method == "HOT":
                key = f"{nm}[hot]"
            key = slice18_row(k10_row(k8_row(key, cfg.epoch_batch), cfg),
                              cfg)
            launches[key] = launches.get(key, 0) + c
        torch.cuda.empty_cache()
    print(f"[vs_baseline] TPU_BATCH / OCC committed txn/s (fingerprint) = "
          f"{tput[('TPU_BATCH', 'fingerprint')] / tput[('OCC', 'fingerprint')]:.2f}"
          f" ({tput[('TPU_BATCH', 'fingerprint')]:.1f} / "
          f"{tput[('OCC', 'fingerprint')]:.1f}; NOCC "
          f"{tput[('NOCC', 'fingerprint')]:.1f})", flush=True)
    slice8_summary(fields_of, info["card"])
    print(f"[mesh-simulate] the main path at 2^27 rows on {info['card']}: "
          f"D=1 {tput[('TPU_BATCH', 'mesh 2^27 D=1')]:.1f} committed "
          f"txn/s; D=8 (8 shards sharing one card, not 8 cards) "
          f"{tput[('MESH8', 'mesh 2^27 D=8')]:.1f}", flush=True)
    if "--profile" in sys.argv:
        for label, cfg in (("fingerprint", config(False)),
                           ("full_row", config(True)),
                           ("OCC fingerprint", occ_config(False)),
                           ("NO_WAIT fingerprint",
                            skew_config(False, "NO_WAIT")),
                           ("MVCC fingerprint", skew_config(False, "MVCC")),
                           ("MAAT fingerprint", skew_config(False, "MAAT")),
                           ("MAAT ycsb_hot", hot_config(False)),
                           ("modes SIMPLE", modes_config("SIMPLE")),
                           ("IDX_BTREE fingerprint", btree_config()),
                           ("TPCC TPU_BATCH 64wh", tpcc_config(64)),
                           ("TPCC NO_WAIT 4wh", tpcc_config(4, "NO_WAIT")),
                           ("TPCC TPU_BATCH 64wh order index",
                            index_config(64)),
                           ("PPS TPU_BATCH", pps_config()),
                           ("PPS OCC", pps_config("OCC")),
                           ("OCC repair rounds 2", repair_config("OCC", 2)),
                           ("DGCC theta 0.9", dgcc_config(0.9)),
                           ("OCC ycsb_skew audited cadence 1",
                            audited(skew_config, False, "OCC")),
                           ("mesh 2^27 D=1", mesh_config(1)),
                           ("mesh 2^27 D=8", mesh_config(8)),
                           ("part_cnt 4 forwarding fingerprint",
                            part_cfg(config, False, metrics=True))):
            phase_profile(dev, cfg, label,
                          path={lb: pt for lb, pt, _ in SLICE13_PROFILES}
                          .get(label))
            torch.cuda.empty_cache()
        from deneva_tpu_torch.cc.router import knobs_from_decision
        phase_profile(dev, router_cfg(), "router mixed [0,1,2,2]",
                      lambda c: knobs_from_decision(
                          c, [0, 1, 2, 2], [0, 2, 0, 0], 1, 2, dev))
        torch.cuda.empty_cache()
    out = []
    for nm, v in rec.items():
        row = {"path": True}
        if nm in OFF_PATH:
            # no reference path probes it: the launches of its oracle
            row["path"] = False
            launches[nm] = probe_launches
        if launches[nm] == 0:
            fail(f"{nm} was never launched on the main path")
        src, repl = KERNELS[nm.split("[")[0]]
        out.append({"name": nm, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches[nm],
                    "max_abs_err": v["max_abs_err"], "ms": v["ms"],
                    "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                    "bound_by": v["bound_by"],
                    "library_ms": v["library_ms"], **row})
    print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
