"""Runtime configuration of the PyTorch port.

The same flat, frozen record as ``deneva_tpu.config.Config``, cut to the
fields the ported slice reads or guards.  Every field keeps the
reference's name, type and default, so one ``--flag=value`` list drives
both packages.

The port runs YCSB, TPC-C (Payment + NewOrder, with or without the
dynamic ORDER index of ``tpcc_order_index``) and PPS on one node and
one device, over a full or a partial pool; ``part_cnt > 1`` stripes the
keyspace as the reference's cluster does and the process holds node
``node_id``'s partition (keys = node_id mod part_cnt; every other key
resolves to a table's trash row).  YCSB takes zipfian or
HOT keys, ``key_order``, any ``txn_write_perc`` and either index;
``CC_ALG=TPU_BATCH`` and ``CALVIN`` run it through the single-pass
forwarding executor, and TPC-C and PPS, whose writes read, through the
chained executor.  ``OCC``, ``NO_WAIT`` and ``WAIT_DIE`` (at all four isolation
levels), ``TIMESTAMP``, ``MVCC`` and ``MAAT`` run both through the sweep
path; ``NOCC`` (or ``mode=NOCC``) is the oracle; ``mode=SIMPLE`` and
``QRY_ONLY`` (validation, no execution) apply under any of them.
``repair`` (with ``repair_rounds``) salvages the six sweep backends'
losers within the epoch, and ``DGCC`` (with ``dgcc_levels``) runs the
dependency-graph wavefront through the chained executor, both on YCSB
and TPC-C.  ``metrics`` adds the per-partition conflict density to the
device counters, and ``audit`` (YCSB and TPC-C) the isolation audit
plane's per-epoch dependency observations and stamp tables, with the
seeded ``audit_mutate`` fault under OCC.  ``ctrl`` (with
``ctrl_dgcc``) routes each epoch through the contention router: the
controller's per-partition backend among NO_WAIT / OCC / TPU_BATCH
(/ DGCC), key coarsening, repair cap and audit cadence.
``device_parts > 1`` runs
every workload and backend over a mesh of that many shards (tables
owner-major, `parallel` and `workloads.mc`), with ``mc_plan_capacity``
sizing the sharded forwarding plan; the reference's checks and its
``device_parts == 1`` pins (metrics, audit, repair, the ORDER index,
elastic, ctrl) raise as they do there.  ``node_cnt > 1`` and
``elastic`` (the cluster runtime) are not ported.  A flag that would leave
those slices raises in :meth:`Config.validate` and names the ROADMAP.md
item that brings it; a flag the port does not know at all raises in
:meth:`Config.from_args`.  Nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Any


class CCAlg(str, enum.Enum):
    """Concurrency-control algorithm (reference `config.h:101`)."""

    NO_WAIT = "NO_WAIT"
    WAIT_DIE = "WAIT_DIE"
    TIMESTAMP = "TIMESTAMP"
    MVCC = "MVCC"
    OCC = "OCC"
    MAAT = "MAAT"
    CALVIN = "CALVIN"
    TPU_BATCH = "TPU_BATCH"
    DGCC = "DGCC"
    NOCC = "NOCC"


class WorkloadKind(str, enum.Enum):
    """Benchmark selection (reference `config.h` WORKLOAD)."""

    YCSB = "YCSB"
    TPCC = "TPCC"
    PPS = "PPS"
    TEST = "TEST"


class Mode(str, enum.Enum):
    """Degraded oracle modes (reference `config.h:276-281`)."""

    NORMAL = "NORMAL"
    SIMPLE = "SIMPLE"
    NOCC = "NOCC"
    QRY_ONLY = "QRY_ONLY"


@dataclass(frozen=True)
class Config:
    """One flat, frozen config record (the slice's fields)."""

    # ---- topology ----
    node_id: int = 0
    node_cnt: int = 1              # server nodes (one: the cluster
    #                                runtime is not ported)
    part_cnt: int = 1              # keyspace partitions; node 0 stores
    #                                the keys = node_id (mod part_cnt)
    device_parts: int = 1          # keyspace partitions across the devices
    #                                of a mesh: tables owner-major, the
    #                                executors run once per shard
    #                                (parallel/, workloads/mc.py)

    # ---- workload ----
    workload: WorkloadKind = WorkloadKind.YCSB
    cc_alg: CCAlg = CCAlg.TPU_BATCH
    mode: Mode = Mode.NORMAL
    isolation_level: str = "SERIALIZABLE"

    # ---- YCSB (reference config.h:150-176) ----
    synth_table_size: int = 2097152 * 8   # 16M rows/node, paper default
    req_per_query: int = 10
    zipf_theta: float = 0.6
    read_perc: float = 0.5
    write_perc: float = 0.5        # per-tuple write prob (TUP_WRITE_PERC)
    txn_write_perc: float = 1.0
    skew_method: str = "ZIPF"      # ZIPF | HOT
    data_perc: int = 100
    access_perc: float = 0.03
    key_order: bool = False
    tup_size: int = 100            # bytes per field payload
    field_per_tuple: int = 10
    sim_full_row: bool = False     # SIM_FULL_ROW: uint8 payload columns
    ycsb_abort_mode: bool = False  # sentinel forced-abort check (config.h:103)

    # ---- TPCC (reference config.h:178-209) ----
    num_wh: int = 4
    perc_payment: float = 0.5
    wh_update: bool = True
    mpr_neworder: float = 0.01     # remote-warehouse item probability
    tpcc_full_schema: bool = False
    cust_per_dist: int = 3000      # CUST_PER_DIST_NORM (config.h:188)
    tpcc_by_last_index: bool = True  # resolve payment-by-lastname through
    #                                  the CUSTOMER_LAST nonunique index
    #                                  (hash probe + postings walk, like
    #                                  index_hash.cpp:68-100); False =
    #                                  closed-form arithmetic bypass
    max_items: int = 100000        # MAX_ITEMS_NORM (config.h:187)
    max_items_per_txn: int = 15    # MAX_ITEMS_PER_TXN (config.h:189)
    insert_table_cap: int = 1 << 17  # ring capacity of HISTORY/ORDER/... tables
    #                                  (ORDER-LINE gets cap*max_items_per_txn)

    # ---- PPS (reference config.h:226-242) ----
    pps_table_size: int = 100000
    pps_parts_cnt: int = 10000       # MAX_PPS_PART_KEY
    pps_products_cnt: int = 1000     # MAX_PPS_PRODUCT_KEY
    pps_suppliers_cnt: int = 1000    # MAX_PPS_SUPPLIER_KEY
    pps_parts_per: int = 10          # MAX_PPS_PART_PER_PRODUCT
    perc_getparts: float = 0.0
    perc_getproducts: float = 0.0
    perc_getsuppliers: float = 0.0
    perc_getpartbyproduct: float = 0.34
    perc_getpartbysupplier: float = 0.0
    perc_orderproduct: float = 0.33
    perc_updateproductpart: float = 0.33
    perc_updatepart: float = 0.0

    # ---- client / pool ----
    max_txn_in_flight: int = 10000
    backoff: bool = True

    # ---- run windows ----
    warmup_secs: float = 2.0
    done_secs: float = 5.0
    prog_timer_secs: float = 10.0
    chunk_target_secs: float = 1.0

    # ---- epoch engine ----
    epoch_batch: int = 2048
    conflict_buckets: int = 8192   # hashed key-bucket width of incidence matrices
    conflict_exact: bool = True    # dual-hash AND to squeeze out false conflicts
    watermark_buckets: int = 1 << 20  # hashed width of the T/O family's
    #                                   cross-epoch rts/wts tables
    max_accesses: int = 16
    defer_rounds_max: int = 8      # defer budget before forced abort
    sweep_rounds: int = 24         # serialization-sweep fixpoint iterations
    maat_peel_rounds: int = 16     # MAAT cycle-peel iterations per epoch
    mc_plan_capacity: float = 2.0  # sharded plan under device_parts > 1:
    #                                per-(slice, owner) block = factor *
    #                                N/D^2 lanes (0 = every shard plans the
    #                                full batch)
    tpcc_order_index: bool = False  # maintain the dynamic ordered ORDER
    #                                 index (index_btree insert analogue;
    #                                 one merge sort per epoch)
    exec_subrounds: int = 4        # chained-execution levels per epoch (CALVIN/TPU_BATCH)
    dgcc_levels: int = 32          # DGCC wave budget: relaxation-round cap
    #                                and max wavefront depth per epoch;
    #                                deeper closures defer (cc/dgcc.py)
    mvcc_his_len: int = 4          # in-state version history depth (HIS_RECYCLE_LEN analogue)
    escrow_order_free: bool = True  # honor workload order_free declarations
    escrow_sweep: bool = True      # ... in the sweep backends too
    repair: bool = False           # transaction repair (engine/repair.py):
    #                                losers of a sweep backend re-validate
    #                                and re-execute as in-epoch sub-rounds
    repair_rounds: int = 2         # repair sub-rounds per epoch; 0 arms
    #                                the machinery and salvages nothing

    # ---- storage ----
    index_struct: str = "IDX_HASH"

    # ---- metrics and audit planes (the single-node engine's halves) ----
    metrics: bool = False          # per-partition conflict density into
    #                                the device counters (cc/base.
    #                                conflict_density, K13b)
    metrics_cadence: int = 1       # epochs between the cluster bus's
    #                                frames (validated; one node has no bus)
    audit: bool = False            # per-epoch dependency observations of
    #                                the committed set and the audit stamp
    #                                tables (cc/base.audit_observe)
    audit_cadence: int = 8         # epochs between audited epochs
    audit_edges_max: int = 4096    # per-epoch exported-edge cap; overflow
    #                                counts as audit_drop_cnt
    audit_buckets: int = 1 << 16   # hashed width of the audit stamp tables
    audit_mutate: str = ""         # seeded fault "occ-read-skip:START
    #                                [:COUNT]": OCC's read check dropped on
    #                                epochs [START, START + COUNT)

    # ---- the control plane (runtime/controller.py, cc/router.py) ----
    ctrl: bool = False             # the contention router: per-partition
    #                                CC backend, key coarsening, repair
    #                                cap and audit cadence, decided at
    #                                chunk boundaries
    ctrl_lo: float = 0.02          # density below which a partition is
    #                                SPARSE (lanes per batch row)
    ctrl_hi: float = 0.20          # density above which it is HOT
    ctrl_confirm: int = 2          # ticks a new class must persist
    ctrl_cooldown: int = 4         # ticks a moved knob holds
    ctrl_stale_s: float = 2.0      # boundary gap that trips the governor
    ctrl_heal: int = 3             # healthy ticks before it re-engages
    ctrl_gshift: int = 2           # key bits SPARSE partitions coarsen
    ctrl_scale_max: int = 4        # admission quota-scale steps (cluster)
    ctrl_dgcc: bool = False        # HOT partitions route to DGCC

    # ---- planes the port does not carry yet (validate rejects them) ----
    elastic: bool = False
    checkpoint_path: str = ""
    resume: bool = False

    seed: int = 0

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw).validate()

    def audit_mutate_spec(self) -> tuple[str, int, int] | None:
        """Parse audit_mutate 'KIND:START[:COUNT]' into (kind, start,
        count); None when unset.  COUNT defaults to 1
        (``deneva_tpu/config.py:979``)."""
        if not self.audit_mutate:
            return None
        parts = self.audit_mutate.split(":")
        if len(parts) not in (2, 3) or parts[0] != "occ-read-skip":
            raise ValueError(
                f"config: audit_mutate {self.audit_mutate!r} must be "
                "'occ-read-skip:START_EPOCH[:COUNT]'")
        try:
            start = int(parts[1])
            count = int(parts[2]) if len(parts) == 3 else 1
        except ValueError:
            raise ValueError(
                f"config: audit_mutate {self.audit_mutate!r}: START/"
                "COUNT must be integers")
        _check(start >= 0 and count >= 1,
               "audit_mutate needs START >= 0 and COUNT >= 1")
        return parts[0], start, count

    def validate(self) -> "Config":
        # the reference's own checks on these fields
        _check(self.node_cnt >= 1 and self.part_cnt >= 1,
               "node_cnt/part_cnt must be >= 1")
        _check(self.device_parts >= 1, "device_parts must be >= 1")
        if self.device_parts > 1:
            # deneva_tpu/config.py:1036-1065, with its messages
            _check(self.part_cnt == 1,
                   "device_parts (multi-chip) and part_cnt (multi-process) "
                   "partitioning do not compose yet")
            if self.mc_plan_capacity > 0:
                _check(self.max_accesses <= 128,
                       "sharded multi-chip planning needs max_accesses "
                       "<= 128: a txn's own lanes must fit one capacity "
                       "block (the 128-lane tile floor of mc_pair_cap) "
                       "or it could defer forever — raise "
                       "mc_plan_capacity=0 to use the replicated plan")
            # ownership anchors deal evenly over the mesh blocks
            # (storage.table.to_mc_layout)
            D = self.device_parts
            if self.workload == WorkloadKind.YCSB:
                _check(self.synth_table_size % D == 0,
                       "synth_table_size must divide over device_parts")
            elif self.workload == WorkloadKind.TPCC:
                _check(self.num_wh % D == 0,
                       "num_wh must divide over device_parts "
                       "(warehouses are the ownership anchor)")
                _check(self.insert_table_cap % D == 0,
                       "insert_table_cap must divide over device_parts")
            elif self.workload == WorkloadKind.PPS:
                for nm, n in (("pps_parts_cnt", self.pps_parts_cnt),
                              ("pps_products_cnt", self.pps_products_cnt),
                              ("pps_suppliers_cnt", self.pps_suppliers_cnt)):
                    _check(n % D == 0,
                           f"{nm} must divide over device_parts")
        _check(self.epoch_batch > 0
               and (self.epoch_batch & (self.epoch_batch - 1)) == 0,
               "epoch_batch must be a power of two (tiling discipline)")
        _check(self.conflict_buckets > 0 and (self.conflict_buckets
                                              & (self.conflict_buckets - 1)) == 0,
               "conflict_buckets must be a power of two (bucket_hash masks)")
        if self.workload == WorkloadKind.YCSB:
            _check(self.max_accesses >= self.req_per_query,
                   "max_accesses must cover req_per_query")
            _check(abs(self.read_perc + self.write_perc - 1.0) < 1e-6,
                   "read_perc + write_perc must sum to 1")
            _check(self.skew_method in ("ZIPF", "HOT"),
                   f"bad skew_method {self.skew_method!r}")
            _check(0.0 <= self.txn_write_perc <= 1.0,
                   "txn_write_perc must be in [0, 1]")
            if self.skew_method == "HOT":
                _check(1 <= self.data_perc < self.synth_table_size,
                       "HOT skew: data_perc (hot-set key count) must be in "
                       "[1, synth_table_size)")
                _check(0.0 <= self.access_perc <= 1.0,
                       "access_perc must be in [0, 1]")
        else:
            _check(not self.ycsb_abort_mode,
                   "ycsb_abort_mode is YCSB-only (the sentinel key would "
                   "force-abort hot TPCC/PPS rows)")
        if self.workload == WorkloadKind.TPCC:
            _check(self.max_accesses >= 3 + self.max_items_per_txn,
                   "TPCC max_accesses must cover wh+dist+cust+items "
                   f"(>= {3 + self.max_items_per_txn})")
        if self.tpcc_order_index:
            _check(self.workload == WorkloadKind.TPCC,
                   "tpcc_order_index is TPC-C only")
            _check(self.device_parts == 1,
                   "tpcc_order_index does not compose with multi-chip "
                   "execution yet")
            _check(self.num_wh * 10 < 1024
                   and self.insert_table_cap + 3001 < (1 << 21),
                   "order_index_key packs district * 2^21 + o_id into "
                   "int32: needs num_wh <= 102 and insert_table_cap + "
                   "3001 < 2^21")
        if self.workload == WorkloadKind.PPS:
            mix = (self.perc_getparts + self.perc_getproducts
                   + self.perc_getsuppliers + self.perc_getpartbyproduct
                   + self.perc_getpartbysupplier + self.perc_orderproduct
                   + self.perc_updateproductpart + self.perc_updatepart)
            _check(abs(mix - 1.0) < 1e-6, "PPS txn mix must sum to 1")
            _check(self.max_accesses >= 1 + 2 * self.pps_parts_per,
                   "PPS max_accesses must cover anchor + mapping + parts "
                   f"(>= {1 + 2 * self.pps_parts_per})")
        _check(self.isolation_level in (
            "SERIALIZABLE", "READ_COMMITTED", "READ_UNCOMMITTED", "NOLOCK"),
            f"bad isolation_level {self.isolation_level!r}")
        _check(self.index_struct in ("IDX_HASH", "IDX_BTREE"),
               f"bad index_struct {self.index_struct!r}")
        # transaction repair and DGCC (deneva_tpu/config.py:1401-1439; the
        # cluster-only checks on node_cnt and dist_protocol have no field
        # here: the port runs one node)
        _check(self.repair_rounds >= 0 and self.repair_rounds <= 8,
               "repair_rounds must be in [0, 8] (each round is a fused "
               "re-validation + re-execution pass inside the epoch jit)")
        if self.repair:
            _check(self.cc_alg in (CCAlg.NO_WAIT, CCAlg.WAIT_DIE,
                                   CCAlg.OCC, CCAlg.TIMESTAMP, CCAlg.MVCC,
                                   CCAlg.MAAT),
                   "repair applies to the six sweep backends only "
                   "(CALVIN/TPU_BATCH never abort and DGCC defers its "
                   "over-deep closures — there is nothing to salvage; "
                   "NOCC has no conflicts)")
            _check(self.mode == Mode.NORMAL,
                   "repair re-executes committed state; degraded modes "
                   "(SIMPLE/NOCC/QRY_ONLY) have no abort path to salvage")
            _check(self.device_parts == 1,
                   "repair sub-rounds do not compose with multi-chip "
                   "execution yet (the frontier matvec and the chained "
                   "re-execution are single-device)")
            _check(self.workload in (WorkloadKind.YCSB, WorkloadKind.TPCC),
                   "repair re-execution closures are wired for YCSB and "
                   "TPCC (workloads declare re_execute); PPS keeps "
                   "retry-only semantics")
        # metrics and audit (deneva_tpu/config.py:1341-1400; the
        # cluster-only checks on node_cnt and dist_protocol have no field
        # here: the port runs one node)
        _check(self.metrics_cadence >= 1,
               "metrics_cadence must be >= 1 (1 frames every epoch)")
        if self.metrics:
            _check(self.device_parts == 1,
                   "the metrics bus's conflict-density fold does not "
                   "compose with multi-chip execution yet (sharded "
                   "tables have no single bucket space to fold)")
        _check(self.audit_cadence >= 1,
               "audit_cadence must be >= 1 (1 exports every epoch)")
        _check(self.audit_edges_max >= 64,
               "audit_edges_max must be >= 64")
        _check(self.audit_buckets >= 1024
               and (self.audit_buckets & (self.audit_buckets - 1)) == 0,
               "audit_buckets must be a power of two >= 1024")
        if self.audit:
            _check(self.mode == Mode.NORMAL,
                   "audit certifies executed state; degraded modes "
                   "(SIMPLE/NOCC/QRY_ONLY) execute nothing to certify")
            _check(self.device_parts == 1,
                   "audit observations do not compose with multi-chip "
                   "execution yet (the edge derivation is single-device)")
            _check(self.workload in (WorkloadKind.YCSB, WorkloadKind.TPCC),
                   "audit is wired for YCSB and TPCC (the workload load "
                   "path installs the audit stamp tables)")
            _check(self.epoch_batch <= 16384,
                   "audit needs epoch_batch <= 16384: exported edges "
                   "pack (kind, src, dst) merged-batch ranks into 14-bit "
                   "fields of one int32")
        else:
            _check(not self.audit_mutate,
                   "audit_mutate needs --audit=true (the certifier must "
                   "be armed to catch the mutation)")
        if self.audit_mutate:
            self.audit_mutate_spec()    # raises on a malformed spec
            _check(self.cc_alg == CCAlg.OCC,
                   "audit_mutate 'occ-read-skip' weakens OCC's "
                   "read-set-vs-winner-write-set check; set cc_alg=OCC")
        _check(1 <= self.dgcc_levels <= 256,
               "dgcc_levels must be in [1, 256] (wave budget per epoch; "
               "each relaxation round is two segmented scans inside the "
               "epoch jit)")
        if self.cc_alg == CCAlg.DGCC:
            _check(self.workload in (WorkloadKind.YCSB, WorkloadKind.TPCC),
                   "DGCC's wave re-execution closures are wired for YCSB "
                   "and TPCC (workloads declare chained execution; PPS "
                   "keeps the sweep backends)")
        # the reference's device_parts == 1 pin of elastic, refused in
        # _NOT_PORTED (deneva_tpu/config.py:1214): its message first
        if self.elastic:
            _check(self.device_parts == 1,
                   "elastic (process-level) and device_parts (chip-level) "
                   "repartitioning do not compose yet")
        # the control plane (deneva_tpu/config.py:1446-1494, the same
        # messages in the same order; the cluster's admission pin has no
        # field here: the port runs one node)
        _check(0.0 <= self.ctrl_lo < self.ctrl_hi,
               "ctrl hysteresis band needs 0 <= ctrl_lo < ctrl_hi")
        _check(self.ctrl_confirm >= 1 and self.ctrl_cooldown >= 0
               and self.ctrl_heal >= 1,
               "ctrl_confirm/ctrl_heal must be >= 1, ctrl_cooldown >= 0")
        _check(self.ctrl_stale_s > 0, "ctrl_stale_s must be > 0")
        _check(0 <= self.ctrl_gshift <= 16,
               "ctrl_gshift must be in [0, 16] (key bits to coarsen)")
        _check(0 <= self.ctrl_scale_max <= 16,
               "ctrl_scale_max must be in [0, 16] quota-scale steps")
        if self.ctrl:
            _check(self.metrics,
                   "ctrl consumes the conflict-density signal: needs "
                   "--metrics=true (the PR 14 observability plane)")
            _check(self.mode == Mode.NORMAL,
                   "ctrl adapts executed-state knobs; degraded modes "
                   "(SIMPLE/NOCC/QRY_ONLY) have nothing to adapt")
            cands = (CCAlg.NO_WAIT, CCAlg.OCC, CCAlg.TPU_BATCH) \
                + ((CCAlg.DGCC,) if self.ctrl_dgcc else ())
            _check(self.cc_alg in cands,
                   "ctrl routes between NO_WAIT/OCC/TPU_BATCH (plus "
                   "DGCC when --ctrl_dgcc=true); the static cc_alg must "
                   "be one of the candidates (it is the governor's "
                   "fail-safe assignment)")
            _check(self.device_parts == 1,
                   "the ctrl router's branched epoch program is "
                   "single-device (multi-chip plans are built per-shard "
                   "inside shard_map)")
            _check(not self.ycsb_abort_mode,
                   "ctrl does not compose with the ycsb_abort_mode "
                   "sentinel (the forced-abort mask is backend-path "
                   "specific)")
            _check(not self.audit_mutate,
                   "ctrl does not compose with audit_mutate (the "
                   "seeded fault targets the static OCC path)")
            _check(not self.escrow_order_free,
                   "ctrl does not compose with escrow ordering "
                   "exemptions yet (the router's cross-backend batch "
                   "carries one shared conflict derivation)")
        if self.ctrl_dgcc:
            _check(self.ctrl,
                   "ctrl_dgcc arms the router's fourth (DGCC) class: "
                   "needs --ctrl=true")
        # the slice the port runs so far
        for cond, what, item in _NOT_PORTED:
            if cond(self):
                raise NotImplementedError(
                    f"config: {what} is not ported to deneva_tpu_torch yet "
                    f"(ROADMAP.md queue 1, {item})")
        _check(-2**31 <= self.seed < 2**31,
               "seed must fit int32 (the raw threefry key is [0, seed])")
        return self

    # -- CLI bridge -----------------------------------------------------
    @classmethod
    def from_args(cls, argv: list[str]) -> "Config":
        """Parse ``--field=value`` / ``--field value`` pairs."""
        kw: dict[str, Any] = {}
        i = 0
        fields = {f.name: f for f in dataclasses.fields(cls)}
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("--"):
                raise ValueError(f"unrecognized argument {arg!r}")
            if "=" in arg:
                name, val = arg[2:].split("=", 1)
            else:
                if i + 1 >= len(argv):
                    raise ValueError(f"flag {arg!r} is missing a value")
                name, val = arg[2:], argv[i + 1]
                i += 1
            name = name.replace("-", "_")
            if name not in fields:
                raise NotImplementedError(
                    f"config field {name!r} is not in deneva_tpu_torch yet "
                    "(ROADMAP.md queue 1, slices 2-5)")
            kw[name] = _coerce(fields[name].type, val)
            i += 1
        return cls(**kw).validate()


# (predicate, what, ROADMAP item) for every setting outside the slices
_NOT_PORTED = (
    (lambda c: c.node_cnt > 1,
     "node_cnt > 1", "item 18: cluster runtime"),
    (lambda c: c.elastic, "elastic", "item 18: cluster runtime"),
    (lambda c: bool(c.checkpoint_path) or c.resume,
     "checkpoint_path/resume", "item 17: checkpoint"),
    (lambda c: c.sim_full_row and c.tup_size % 4 != 0,
     "sim_full_row with tup_size % 4 != 0", "item 11: YCSB options"),
)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"config: {msg}")


def _coerce(typ: Any, val: str) -> Any:
    t = str(typ)
    if "CCAlg" in t:
        return CCAlg(val)
    if "WorkloadKind" in t:
        return WorkloadKind(val)
    if "Mode" in t:
        return Mode(val)
    if "bool" in t:
        low = val.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"invalid boolean value {val!r}")
    if "int" in t:
        return int(val)
    if "float" in t:
        return float(val)
    if "tuple" in t:
        return tuple(int(x) for x in val.strip("()").split(",") if x)
    return val
