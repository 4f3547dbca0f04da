"""The port's ``Config`` copy: same names, types and defaults as
``deneva_tpu.config.Config``; the same ``from_args`` parsing; and a raise
for every setting outside the ported slice."""

import dataclasses

import pytest

from deneva_tpu.config import Config as JConfig
from deneva_tpu_torch.config import Config, _coerce

SLICE = ["--epoch_batch=256", "--max_txn_in_flight=256"]
# the OCC comparator's pool: a partial pool
SWEEP = ["--cc_alg=OCC", "--epoch_batch=64", "--max_txn_in_flight=256"]


def test_fields_share_name_type_and_default():
    ref = {f.name: f for f in dataclasses.fields(JConfig)}
    for f in dataclasses.fields(Config):
        assert f.name in ref, f.name
        assert str(f.type) == str(ref[f.name].type), f.name
        assert f.default == ref[f.name].default, f.name


def test_from_args_parses_like_reference():
    args = SLICE + ["--zipf_theta=0.9", "--sim_full_row", "true",
                    "--synth-table-size=1024", "--seed=-4", "--backoff=off"]
    mine, ref = Config.from_args(args), JConfig.from_args(args)
    for f in dataclasses.fields(Config):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert _coerce("bool", "yes") is True
    with pytest.raises(ValueError):
        Config.from_args(["epoch_batch=4"])


# (flag, what it meets): a ROADMAP item (or None: an unknown field) it
# raises NotImplementedError for; ValueError: a pin of the reference,
# raised with its message; ADMIT: ported since (slice 11 admits
# part_cnt > 1 on one node, whose node_cnt > 1 still raises item 18)
ADMIT = "admitted"
RAISING = [
    ("--part_cnt=2", ADMIT),
    ("--elastic=true", 18),
    ("--ctrl=true", ValueError), ("--ctrl_dgcc=true", ValueError),
    ("--sim_full_row=true --tup_size=10", 11),
    ("--checkpoint_path=/dev/null", 17), ("--node_cnt=2", 18),
    ("--fault_drop_prob=0.1", None)]


@pytest.mark.parametrize("flag,item", RAISING, ids=[f for f, _ in RAISING])
def test_unsupported_flags_raise(flag, item):
    for base in (SLICE, SWEEP):
        args = base + flag.split()
        if item is ADMIT:
            mine, ref = Config.from_args(args), JConfig.from_args(args)
            for f in dataclasses.fields(Config):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
            with pytest.raises(NotImplementedError,
                               match="ROADMAP.md queue 1, item 18:"):
                Config.from_args(args + ["--node_cnt=2"])
        elif item is ValueError:
            msgs = []
            for cls in (Config, JConfig):
                with pytest.raises(ValueError) as e:
                    cls.from_args(args)
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1]
        else:
            match = "ROADMAP" if item is None \
                else f"ROADMAP.md queue 1, item {item}:"
            with pytest.raises(NotImplementedError, match=match):
                Config.from_args(args)


CTRL = ["--ctrl=true", "--metrics=true", "--escrow_order_free=false"]
# each pin of the control plane, raised with the reference's message
CTRL_PINS = [
    (["--ctrl=true"], "needs --metrics=true"),
    (["--ctrl=true", "--metrics=true"], "escrow ordering"),
    (CTRL + ["--mode=SIMPLE"], "degraded modes"),
    (CTRL + ["--cc_alg=MVCC"], "candidates"),
    (CTRL + ["--cc_alg=DGCC"], "candidates"),
    (CTRL + ["--ycsb_abort_mode=true"], "ycsb_abort_mode"),
    (CTRL + ["--audit=true", "--audit_mutate=occ-read-skip:1"],
     "audit_mutate"),
    (["--ctrl_dgcc=true"], "needs --ctrl=true"),
    (["--ctrl_lo=0.5", "--ctrl_hi=0.1"], "hysteresis band"),
    (["--ctrl_confirm=0"], "ctrl_confirm/ctrl_heal"),
    (["--ctrl_stale_s=0"], "ctrl_stale_s"),
    (["--ctrl_gshift=17"], "ctrl_gshift"),
    (["--ctrl_scale_max=-1"], "ctrl_scale_max")]


@pytest.mark.parametrize("flags,match", CTRL_PINS,
                         ids=[" ".join(f) for f, _ in CTRL_PINS])
def test_ctrl_pins_raise_like_reference(flags, match):
    msgs = []
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match=match) as e:
            cls.from_args(SWEEP + flags)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# flags of the slices ported since the raise list was first written
ADMITTED = [
    ["--cc_alg=OCC"], ["--cc_alg=NOCC"], ["--mode=NOCC"],
    ["--cc_alg=OCC", "--mode=NOCC"], ["--max_txn_in_flight=1024"],
    ["--cc_alg=OCC", "--conflict_exact=false", "--conflict_buckets=64",
     "--sweep_rounds=3", "--defer_rounds_max=0", "--escrow_sweep=false"],
    ["--cc_alg=NO_WAIT"], ["--cc_alg=WAIT_DIE"], ["--cc_alg=CALVIN"],
    ["--cc_alg=TIMESTAMP"], ["--cc_alg=MVCC"],
    ["--isolation_level=READ_COMMITTED"],
    ["--cc_alg=WAIT_DIE", "--isolation_level=NOLOCK"],
    ["--cc_alg=MVCC", "--watermark_buckets=64", "--mvcc_his_len=2"],
    ["--cc_alg=MAAT"], ["--cc_alg=MAAT", "--maat_peel_rounds=3"],
    ["--mode=SIMPLE"], ["--mode=QRY_ONLY", "--cc_alg=TPU_BATCH",
                        "--exec_subrounds=2"],
    ["--skew_method=HOT", "--data_perc=100", "--access_perc=0.9"],
    ["--key_order=true"], ["--txn_write_perc=0.5"],
    ["--index_struct=IDX_BTREE"], ["--sim_full_row=true", "--tup_size=8"],
    ["--workload=PPS", "--max_accesses=32"],
    ["--workload=TPCC", "--max_accesses=18", "--tpcc_order_index=true"],
    ["--cc_alg=DGCC"], ["--repair=true"],
    ["--repair=true", "--repair_rounds=0", "--cc_alg=MAAT"],
    ["--cc_alg=DGCC", "--dgcc_levels=1", "--workload=TPCC",
     "--max_accesses=18"],
    ["--repair=true", "--repair_rounds=8", "--cc_alg=NO_WAIT",
     "--isolation_level=NOLOCK"],
    ["--audit=true"], ["--metrics=true"],
    ["--audit=true", "--audit_cadence=1", "--metrics=true",
     "--metrics_cadence=4"],
    ["--audit=true", "--cc_alg=MVCC", "--audit_buckets=1024",
     "--audit_edges_max=64"],
    ["--audit=true", "--audit_mutate=occ-read-skip:48:8"],
    ["--audit=true", "--cc_alg=DGCC", "--workload=TPCC",
     "--max_accesses=18", "--epoch_batch=16384"],
    ["--metrics=true", "--workload=PPS", "--max_accesses=32"],
    ["--metrics=true", "--cc_alg=TPU_BATCH", "--epoch_batch=65536",
     "--max_txn_in_flight=65536"],
    ["--part_cnt=4"], ["--part_cnt=2", "--workload=TPCC", "--num_wh=4",
                       "--max_accesses=18"],
    ["--part_cnt=4", "--workload=PPS", "--max_accesses=32"],
    CTRL, CTRL + ["--ctrl_dgcc=true"], CTRL + ["--part_cnt=4",
                                               "--cc_alg=NO_WAIT"],
    CTRL + ["--ctrl_dgcc=true", "--cc_alg=DGCC", "--part_cnt=4",
            "--repair=false", "--audit=true", "--ctrl_gshift=0"],
    CTRL + ["--cc_alg=TPU_BATCH", "--ctrl_lo=0.1", "--ctrl_hi=0.3",
            "--ctrl_confirm=1", "--ctrl_cooldown=0", "--ctrl_heal=1",
            "--ctrl_stale_s=0.5", "--ctrl_scale_max=0"]]


@pytest.mark.parametrize("flags", ADMITTED)
def test_sweep_path_flags_are_admitted(flags):
    mine = Config.from_args(SWEEP + flags)
    ref = JConfig.from_args(SWEEP + flags)
    for f in dataclasses.fields(Config):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_reference_checks_still_apply():
    with pytest.raises(ValueError, match="power of two"):
        Config.from_args(["--epoch_batch=100", "--max_txn_in_flight=100"])
    with pytest.raises(ValueError, match="sum to 1"):
        Config.from_args(SLICE + ["--write_perc=0.7"])
    assert Config().replace(epoch_batch=16384).epoch_batch == 16384
    with pytest.raises(ValueError, match="power of two"):
        Config.from_args(SWEEP + ["--conflict_buckets=1000"])


def test_new_fields_and_the_isolation_check():
    cfg = Config()
    assert cfg.watermark_buckets == 1 << 20 and cfg.mvcc_his_len == 4
    assert JConfig().watermark_buckets == cfg.watermark_buckets
    for lvl in ("SERIALIZABLE", "READ_COMMITTED", "READ_UNCOMMITTED",
                "NOLOCK"):
        assert Config.from_args(SWEEP + [f"--isolation_level={lvl}"]
                                ).isolation_level == lvl
    with pytest.raises(ValueError, match="bad isolation_level"):
        Config.from_args(SWEEP + ["--isolation_level=SNAPSHOT"])
    with pytest.raises(ValueError, match="bad isolation_level"):
        JConfig.from_args(SWEEP + ["--isolation_level=SNAPSHOT"])


@pytest.mark.parametrize("alg,item", [("DGCC", 16)])
def test_maat_and_dgcc_still_raise(alg, item):
    """DGCC, once refused as ROADMAP.md ``item`` 16, is ported: it raises
    only where the reference raises, with its message, and the registry
    holds it as a chained backend without incidence views; MAAT is
    ported too (``test_slice4_backends_are_registered``)."""
    from deneva_tpu_torch.cc import get_backend
    bad = SWEEP + [f"--cc_alg={alg}", "--workload=PPS", "--max_accesses=32"]
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match="wired for YCSB and TPCC"):
            cls.from_args(bad)
    assert Config.from_args(SWEEP + [f"--cc_alg={alg}"]).dgcc_levels == 32
    be = get_backend(alg)
    assert be.chained and not be.forward and be.exempt_order_free
    assert be.views(Config()) == () and be.repair_rule is None


@pytest.mark.parametrize("flags,match", [
    (["--repair_rounds=9"], "repair_rounds must be in"),
    (["--repair_rounds=-1"], "repair_rounds must be in"),
    (["--dgcc_levels=0"], "dgcc_levels must be in"),
    (["--dgcc_levels=257"], "dgcc_levels must be in"),
    (["--repair=true", "--workload=PPS", "--max_accesses=32"],
     "PPS keeps retry-only"),
    (["--repair=true", "--cc_alg=CALVIN"], "six sweep backends"),
    (["--repair=true", "--cc_alg=TPU_BATCH"], "six sweep backends"),
    (["--repair=true", "--cc_alg=DGCC"], "six sweep backends"),
    (["--repair=true", "--mode=SIMPLE"], "degraded modes"),
    (["--cc_alg=DGCC", "--workload=PPS", "--max_accesses=32"],
     "DGCC's wave re-execution"),
    (["--repair=true", "--device_parts=2"], "multi-chip")])
def test_repair_and_dgcc_reference_checks_apply(flags, match):
    """The reference's repair and DGCC checks, with its messages."""
    msgs = []
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match=match) as e:
            cls.from_args(SWEEP + flags)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_repair_and_dgcc_fields_share_the_reference_defaults():
    for f in ("repair", "repair_rounds", "dgcc_levels"):
        assert getattr(Config(), f) == getattr(JConfig(), f), f
    args = SWEEP + ["--repair=true", "--repair_rounds=1"]
    assert Config.from_args(args).repair_rounds == 1
    for wl in (["--workload=YCSB"], ["--workload=TPCC", "--max_accesses=18"]):
        for alg in ("OCC", "DGCC"):
            extra = ["--repair=true", "--repair_rounds=2"] \
                if alg == "OCC" else []
            Config.from_args(SWEEP + wl + [f"--cc_alg={alg}"] + extra)


def test_slice4_backends_are_registered():
    from deneva_tpu_torch.cc import get_backend
    be = get_backend("MAAT")
    assert be.exempt_order_free and not be.chained
    assert be.views(Config()) == ("ro", "w")
    for alg in ("CALVIN", "TPU_BATCH"):
        be = get_backend(alg)
        assert be.chained and be.forward and be.validate is not None
    assert Config().exec_subrounds == JConfig().exec_subrounds == 4
    assert Config().maat_peel_rounds == JConfig().maat_peel_rounds == 16


@pytest.mark.parametrize("flags,match", [
    (["--skew_method=HOT", "--data_perc=0"], "data_perc"),
    (["--skew_method=HOT", "--data_perc=4096",
      "--synth_table_size=4096"], "data_perc"),
    (["--skew_method=HOT", "--access_perc=1.5"], "access_perc"),
    (["--index_struct=IDX_TRIE"], "bad index_struct"),
    (["--skew_method=UNIFORM"], "bad skew_method")])
def test_slice4_reference_checks_apply(flags, match):
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match=match):
            cls.from_args(SWEEP + flags)


TPCC = ["--workload=TPCC", "--num_wh=2", "--cust_per_dist=120",
        "--max_items=200", "--max_items_per_txn=5", "--max_accesses=8",
        "--epoch_batch=64", "--max_txn_in_flight=256"]


@pytest.mark.parametrize("alg", ["TPU_BATCH", "CALVIN", "OCC", "NO_WAIT",
                                 "WAIT_DIE", "TIMESTAMP", "MVCC", "MAAT"])
def test_tpcc_is_admitted_under_every_algorithm(alg):
    mine = Config.from_args(TPCC + [f"--cc_alg={alg}"])
    ref = JConfig.from_args(TPCC + [f"--cc_alg={alg}"])
    for f in dataclasses.fields(Config):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("flags,match", [
    (["--max_accesses=7"], "max_accesses must cover"),
    (["--ycsb_abort_mode=true"], "YCSB-only"),
    (["--workload=YCSB", "--max_accesses=10", "--tpcc_order_index=true"],
     "TPC-C only"),
    (["--tpcc_order_index=true", "--num_wh=200"], "order_index_key")])
def test_tpcc_reference_checks_apply(flags, match):
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match=match):
            cls.from_args(TPCC + flags)


def test_tpcc_simulation_prints_the_per_type_families(capsys):
    from deneva_tpu_torch.engine.driver import run_simulation
    cfg = Config.from_args(TPCC + ["--cc_alg=TPU_BATCH", "--warmup_secs=0",
                                   "--done_secs=0.3", "--prog_timer_secs=0"])
    st = run_simulation(cfg, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[summary]") and line == st.summary_line()
    for fam in ("tpcc_payment", "tpcc_new_order"):
        for kind in ("commit", "abort"):
            assert f"{fam}_{kind}_cnt=" in line
        assert f"{fam}_latency" in line
    f = st.summary_fields()
    assert f["tpcc_payment_commit_cnt"] > 0
    assert f["tpcc_new_order_commit_cnt"] > 0
    assert f["total_txn_abort_cnt"] == 0


@pytest.mark.parametrize("flags,match", [
    (["--audit=true", "--workload=PPS", "--max_accesses=32"],
     "wired for YCSB and TPCC"),
    (["--audit=true", "--epoch_batch=32768", "--max_txn_in_flight=32768"],
     "epoch_batch <= 16384"),
    (["--audit_mutate=occ-read-skip:4"], "needs --audit=true"),
    (["--audit=true", "--cc_alg=CALVIN", "--audit_mutate=occ-read-skip:4"],
     "set cc_alg=OCC"),
    (["--audit=true", "--audit_mutate=occ-read-skip"], "must be"),
    (["--audit=true", "--audit_mutate=occ-read-skip:x"],
     "must be integers"),
    (["--audit=true", "--audit_mutate=occ-read-skip:3:0"],
     "COUNT >= 1"),
    (["--audit=true", "--audit_mutate=lost-write:3"], "must be"),
    (["--audit_cadence=0"], "audit_cadence must be >= 1"),
    (["--metrics_cadence=0"], "metrics_cadence must be >= 1"),
    (["--audit_edges_max=63"], "audit_edges_max must be >= 64"),
    (["--audit_buckets=512"], "power of two >= 1024"),
    (["--audit_buckets=3000"], "power of two >= 1024"),
    (["--audit=true", "--mode=SIMPLE"], "degraded modes"),
    (["--audit=true", "--device_parts=2"], "multi-chip"),
    (["--metrics=true", "--device_parts=2"], "multi-chip")])
def test_metrics_and_audit_reference_checks_apply(flags, match):
    """The reference's metrics and audit checks, with its messages."""
    msgs = []
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match=match) as e:
            cls.from_args(SWEEP + flags)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_audit_mutate_spec_parses_like_reference():
    for spec in ("occ-read-skip:48:8", "occ-read-skip:0", ""):
        args = SWEEP + (["--audit=true", f"--audit_mutate={spec}"]
                        if spec else [])
        assert Config.from_args(args).audit_mutate_spec() \
            == JConfig.from_args(args).audit_mutate_spec()
    assert Config.from_args(SWEEP + [
        "--audit=true", "--audit_mutate=occ-read-skip:48:8"
    ]).audit_mutate_spec() == ("occ-read-skip", 48, 8)
