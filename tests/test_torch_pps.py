"""Port parity of PPS (``deneva_tpu_torch.workloads.pps``) against
``deneva_tpu.workloads.pps`` on the CPU, exactly, at the sizes of
``tests/test_pps.py`` (500 parts, 100 products, 100 suppliers, 4 parts
per product, 64 txns per epoch), with ``max_accesses=16``:

* ``Config.from_args`` with PPS flags parses like the reference's and
  refuses what it refuses;
* the loader: every column of the five tables;
* ``generate`` (the plain version of K20): all four query fields bit for
  bit against ``jax.random``, under the default mix, a mix of all eight
  types, and key spans above 2^16 (randint's wrapping fold);
* ``plan``: every array of the RW-set, the recon gather included;
* whole epochs leaf by leaf under all nine backends (TPU_BATCH, CALVIN,
  NO_WAIT, WAIT_DIE, OCC, TIMESTAMP, MVCC, MAAT, NOCC), escrow on and
  off for TPU_BATCH / CALVIN;
* the accounting invariant on the port alone: PART_AMOUNT moves by
  exactly -parts_per per committed ORDERPRODUCT and +100 per committed
  UPDATEPART.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_tpcc import assert_same_db
from test_torch_tpcc_epochs import assert_same_state

from deneva_tpu.config import Config as JConfig
from deneva_tpu.engine.step import Engine as JEngine
from deneva_tpu.workloads import get_workload as j_workload
from deneva_tpu_torch import convert
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.step import Engine
from deneva_tpu_torch.ops import prng
from deneva_tpu_torch.workloads import get_workload
from deneva_tpu_torch.workloads.pps import (ORDERPRODUCT, UPDATEPART,
                                            PPSQuery)

BASE = dict(pps_parts_cnt=500, pps_products_cnt=100, pps_suppliers_cnt=100,
            pps_parts_per=4, max_accesses=16, epoch_batch=64,
            conflict_buckets=1024, max_txn_in_flight=256)
MIX8 = {f"perc_{t}": 0.125 for t in (
    "getparts", "getproducts", "getsuppliers", "getpartbyproduct",
    "getpartbysupplier", "orderproduct", "updateproductpart", "updatepart")}
FIELDS = [f.name for f in dataclasses.fields(PPSQuery)]
EPOCHS = 5


def pps_args(**kw) -> list[str]:
    d = {**BASE, **kw}
    return ["--workload=PPS"] + [f"--{k}={v}" for k, v in d.items()]


def both_workloads(**kw):
    args = pps_args(**kw)
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    return j_workload(jcfg), get_workload(tcfg, device="cpu"), tcfg


@pytest.mark.parametrize("flags", [
    ["--workload=PPS", "--max_accesses=32"],
    pps_args(),
    pps_args(**MIX8, cc_alg="CALVIN", exec_subrounds=2),
    ["--workload=PPS", "--max_accesses=21", "--pps_parts_cnt=70000",
     "--pps_table_size=5"]])
def test_config_parses_like_reference(flags):
    mine, ref = Config.from_args(flags), JConfig.from_args(flags)
    for f in dataclasses.fields(Config):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("flags", [
    ["--workload=PPS"],                                  # 16 < 1 + 2*10
    ["--workload=PPS", "--max_accesses=32", "--perc_updatepart=0.5"]])
def test_config_refuses_like_reference(flags):
    with pytest.raises(ValueError, match="PPS"):
        JConfig.from_args(flags)
    with pytest.raises(ValueError, match="PPS"):
        Config.from_args(flags)


@pytest.mark.parametrize("kw", [{}, dict(pps_parts_per=7, max_accesses=16,
                                         pps_suppliers_cnt=30)])
def test_load_matches_reference(kw):
    jwl, twl, _ = both_workloads(**kw)
    assert_same_db(jax.device_get(jwl.load()), twl.load())


@pytest.mark.parametrize("kw,n", [
    ({}, 64), ({}, 4097), (MIX8, 1000),
    (dict(pps_parts_cnt=100003, pps_products_cnt=65537,
          pps_suppliers_cnt=3), 2000)])
def test_generate_matches_reference(kw, n):
    jwl, twl, _ = both_workloads(**kw)
    for seed in (0, 9):
        jq = jax.device_get(jwl.generate(jax.random.PRNGKey(seed), n))
        tq = twl.generate(prng.key_from_seed(seed, "cpu"), n)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                          np.asarray(getattr(jq, f)),
                                          err_msg=f)
    if kw is MIX8:
        assert len(np.unique(np.asarray(jq.txn_type))) == 8


@pytest.mark.parametrize("kw", [
    {}, MIX8, dict(MIX8, pps_suppliers_cnt=300, pps_products_cnt=50),
    dict(MIX8, pps_suppliers_cnt=50, pps_products_cnt=300)])
def test_plan_matches_reference(kw):
    jwl, twl, _ = both_workloads(**kw)
    jdb, tdb = jwl.load(), twl.load()
    jq = jwl.generate(jax.random.PRNGKey(3), 256)
    tq = twl.generate(prng.key_from_seed(3, "cpu"), 256)
    jp, tp = jax.device_get(jwl.plan(jdb, jq)), twl.plan(tdb, tq)
    assert sorted(jp) == sorted(tp)
    for k, want in jp.items():
        have = tp[k].numpy()
        assert have.dtype == np.asarray(want).dtype, k
        np.testing.assert_array_equal(have, want, err_msg=k)


CASES = [
    ("TPU_BATCH", {}), ("CALVIN", {}), ("NO_WAIT", {}), ("WAIT_DIE", {}),
    ("OCC", {}), ("TIMESTAMP", {}), ("MVCC", {}), ("MAAT", {}),
    ("NOCC", {}),
    ("TPU_BATCH", dict(escrow_order_free=False)),
    ("CALVIN", dict(escrow_order_free=False)),
    ("TPU_BATCH", MIX8), ("OCC", dict(MIX8, escrow_sweep=False)),
    ("MVCC", MIX8),
]


def _case_id(alg, kw):
    if kw is MIX8:
        return f"{alg}-mix8"
    return "-".join([alg] + [f"{k}={v}" for k, v in kw.items()
                             if not k.startswith("perc_")]
                    + (["mix8"] if "perc_getparts" in kw else []))


@pytest.mark.parametrize("alg,kw", CASES,
                         ids=[_case_id(a, k) for a, k in CASES])
def test_epochs_match_reference(alg, kw):
    args = pps_args(cc_alg=alg, **kw)
    jcfg, tcfg = JConfig.from_args(args), Config.from_args(args)
    jeng = JEngine(jcfg, j_workload(jcfg))
    teng = Engine(tcfg, get_workload(tcfg, device="cpu"))
    js = jeng.init_state()
    assert_same_state(js, teng.init_state())
    ts = convert.from_reference_state(jax.device_get(js), tcfg, "cpu")
    js = jeng.jit_run(js, EPOCHS)
    ts = teng.run(ts, EPOCHS)
    assert_same_state(js, ts)
    st = {k: int(v.sum()) for k, v in ts.stats.items()}
    assert st["total_txn_commit_cnt"] > 0 and st["write_cnt"] > 0
    if alg in ("TPU_BATCH", "CALVIN", "NOCC"):
        assert st["total_txn_abort_cnt"] == 0


@pytest.mark.parametrize("alg", ["TPU_BATCH", "OCC", "MVCC", "MAAT"])
def test_part_amount_accounting(alg):
    """Every committed ORDERPRODUCT takes exactly one from each of its
    parts, every committed UPDATEPART adds 100, nothing else moves
    PART_AMOUNT (``tests/test_pps.py:126``, on a mixed stream)."""
    cfg = Config.from_args(pps_args(
        cc_alg=alg, perc_getpartbyproduct=0.2, perc_orderproduct=0.4,
        perc_updateproductpart=0.2, perc_updatepart=0.2))
    wl = get_workload(cfg, device="cpu")
    eng = Engine(cfg, wl)
    st = eng.init_state()
    a0 = st.db["PARTS"].columns["PART_AMOUNT"][:cfg.pps_parts_cnt].to(
        torch.int64).sum()
    st = eng.run(st, 12)
    a1 = st.db["PARTS"].columns["PART_AMOUNT"][:cfg.pps_parts_cnt].to(
        torch.int64).sum()
    by_type = st.stats["commit_by_type"]
    n_op, n_up = int(by_type[ORDERPRODUCT]), int(by_type[UPDATEPART])
    assert n_op > 0 and n_up > 0
    assert int(a1 - a0) == -cfg.pps_parts_per * n_op + 100 * n_up


def test_pps_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from deneva_tpu_torch.engine.driver import run_simulation
    from deneva_tpu_torch.workloads.pps import PPSWorkload
    cfg = Config.from_args(pps_args())
    for call in (lambda: run_simulation(cfg), lambda: get_workload(cfg),
                 lambda: PPSWorkload(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
