"""The port's run driver and its boundaries.

* A CPU ``run_simulation`` of the port prints a ``[summary]`` line that
  parses with the port's ``parse_summary``, carries the same keys as
  ``deneva_tpu``'s for the same config, commits and never aborts.
* ``deneva_tpu_torch`` imports neither JAX nor any ``deneva_tpu`` module.
* Every entry point called without a device raises on a box without
  CUDA instead of running on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# A txn type gets its latency keys in the summary only when some txn of
# that type commits inside the measured window.  At 10% writes a third of
# the txns are read-only, so every epoch of 128 commits both types and the
# key set does not hang on how many epochs the window fits (at 50% writes
# one txn in 1024 is read-only, and a slow window may see none).
ARGS = ["--epoch_batch=128", "--max_txn_in_flight=128",
        "--synth_table_size=2048", "--zipf_theta=0.9",
        "--write_perc=0.1", "--read_perc=0.9",
        "--warmup_secs=0.05", "--done_secs=0.3",
        "--chunk_target_secs=0.000001"]


def test_cpu_run_simulation_summary_matches_reference_keys():
    from deneva_tpu.config import Config as JConfig
    from deneva_tpu.engine.driver import run_simulation as j_run
    from deneva_tpu.stats import parse_summary as j_parse
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.driver import run_simulation
    from deneva_tpu_torch.stats import parse_summary

    # chunk=1 with a near-zero chunk target keeps the reference at one
    # compiled scan length
    st = run_simulation(Config.from_args(ARGS), device="cpu", chunk=1,
                        quiet=True)
    got = parse_summary(st.summary_line())
    want = j_parse(j_run(JConfig.from_args(ARGS), chunk=1,
                         quiet=True).summary_line())
    assert sorted(got) == sorted(want)
    assert got["total_txn_abort_cnt"] == 0 and got["abort_rate"] == 0
    assert got["total_txn_commit_cnt"] > 0 and got["tput"] > 0
    assert got["total_txn_commit_cnt"] == 128 * got["epoch_cnt"]
    assert st.epochs_run >= got["epoch_cnt"]


def test_port_imports_neither_jax_nor_reference():
    mods = ["deneva_tpu_torch", "deneva_tpu_torch.engine.driver",
            "deneva_tpu_torch.convert", "deneva_tpu_torch.kernels",
            "deneva_tpu_torch.workloads.ycsb", "deneva_tpu_torch.ops.forward",
            "deneva_tpu_torch.ops.sampling", "deneva_tpu_torch.ops.prng",
            "deneva_tpu_torch.ops.conflict", "deneva_tpu_torch.ops.scatter",
            "deneva_tpu_torch.ops.hashing", "deneva_tpu_torch.cc",
            "deneva_tpu_torch.cc.timestamp", "deneva_tpu_torch.cc.twopl",
            "deneva_tpu_torch.stats", "deneva_tpu_torch.storage",
            "deneva_tpu_torch.storage.table", "deneva_tpu_torch.storage.index",
            "deneva_tpu_torch.workloads.pps", "deneva_tpu_torch.workloads.tpcc",
            "deneva_tpu_torch.cc.depgraph", "deneva_tpu_torch.cc.dgcc",
            "deneva_tpu_torch.engine.repair", "deneva_tpu_torch.cc.base",
            "deneva_tpu_torch.engine.step", "chip_smoke"]
    code = ("import sys; " + "; ".join(f"import {m}" for m in mods) +
            "; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'deneva_tpu' or "
            "m.startswith('deneva_tpu.')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.engine.driver import run_simulation
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads import get_workload
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    cfg = Config.from_args(ARGS)
    for call in (lambda: run_simulation(cfg), lambda: get_workload(cfg),
                 lambda: YCSBWorkload(cfg),
                 lambda: Engine(cfg, get_workload(cfg, device="cpu"),
                                device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
