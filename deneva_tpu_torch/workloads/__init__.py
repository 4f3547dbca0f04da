"""Benchmarks (reference `benchmarks/`).  The port carries YCSB and TPC-C;
PPS comes with ROADMAP.md queue 1, item 15b."""

from deneva_tpu_torch.workloads.base import DB, Workload  # noqa: F401
from deneva_tpu_torch.workloads.tpcc import TPCCWorkload  # noqa: F401
from deneva_tpu_torch.workloads.ycsb import YCSBWorkload  # noqa: F401


def get_workload(cfg, device=None):
    """The workload of ``cfg`` on ``device`` (CUDA unless the caller names
    the CPU)."""
    from deneva_tpu_torch.config import WorkloadKind
    if cfg.workload == WorkloadKind.YCSB:
        return YCSBWorkload(cfg, device=device)
    if cfg.workload == WorkloadKind.TPCC:
        return TPCCWorkload(cfg, device=device)
    raise NotImplementedError(
        f"workload {cfg.workload} is not ported to deneva_tpu_torch yet "
        "(ROADMAP.md queue 1, item 15b: PPS)")
