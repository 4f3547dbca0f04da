"""Benchmarks (reference `benchmarks/`): YCSB, TPC-C and PPS."""

from deneva_tpu_torch.workloads.base import DB, Workload  # noqa: F401
from deneva_tpu_torch.workloads.pps import PPSWorkload  # noqa: F401
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
    if cfg.workload == WorkloadKind.PPS:
        return PPSWorkload(cfg, device=device)
    raise ValueError(f"no workload for {cfg.workload}")
