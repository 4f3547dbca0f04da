"""Device primitives beneath the engine: the threefry stream, zipfian
sampling, the sort-based forwarding plan, key hashing, the conflict
incidence and sweep, and duplicate-write resolution.  Each hand-written
kernel sits in the module of the function it replaces, beside its plain
PyTorch version; callers reach the sweep's kernels through their
modules (`ops.conflict`, `ops.scatter`)."""

from deneva_tpu_torch.ops.forward import (ForwardPlan,  # noqa: F401
                                          commit_all_verdict, forward_plan,
                                          forward_plan_flat, forward_verdict,
                                          forwarding_applies,
                                          last_earlier_writer,
                                          mc_defer_verdict, mc_pair_cap,
                                          mc_plan_defer, seg_first)
from deneva_tpu_torch.ops.sampling import Zipfian  # noqa: F401
