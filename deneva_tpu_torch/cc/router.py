"""The contention router's mechanism (port of ``deneva_tpu/cc/router.py``).

Under ``ctrl`` each epoch runs one of ``len(candidates(cfg)) + 1``
branches of `engine.step.Engine`'s routed step: a uniform branch per
candidate backend (NO_WAIT, OCC, TPU_BATCH, and DGCC under
``ctrl_dgcc``), or, when the partitions' assignments differ, the mixed
branch, which validates each backend group's sub-batch against one
shared incidence and defers the cross-group conflict surface on both
sides (`cross_group_defer`).  ``coarsen_keys`` right-shifts the
conflict-derivation keys of each partition by its ``gshift``; execution,
audit and the density owners keep the exact keys.

The knobs (`RouterKnobs`) are host values, set at chunk boundaries by
the controller (`runtime.controller`): the branch is picked in Python,
with no host sync, where the reference picks it on the device with
``lax.switch``.  Only the per-partition vectors ride as device tensors,
for the per-txn gathers.

One kernel lives here, beside its plain version:

* **K21** `cross_group_defer` (``csrc/router.cu``) — replaces
  ``router.py:149``: instead of the reference's 2 + 4G einsums over the
  bf16 [B, K] views ``u1`` and ``w1``, one pass scatters each lane into
  per-group and total write / access counts per bucket, and a second
  tests each txn's lanes against the other groups' counts.  The counts
  are exact small integers, so the test equals the reference's
  ``> 0.5`` on its f32 sums.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from deneva_tpu_torch import kernels
from deneva_tpu_torch.cc.base import AccessBatch, Incidence
from deneva_tpu_torch.config import CCAlg, Config

K21_DEFER = kernels.Kernel("dt_cross_group_defer", [
    kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    kernels.I32, kernels.I32, kernels.I32, kernels.I32, kernels.P,
    kernels.P, kernels.P])

# the uniform branches' backends, in branch order; DGCC (under
# ctrl_dgcc) comes fourth and the mixed branch always last
CANDIDATES: tuple[CCAlg, ...] = (CCAlg.NO_WAIT, CCAlg.OCC, CCAlg.TPU_BATCH)
MIXED = len(CANDIDATES)


def candidates(cfg: Config) -> tuple[CCAlg, ...]:
    """The candidate tuple of this config (``router.py:56``)."""
    if cfg.ctrl_dgcc:
        return CANDIDATES + (CCAlg.DGCC,)
    return CANDIDATES


def candidate_index(alg: CCAlg | str) -> int:
    """Branch index of a candidate backend; DGCC's is 3 whether or not
    it is armed (``router.py:66``).  Raises on a non-candidate."""
    alg = CCAlg(alg)
    if alg == CCAlg.DGCC:
        return len(CANDIDATES)
    return CANDIDATES.index(alg)


@dataclass(frozen=True)
class RouterKnobs:
    """One chunk-boundary decision (``router.py:77``).

    assign        per-partition backend (index into `candidates`)
    gshift        per-partition key coarsening (bits)
    repair_cap    live repair sub-rounds (<= cfg.repair_rounds)
    audit_cadence live audit cadence (epochs between audited epochs)
    assign_dev, gshift_dev  the two vectors as int32 device tensors
    """

    assign: tuple[int, ...]
    gshift: tuple[int, ...]
    repair_cap: int
    audit_cadence: int
    assign_dev: torch.Tensor
    gshift_dev: torch.Tensor


def knobs_from_decision(cfg: Config, assign, gshift, repair_cap,
                        audit_cadence, device=None) -> RouterKnobs:
    """Host decision -> knobs (``router.py:117``): lists and ints in; the
    two vectors copied once to ``device``."""
    assign = tuple(int(x) for x in assign)
    gshift = tuple(int(x) for x in gshift)
    return RouterKnobs(
        assign=assign, gshift=gshift, repair_cap=int(repair_cap),
        audit_cadence=max(1, int(audit_cadence)),
        assign_dev=torch.tensor(assign, dtype=torch.int32, device=device),
        gshift_dev=torch.tensor(gshift, dtype=torch.int32, device=device))


def static_knobs(cfg: Config, device=None) -> RouterKnobs:
    """The knobs equal to the static config (``router.py:104``): every
    partition on ``cfg.cc_alg``, no coarsening, the configured repair
    rounds and audit cadence.  Routing with them equals the unrouted
    step."""
    p = max(cfg.part_cnt, 1)
    return knobs_from_decision(cfg, [candidate_index(cfg.cc_alg)] * p,
                               [0] * p, cfg.repair_rounds,
                               max(1, cfg.audit_cadence), device)


def coarsen_keys(batch: AccessBatch, owner: torch.Tensor,
                 knobs: RouterKnobs) -> AccessBatch:
    """The conflict-derivation view of the batch, each access's key
    shifted right (logically) by its owner partition's ``gshift``
    (``router.py:128``).  Coarsening only merges keys, so it can only add
    conflicts.  With every shift 0 the batch itself."""
    if not any(knobs.gshift):
        return batch
    g = knobs.gshift_dev
    sh = g[torch.clamp(owner, 0, g.shape[0] - 1).long()]
    keys = (batch.keys.to(torch.int64) & 0xFFFFFFFF) >> sh.to(torch.int64)
    return dataclasses.replace(batch, keys=keys.to(torch.int32))


def txn_backend(knobs: RouterKnobs, owner: torch.Tensor) -> torch.Tensor:
    """int32[B]: each txn's backend, its home partition's (the owner of
    its first planned access; ``router.py:143``)."""
    a = knobs.assign_dev
    home = torch.clamp(owner[:, 0], 0, a.shape[0] - 1)
    return a[home.long()]


def cross_group_defer_plain(inc: Incidence, batch: AccessBatch,
                            group: torch.Tensor,
                            n_groups: int = MIXED) -> torch.Tensor:
    """Plain K21, op for op from ``router.py:164-187``: the column masses
    of ``w1`` and ``u1`` over the active txns, per group by masked
    einsums, then each txn's accesses against the other groups' writes
    and its writes against their accesses, in f32."""
    u1 = inc.u1.float()
    w1 = inc.w1.float()
    act = batch.active.float()
    conf = torch.zeros(batch.active.shape, dtype=torch.float32,
                       device=u1.device)
    tot_w = torch.einsum("bk,b->k", w1, act)
    tot_u = torch.einsum("bk,b->k", u1, act)
    for g in range(n_groups):
        m = act * (group == g).float()
        oth_w = tot_w - torch.einsum("bk,b->k", w1, m)
        oth_u = tot_u - torch.einsum("bk,b->k", u1, m)
        c_g = torch.einsum("bk,k->b", u1, oth_w) \
            + torch.einsum("bk,k->b", w1, oth_u)
        conf = torch.where(group == g, c_g, conf)
    return batch.active & (conf > 0.5)


def cross_group_defer(inc: Incidence, batch: AccessBatch,
                      group: torch.Tensor,
                      n_groups: int = MIXED) -> torch.Tensor:
    """K21: bool[B], the active txns whose conflict surface crosses
    backend groups, from the lanes: ``inc.bucket1`` and the ``u`` / ``w``
    lane masks of the views ``u1`` / ``w1`` are built from."""
    if inc is None or inc.u1 is None or inc.w1 is None:
        raise ValueError("cross_group_defer reads the incidence's u and w "
                         "views (the mixed branch builds them)")
    if kernels.on_cpu(batch.keys, group, inc.bucket1):
        return cross_group_defer_plain(inc, batch, group, n_groups)
    b, a = batch.keys.shape
    k = inc.u1.shape[1]
    dev = batch.keys.device
    kernels.check("bucket1", inc.bucket1, torch.int32, (b, a), dev)
    for name, t in (("valid", batch.valid), ("is_read", batch.is_read),
                    ("is_write", batch.is_write)):
        kernels.check(name, t, torch.bool, (b, a), dev)
    kernels.check("active", batch.active, torch.bool, (b,), dev)
    kernels.check("group", group, torch.int32, (b,), dev)
    cnt = torch.empty((n_groups + 1) * 2 * k, dtype=torch.int32, device=dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    K21_DEFER.launch(kernels.ptr(inc.bucket1), kernels.ptr(batch.valid),
                     kernels.ptr(batch.is_read), kernels.ptr(batch.is_write),
                     kernels.ptr(batch.active), kernels.ptr(group), b, a, k,
                     n_groups, kernels.ptr(cnt), kernels.ptr(out),
                     kernels.stream(batch.keys))
    return out
