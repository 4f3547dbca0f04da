"""The device mesh and its collectives (port of ``deneva_tpu/parallel/mesh.py``).

A `Mesh` is an ordered list of ``torch.device``s, one per shard of the
``part`` axis.  ``make_mesh(n)`` takes the first ``n`` CUDA devices and
raises with fewer, as the reference's does; a caller may name the
devices instead, one device for every shard included (``devices=[dev] *
n``), which is how one card or the CPU runs a mesh of ``n`` shards, as
the reference's tests run eight virtual CPU devices.

The reference's collectives become tensor moves between shards:

* ``psum`` — the shards' uint32 partials, held as int64 in [0, 2^32),
  summed and wrapped (`Mesh.psum`);
* the ``P(AXIS)`` outputs — the shards' pieces concatenated;
* ``all_to_all`` — each source's ``[D, pair_cap]`` blocks regrouped into
  each destination's ``[D_src, pair_cap]`` (`Mesh.all_to_all`).

Validation runs once, over the replicated batch, on the mesh's first
device; the reference's bucket-sharded incidence (``shard_buckets``) and
``cc_state`` sharding change only where the values live, not what they
are.  `make_sharded_run` places the state where its shards run: every
stacked table's blocks on the shards' device.  Blocks over distinct
devices are not placed yet (ROADMAP.md queue 1, item 19b), so a mesh of
distinct devices raises there.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import torch

MASK32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over axis ``part``: shard ``d`` runs on ``devices[d]``."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first device: where validation and the replicated state
        live."""
        return self.devices[0]

    @property
    def one_device(self) -> bool:
        return len(set(self.devices)) == 1

    def psum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The wrapped uint32 sum of the shards' int64 partials."""
        tot = parts[0].to(self.device)
        for p in parts[1:]:
            tot = tot + p.to(self.device)
        return tot & MASK32

    def concat(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The ``P(AXIS)`` output: the shards' pieces end to end."""
        return torch.cat([p.to(self.device) for p in parts])

    def all_to_all(self, blocks: list[tuple[torch.Tensor, ...]]
                   ) -> list[tuple[torch.Tensor, ...]]:
        """``blocks[s]`` holds source ``s``'s tensors of shape ``[D,
        cap]``; destination ``d`` receives, for each tensor, the rows
        ``d`` of every source, stacked in source order and flattened to
        ``[D * cap]`` on its own device."""
        n = len(blocks[0])
        return [tuple(torch.stack([blocks[s][i][d].to(dev)
                                   for s in range(self.size)]).reshape(-1)
                      for i in range(n))
                for d, dev in enumerate(self.devices)]


_current: dict = {"mesh": None}


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards: the first ``n_devices`` CUDA
    devices, or the ``devices`` named (the same device may repeat)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices named for a mesh of "
                         f"{n_devices}")
    if any(d.type == "cuda" and d.index is None for d in devices):
        raise ValueError("name CUDA devices with their index")
    return Mesh(devices)


def current_mesh() -> Mesh | None:
    """The mesh of the enclosing `use_mesh` (None outside one)."""
    return _current["mesh"]


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = _current["mesh"]
    _current["mesh"] = mesh
    try:
        yield mesh
    finally:
        _current["mesh"] = prev


def a2a_bytes_per_epoch(cfg, b: int) -> int:
    """The bytes the sharded plan's ``all_to_all`` moves per epoch
    (``deneva_tpu/parallel/mesh.py:109``): each of D shards sends a
    ``[D, pair_cap]`` block of key, rank and write flag (9 B a lane) to
    every shard; 0 where the plan is replicated."""
    from deneva_tpu_torch.ops.forward import mc_pair_cap
    d = cfg.device_parts
    cap = mc_pair_cap(b, cfg.max_accesses, d, cfg.mc_plan_capacity)
    return d * d * cap * 9


def _to(obj, dev: torch.device):
    """Every tensor of a state tree moved to ``dev`` (dataclasses, dicts,
    tuples and lists rebuilt around them)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(v, dev) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def make_sharded_run(engine, mesh: Mesh):
    """(place, run): ``place(state)`` puts the state where its shards run;
    ``run(state, n)`` runs ``n`` epochs under the mesh
    (``deneva_tpu/parallel/mesh.py:127``)."""
    if mesh.size != engine.cfg.device_parts:
        raise ValueError(f"a mesh of {mesh.size} for device_parts="
                         f"{engine.cfg.device_parts}")

    def place(state):
        if not mesh.one_device:
            raise NotImplementedError(
                "blocks of a stacked table over distinct devices are not "
                "placed yet (ROADMAP.md queue 1, item 19b: multi-GPU "
                "placement); name one device for every shard")
        return _to(state, mesh.device)

    def run(state, n: int):
        with use_mesh(mesh):
            return engine.run(state, n)

    return place, run
