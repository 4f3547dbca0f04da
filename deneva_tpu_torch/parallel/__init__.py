"""Partition parallelism over a device mesh (port of ``deneva_tpu/parallel``).

The reference maps Deneva's hash partitioning of the keyspace across
server nodes (`system/global.h:294-306`) onto a ``jax.sharding.Mesh``
driven by one process: table rows shard owner-major over the mesh, the
epoch's batch and the verdict stay replicated, and each device executes
its own partition under ``shard_map``.  The port keeps the single
controller: one process holds a `Mesh` of ``torch.device``s, runs each
shard's body in shard order on its device, and moves tensors between
shards for the collectives.  The multi-process runtime is a separate
item (`torch.distributed` belongs there).
"""

from deneva_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, a2a_bytes_per_epoch, current_mesh, make_mesh, make_sharded_run,
    use_mesh)
