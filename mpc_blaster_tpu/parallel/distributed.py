"""Multi-host scaling glue: jax.distributed + global meshes.

The reference has no distributed story at all (SURVEY.md §2.3); its only
IPC is ROS pub/sub. Here multi-host runs are the same shard_map code as
single host: `initialize()` wires the jax.distributed runtime, and
`global_mesh()` builds a mesh over every device of every process.
Per-scenario QP solves stay local to their device; only sweep reductions
(pmean/pmax in parallel/mesh.py) cross devices and hosts — the layout
BASELINE.md's multi-device config asks for.

On a single process this module degrades gracefully (no-op initialize),
so the same entry point runs everywhere.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed if a multi-process env is configured.

    Returns True when running distributed. Arguments may be omitted only
    when the cluster environment (e.g. a SLURM job) provides them.
    """
    if num_processes is not None and num_processes <= 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        return jax.process_count() > 1
    except (ValueError, RuntimeError):
        # single-process / already initialized
        return jax.process_count() > 1


def global_mesh(axis: str = "dp") -> Mesh:
    """1-D mesh over all devices of all processes (scenario batch axis)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_local_batch(global_batch: int) -> int:
    """Scenario count this host should generate for an even global shard."""
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def make_global_array(host_local_data, mesh: Mesh, axis: str = "dp"):
    """Assemble a host-sharded global array from per-host scenario data."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding,
                                                  np.asarray(host_local_data))
