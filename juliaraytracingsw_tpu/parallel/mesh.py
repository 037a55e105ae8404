"""Device meshes and sharding policies.

The scaling story (SURVEY.md §2.7): rays never interact, so packets shard
perfectly over cards (``PartitionSpec('packets')``); the Eulerian spectral
state is replicated per card at production sizes (512^2 x 3 complex64
~ 3 MB) and every card computes the flow step redundantly — no
communication between cards except the packet-loss psum in the backward
pass.
Slab-decomposed distributed FFT for 1024^2+ lives in parallel/fft.py.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_packets", "replicate", "packet_sharding",
           "init_distributed"]

PACKET_AXIS = "packets"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Multi-host runtime init (SURVEY.md §5.8: the reference has no
    distributed backend — its cross-job layer was SLURM arrays + the
    filesystem; here several hosts become one logical device set).

    Wraps ``jax.distributed.initialize``; args default from the cluster
    environment (SLURM / MPI / coordinator env vars). Call once
    per process before any jax computation; returns the process index.
    No-op on a single-process run.
    """
    if num_processes is not None and num_processes <= 1:
        return 0
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialised
        if "already" not in str(e).lower():
            raise
    return jax.process_index()


def make_mesh(n_devices: int | None = None, axis: str = PACKET_AXIS) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.array(devs[:n]), (axis,))


def packet_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PACKET_AXIS))


def shard_packets(packets, mesh: Mesh):
    """Place every per-packet leaf with its leading axis split over the mesh."""
    sh = packet_sharding(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), packets)


def replicate(tree, mesh: Mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)
