"""Device mesh + collectives plumbing.

Replacement for the reference MPI layer
(/root/reference/src/utility/parallel.jl): the block/walker axis is sharded
over a 1-D mesh spanning every device (NVLink within a host, the network
across hosts), and the per-iteration statistics reduction — everything
``MPIreduceConfig!`` + ``MPIbcastConfig!`` used to move (configuration.jl:
264-321) — is one collective inside the solver kernels, after which every
host deterministically computes identical reweight/train updates.

``jax.distributed.initialize()`` is invoked lazily for multi-host runs,
mirroring the reference's lazy ``MPI.Init()`` (parallel.jl:5-17).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec


_DISTRIBUTED_INITIALIZED = False

BLOCK_AXIS = "blocks"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Lazy multi-host initialization (call once per process before work)."""
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return
    if coordinator is not None or "JAX_COORDINATOR_ADDRESS" in os.environ:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    _DISTRIBUTED_INITIALIZED = True


def default_mesh() -> Optional[Mesh]:
    """1-D mesh over every available device; None for a single device."""
    devices = jax.devices()
    if len(devices) <= 1:
        return None
    return Mesh(np.asarray(devices), (BLOCK_AXIS,))


def make_mesh(n_devices: Optional[int] = None, axis: str = BLOCK_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def mesh_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))


def ordered_psum(x, axis: str):
    """Topology-independent statistics all-reduce: all_gather then sum in
    mesh-axis order.

    ``lax.psum``'s float reduction order depends on the collective's
    topology, so a 2-process x 2-device run and a 1-process x 4-device run
    of the same mesh size can differ in the last ulp — which feeds back
    through grid training and breaks bit-for-bit reproducibility across
    process layouts (the equality the reference asserts rank-by-rank in
    test/mpi_test.jl:73-146).  Gathering the per-device partials [ndev, ...]
    and summing over the leading axis fixes the order to mesh order on
    every device identically.  Statistics payloads are KB-scale
    (SURVEY.md §5), so the extra bandwidth is noise.
    """
    import jax.numpy as jnp

    return jnp.sum(jax.lax.all_gather(x, axis), axis=0)


def distribute_rows(mesh: Optional[Mesh], rows: np.ndarray):
    """Turn a host-replicated [n, ...] array into a global array sharded over
    the mesh's first axis.  Single-process: pass through (jit auto-shards).

    Multi-host: every process calls this with the SAME host array (all hosts
    compute identical per-block key data), and each contributes its
    addressable shards — the multi-host analogue of the reference's
    rank-indexed block loop (src/main.jl:152-166).
    """
    if mesh is None or jax.process_count() == 1:
        return rows
    sharding = jax.sharding.NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    return jax.make_array_from_callback(rows.shape, sharding,
                                        lambda idx: rows[idx])


def gather_rows(x):
    """Fetch a (possibly sharded) device array to every host as numpy.

    Multi-host: all-gathers the non-addressable shards (the replacement for
    the reference's root-only Result asymmetry — every host gets the data).
    """
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
