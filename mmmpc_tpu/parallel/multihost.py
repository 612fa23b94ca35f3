"""Multi-host (multi-process) scaling scaffolding.

Within a host the data mesh spans the local cards
(parallel/data_parallel.py); across hosts JAX runs one *process per host*,
each seeing only its local devices, with collectives crossing the network
between hosts.  This module adds the three pieces a multi-process deployment needs
on top of ``sharded_solve_fn``:

1. ``init_distributed`` — process bootstrap (jax.distributed.initialize),
   env-var driven so the same entry point works under any launcher;
2. ``global_data_mesh`` — a 1-D ("data",) mesh over ALL processes' devices;
3. ``host_local_batch`` — per-host data feeding: each process supplies only
   its local shard of the global scenario batch and gets back the global
   jax.Array (jax.make_array_from_process_local_data), so no host ever
   materializes the full fleet.

Launch recipe (documented in README §multi-host; dry-runnable single-process
anywhere):

    # on every host, with its own PROCESS_ID:
    JAX_COORDINATOR=host0:12345 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=$RANK \
        python scripts/bench_multihost.py

The solve program itself is unchanged: ``sharded_solve_fn`` over the global
mesh — XLA partitions the batch per device, and the BatchStats psum/pmax
reductions cross hosts over the network inside the compiled program (no host-side
gather anywhere).
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize multi-process JAX if a coordinator is configured.

    Resolution order: explicit args, then JAX_COORDINATOR /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars, then standard cluster
    auto-detection (jax.distributed.initialize() with no args, where the
    cluster environment tells JAX its layout).  Returns True if distributed mode was initialized,
    False for the single-process fallback (so callers can share one code
    path between laptop runs and pod runs).
    """
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR"))
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False            # single-process run; nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return True


def global_data_mesh(axis_name: str = "data") -> Mesh:
    """1-D data mesh over every device of every process.

    Identical to make_mesh() in single-process mode; in multi-process mode
    jax.devices() spans all hosts, so the mesh (and the collectives compiled
    against it) crosses the network.
    """
    return Mesh(np.asarray(jax.devices()).reshape(-1), (axis_name,))


def host_local_batch(mesh: Mesh, local_arrays, axis_name: str = "data"):
    """Assemble a global batch from per-process local shards.

    local_arrays: pytree of numpy/jax arrays holding THIS process's slice of
    the global batch (leading axis = local batch).  Returns the same pytree
    as global jax.Arrays sharded over the mesh's data axis, with global
    leading axis = local * num_processes.  In single-process mode this is
    just a device_put with the sharding.
    """
    sharding = NamedSharding(mesh, P(axis_name))

    def make(a):
        a = np.asarray(a)
        if jax.process_count() == 1:
            return jax.device_put(a, sharding)
        return jax.make_array_from_process_local_data(sharding, a)

    return jax.tree.map(make, local_arrays)


def process_batch_slice(global_batch: int) -> tuple[int, int]:
    """(local_batch, offset) of this process's slice of a global batch."""
    n = jax.process_count()
    assert global_batch % n == 0, (global_batch, n)
    local = global_batch // n
    return local, local * jax.process_index()
