"""Multi-host wiring: jax.distributed initialization + global array
construction.

The single-host mesh path (engine/mesh.py) runs shard_map collectives
from ONE process that drives every GPU of its host.  For N>=2 hosts
(BASELINE configs; SURVEY.md section 2.4 "communication backend" row),
every process must:

  1. call ``init_distributed()`` BEFORE any other jax API -- this
     connects the processes (coordinator + process_id) so
     ``jax.devices()`` returns the GLOBAL device list;
  2. build sharded inputs as GLOBAL arrays (``host_to_global``): each
     process feeds its local shard, jax assembles the logical array.

One process per host is the supported layout: a JAX process reserves
most of the memory of every GPU of its host when it first touches
them, so a second process on the same host finds no room.

The CLI reads ZA_DIST="coordinator:port,num_processes,process_id"
(or the standard JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID env vars) and calls init_distributed before the engine
is constructed.  tests/test_multihost.py drives a real 2-process
config over the CPU backend.
"""

from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args, ZA_DIST, or the standard
    JAX_* env vars. Returns True when a multi-process runtime was
    initialized, False for single-process (no-op).  Run one process
    per host: it drives every GPU of that host.

    ZA_DIST format: "coordinator_host:port,num_processes,process_id".
    """
    spec = os.environ.get("ZA_DIST", "")
    if coordinator is None and spec:
        try:
            coordinator, nproc_s, pid_s = spec.split(",")
            num_processes = int(nproc_s)
            process_id = int(pid_s)
        except ValueError as exc:
            raise ValueError(
                f"ZA_DIST must be 'host:port,nprocs,procid', got {spec!r}"
            ) from exc
    if coordinator is None and "JAX_COORDINATOR_ADDRESS" in os.environ:
        coordinator = os.environ["JAX_COORDINATOR_ADDRESS"]
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if coordinator is None or (num_processes or 1) <= 1:
        return False

    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def host_to_global(mesh, arr, spec):
    """Replicated host value -> global jax.Array sharded per `spec`.

    Every process passes the SAME full logical array; each uploads only
    the shards its local devices own. Single-process: a device_put."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    import numpy as np

    arr = np.asarray(arr)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def fetch_replicated(x):
    """Fully-replicated (or process-0-owned) output -> host numpy on
    every process (all shards are addressable single-host; multi-host
    uses the allgather-to-host helper)."""
    import jax
    import numpy as np

    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x))
