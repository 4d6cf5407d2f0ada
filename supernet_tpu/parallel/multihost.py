"""Multi-host (multi-process) data-parallel scale-out.

The reference is strictly single-GPU (SURVEY.md §2.8); the single-host DP
path here (`parallel/data_parallel.py`) shards a host-resident global
batch over one process's devices. On several hosts each process sees
only its local devices and loads only its slice of the data, and the
collectives cross the network between hosts — but the jitted
train step itself is UNCHANGED: GSPMD partitions the same program over the
global mesh. These helpers supply the three things that do change:

1. process bring-up (`initialize_from_env` -> `jax.distributed.initialize`),
2. which rows of the global batch this process should load
   (`process_local_rows` — pure function, unit-testable),
3. assembling a global jax.Array from per-process host shards
   (`global_batch` -> `jax.make_array_from_process_local_data`).

Single-process behavior is the identity case (process_count=1), so every
helper runs — and is tested — on the 8-device virtual CPU mesh
(tests/test_multihost.py); `global_batch` there is semantically equal to
`shard_batch`'s `device_put`.
"""

from __future__ import annotations

import os
from typing import Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def initialize_from_env() -> bool:
    """`jax.distributed.initialize` from SUPERNET_COORDINATOR (+
    SUPERNET_NUM_PROCESSES / SUPERNET_PROCESS_ID) or the standard JAX env
    (JAX_COORDINATOR_ADDRESS etc. — then initialize() reads them itself).
    Returns True if distributed mode was initialized; False (no-op) when
    no coordinator is configured — single-process runs need nothing."""
    coord = os.environ.get("SUPERNET_COORDINATOR")
    if coord:
        missing = [
            k
            for k in ("SUPERNET_NUM_PROCESSES", "SUPERNET_PROCESS_ID")
            if k not in os.environ
        ]
        if missing:
            # fail the whole job legibly — a bare KeyError on one worker
            # leaves the others hanging at the distributed barrier
            raise ValueError(
                f"SUPERNET_COORDINATOR={coord} is set but {missing} "
                "is not; the three variables (SUPERNET_COORDINATOR, "
                "SUPERNET_NUM_PROCESSES, SUPERNET_PROCESS_ID) must be "
                "set together on every worker"
            )
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["SUPERNET_NUM_PROCESSES"]),
            process_id=int(os.environ["SUPERNET_PROCESS_ID"]),
        )
        return True
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()
        return True
    return False


def process_local_rows(
    global_batch_size: int,
    process_index: int | None = None,
    process_count: int | None = None,
) -> Tuple[int, int]:
    """[start, stop) rows of the global batch this process loads.

    Contiguous equal blocks in process order — the layout
    `make_array_from_process_local_data` expects for a leading-axis
    sharding when each process's devices are contiguous in the mesh (the
    `global_mesh` construction below guarantees that: `jax.devices()`
    orders by process). Requires the global batch to divide by the
    process count, mirroring the per-device divisibility rule of
    `shard_batch`."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    if global_batch_size % pc != 0:
        raise ValueError(
            f"global batch {global_batch_size} must divide over "
            f"{pc} processes"
        )
    per = global_batch_size // pc
    return pi * per, (pi + 1) * per


def global_mesh(axis_name: str = "data") -> Mesh:
    """1-D mesh over ALL devices of ALL processes (after
    `initialize_from_env`, `jax.devices()` spans the whole job, ordered by
    process — so each process's rows land on its own local devices and
    host->device feeding never crosses DCN)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def global_batch(
    mesh: Mesh, *arrays: np.ndarray, axis_name: str = "data"
) -> Tuple[Array, ...]:
    """Assemble global, batch-sharded jax.Arrays from THIS process's local
    rows. Each input is the [local_rows, ...] slice
    `process_local_rows` assigned to this process; the result behaves
    exactly like `shard_batch(mesh, global_array)` on one process, and on
    many processes is the only way to build the global array without
    gathering data to one host."""
    sharding = NamedSharding(mesh, P(axis_name))
    n_dev = mesh.devices.size
    pc = jax.process_count()
    for a in arrays:
        # the global row count is local_rows * process_count; P(axis_name)
        # additionally needs it to divide over the MESH devices — check
        # here with a clear message instead of an opaque uneven-sharding
        # error deep inside make_array_from_process_local_data
        if (len(a) * pc) % n_dev != 0:
            raise ValueError(
                f"global batch {len(a) * pc} ({len(a)} local rows x {pc} "
                f"processes) must divide over the {n_dev}-device mesh"
            )
    out = tuple(
        jax.make_array_from_process_local_data(sharding, np.asarray(a))
        for a in arrays
    )
    return out if len(out) != 1 else out[0]
