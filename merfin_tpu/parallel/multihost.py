"""Multi-host launch support (jax.distributed).

The reference scales across nodes by Slurm file-scatter with a full DB
reload per node (scripts/parallel1, SURVEY §2.3).  Here each host joins
one jax.distributed job: the global mesh spans all hosts' devices, the
table shards over the global "t" axis (each host holds only its slice of
HBM), hosts read disjoint sequence subsets, and accumulator merges ride
the same psum collectives as the single-host path.

Usage (per host):

    from merfin_tpu.parallel.multihost import init, host_sequences
    init(coordinator="host0:9876", num_processes=N, process_id=i)
    mesh = make_global_mesh()
    for seq in host_sequences(SeqFile(path)):   # every Nth sequence
        ...
    # partial accumulators -> merge_across_hosts(...)

This module is structured for real slices; in this dev environment only
single-process behavior is exercised (tests use process_count == 1).
"""

from __future__ import annotations

import os

import numpy as np

from merfin_tpu.config import ensure_x64


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Initialize jax.distributed (no-op when single-process)."""
    ensure_x64()
    import jax

    if num_processes is None or num_processes <= 1:
        return
    # cross-process CPU collectives need the gloo transport (GPU
    # backends use their own collectives)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


_env_initialized = False


def maybe_init_from_env(log=None) -> bool:
    """Join a distributed job when MERFIN_NUM_PROCESSES > 1.

    Env contract (the jax.distributed analog of the reference's Slurm
    array scatter, scripts/parallel1/_submit_merfin.sh:57-70):
      MERFIN_NUM_PROCESSES  total process count
      MERFIN_PROCESS_ID     this process's rank (0-based)
      MERFIN_COORDINATOR    host:port of rank 0 (default 127.0.0.1:9876)
    """
    global _env_initialized
    n = int(os.environ.get("MERFIN_NUM_PROCESSES", "1") or "1")
    if n <= 1:
        return False
    if not _env_initialized:
        init(
            coordinator=os.environ.get("MERFIN_COORDINATOR", "127.0.0.1:9876"),
            num_processes=n,
            process_id=int(os.environ.get("MERFIN_PROCESS_ID", "0")),
        )
        _env_initialized = True
    if log is not None:
        pid, pcount = process_info()
        print(f"-- Joined distributed job: process {pid} of {pcount}.",
              file=log)
    return True


def is_active() -> bool:
    import jax

    return jax.process_count() > 1


def barrier(name: str = "merfin") -> None:
    import jax

    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def process_info() -> tuple[int, int]:
    import jax

    return jax.process_index(), jax.process_count()


def make_global_mesh(data: int | None = None):
    """A ("d", "t") mesh over ALL processes' devices."""
    from merfin_tpu.parallel.sharded import make_mesh

    return make_mesh(data=data)


def host_sequences(seq_iter):
    """Stripe sequences across hosts: host i takes every P-th sequence
    (the reference's scaffold striping, scripts/parallel1/merfin.sh:63-86,
    without the per-node DB duplication)."""
    pid, pcount = process_info()
    for i, seq in enumerate(seq_iter):
        if i % pcount == pid:
            yield seq


def merge_scalar_across_hosts(x: float) -> float:
    """Global sum of a host-local scalar (psum over all devices /
    local device count)."""
    import jax
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return float(x)
    from jax.experimental import multihost_utils

    arr = jnp.asarray([x], dtype=jnp.float64)
    out = multihost_utils.process_allgather(arr)
    return float(np.asarray(out).sum())


def max_scalar_across_hosts(x: float) -> float:
    """Global max of a host-local scalar."""
    import jax
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return float(x)
    from jax.experimental import multihost_utils

    arr = jnp.asarray([x], dtype=jnp.float64)
    out = multihost_utils.process_allgather(arr)
    return float(np.asarray(out).max())


def allgather_scalar(x: float) -> np.ndarray:
    """Every rank's value of a host-local scalar, indexed by rank."""
    import jax
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return np.asarray([x], dtype=np.float64)
    from jax.experimental import multihost_utils

    arr = jnp.asarray([x], dtype=jnp.float64)
    out = multihost_utils.process_allgather(arr)
    return np.asarray(out).reshape(-1)


def merge_array_across_hosts(x: np.ndarray) -> np.ndarray:
    """Elementwise global sum of a host-local accumulator array."""
    import jax

    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    # process_allgather stacks a leading process axis itself
    out = multihost_utils.process_allgather(np.asarray(x))
    return np.asarray(out).sum(axis=0)
