"""Multi-host scale-out and recovery.

The reference is single-process (SURVEY.md §2: no distributed layer).  Here:
one process per host, ``jax.distributed`` for the process group, a global
mesh whose ``env`` axis spans every device of every host, and env batches
built host-locally then assembled into one global sharded array — XLA
inserts the collectives (NCCL on GPUs), nothing in the engine changes.

Failure recovery is deterministic restart: the entire training state is one
pytree (see rware_tpu.checkpoint) and the engine is a pure function of it,
so recovery = all hosts restore the latest checkpoint and replay.  No
in-band heartbeat protocol is needed — the JAX runtime surfaces peer
failures as errors, and the wrapper below turns them into checkpointed
restarts.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

import jax
import numpy as np

from rware_tpu.parallel.sharding import ENV_AXIS, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """``jax.distributed.initialize`` with env-var fallback; returns
    (process_index, process_count).

    Explicit args win; otherwise ``RWARE_COORD_ADDR`` / ``RWARE_NUM_PROCS``
    / ``RWARE_PROC_ID`` configure a manual process group (the localhost
    multi-process harness, tools/multiproc_verify.py, uses these); with
    neither, JAX's cluster auto-detection applies when the environment
    provides it."""
    import os

    if coordinator_address is None:
        coordinator_address = os.environ.get("RWARE_COORD_ADDR")
        if num_processes is None and "RWARE_NUM_PROCS" in os.environ:
            num_processes = int(os.environ["RWARE_NUM_PROCS"])
        if process_id is None and "RWARE_PROC_ID" in os.environ:
            process_id = int(os.environ["RWARE_PROC_ID"])
    if (num_processes is not None and num_processes > 1) or \
            coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def global_env_batch(
    make_local: Callable[[int, int], Any], n_envs: int, mesh=None
) -> Any:
    """Assemble a globally sharded env batch from host-local pieces.

    ``make_local(start, count) -> pytree`` builds the batch slice this host
    owns (e.g. vmapped reset over keys ``start..start+count``).  Every leaf
    of the result is a global jax.Array sharded over the mesh's env axis.
    """
    if mesh is None:
        mesh = make_mesh()
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(ENV_AXIS))
    n_proc = jax.process_count()
    if n_envs % n_proc:
        raise ValueError(f"n_envs={n_envs} not divisible by {n_proc} hosts")
    per_host = n_envs // n_proc
    local = make_local(jax.process_index() * per_host, per_host)

    def to_global(x):
        return jax.make_array_from_process_local_data(sharding, np.asarray(x))

    return jax.tree.map(to_global, local)


def run_with_recovery(
    train_step: Callable[[Any], Tuple[Any, dict]],
    runner: Any,
    n_updates: int,
    checkpointer=None,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
) -> Any:
    """Training loop with checkpoint-based failure recovery.

    On a runtime error (device failure, preemption of a peer), the loop
    restores the latest checkpoint and resumes — the deterministic-restart
    recovery model (SURVEY.md §5).  Raises after ``max_restarts`` failures.
    """
    restarts = 0
    u = int(np.asarray(runner.update_idx))
    if checkpointer is not None and checkpointer.latest_step is None:
        # anchor checkpoint so recovery works before the first periodic save
        checkpointer.save(u, runner)
    while u < n_updates:
        try:
            runner, metrics = train_step(runner)
            u += 1
            if on_metrics is not None:
                on_metrics(u, metrics)
            if checkpointer and u % checkpoint_every == 0:
                checkpointer.save(u, runner)
        except (RuntimeError, jax.errors.JaxRuntimeError):
            restarts += 1
            if restarts > max_restarts or checkpointer is None:
                raise
            time.sleep(1.0)
            runner = checkpointer.restore(template=runner)
            u = int(np.asarray(runner.update_idx))
    return runner
