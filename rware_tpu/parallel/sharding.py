"""Device-mesh sharding of the env batch (and learner parameters).

The reference is single-process with no distributed layer (SURVEY.md §2).
Scale-out here is the canonical JAX recipe: one ``Mesh`` whose ``env`` axis
spans all devices, env-batched state pytrees sharded on their leading axis,
parameters replicated.  Every learner's train step is one jitted program:
XLA partitions it from those input shardings and inserts the collectives
(NCCL all-reduces of the gradients on GPUs); nothing in the engine or the
learners changes, and a sharded step computes what the unsharded one does.

Multi-host usage: call ``jax.distributed.initialize()`` first, build the mesh
over ``jax.devices()`` (global), and create sharded batches with
``make_array_from_process_local_data`` — the helpers below work unchanged.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None, axis: str = ENV_AXIS
) -> Mesh:
    """1-D mesh over all (or the given) devices, named ``env`` by default."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def env_sharding(mesh: Mesh, axis: str = ENV_AXIS) -> NamedSharding:
    """Sharding that splits a leading env-batch axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_batch(tree: Any, mesh: Mesh, axis: str = ENV_AXIS) -> Any:
    """Place every leaf of an env-batched pytree with its leading axis split
    across the mesh.  Leaf shapes must be divisible by the mesh size.

    Multi-process safe: when the mesh spans devices of several processes
    (``jax.process_count() > 1``), each process contributes its own slice
    of the (host-identical) full-size leaves via
    ``make_array_from_process_local_data`` — device_put cannot address the
    other hosts' devices.  Every process must hold the same full batch
    (same seeds); for host-memory-flat assembly from per-host slices use
    rware_tpu.distributed.global_env_batch instead."""
    sharding = env_sharding(mesh, axis)
    if jax.process_count() == 1:
        return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)

    def local_rows(global_shape):
        """This process's owned [lo, hi) of the global leading axis,
        derived from the sharding's device assignment (NOT assumed to be
        the process_index-th contiguous block: a mesh built from a
        reordered device list owns a different slice, and the old
        pid-block assumption would assemble a wrong global batch
        silently)."""
        idx_map = sharding.devices_indices_map(tuple(global_shape))
        rows = sorted(
            {
                (
                    idx_map[d][0].start or 0,
                    idx_map[d][0].stop
                    if idx_map[d][0].stop is not None
                    else global_shape[0],
                )
                for d in sharding.addressable_devices
            }
        )
        lo, hi = rows[0][0], rows[-1][1]
        covered = lo
        for start, stop in rows:
            if start > covered:
                raise ValueError(
                    "shard_env_batch needs each process to own one "
                    f"contiguous block of the env axis; got rows {rows} "
                    "for this process (device-to-process assignment is "
                    "interleaved) — build the mesh from jax.devices() "
                    "order or use rware_tpu.distributed.global_env_batch"
                )
            covered = max(covered, stop)
        return lo, hi

    def leaf(x):
        # typed PRNG keys can't cross the numpy boundary: ship the raw
        # uint32 key data and rewrap
        if jax.dtypes.issubdtype(
            getattr(x, "dtype", None), jax.dtypes.prng_key
        ):
            g = leaf(jax.random.key_data(x))
            return jax.random.wrap_key_data(
                g, impl=jax.random.key_impl(x)
            )
        x = np.asarray(x)
        lo, hi = local_rows(x.shape)
        return jax.make_array_from_process_local_data(
            sharding, x[lo:hi], global_shape=x.shape
        )

    return jax.tree.map(leaf, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate a pytree (e.g. model parameters) on every device.

    Multi-process safe: each process supplies the (identical) host value
    as its local shard."""
    sharding = replicated(mesh)
    if jax.process_count() == 1:
        return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)

    def leaf(x):
        if jax.dtypes.issubdtype(
            getattr(x, "dtype", None), jax.dtypes.prng_key
        ):
            g = leaf(jax.random.key_data(x))
            return jax.random.wrap_key_data(
                g, impl=jax.random.key_impl(x)
            )
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            sharding, x, global_shape=x.shape
        )

    return jax.tree.map(leaf, tree)
