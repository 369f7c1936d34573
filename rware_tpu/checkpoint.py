"""Checkpoint / resume: the whole training state is one pytree on device.

The reference has no checkpointing — env state lives in scattered Python
objects and the only resume story is ``reset(seed)`` determinism (SURVEY.md
§5).  Here everything (env-batch state, learner params, optimiser moments,
PRNG keys, counters) is a pytree of arrays, so persistence is orbax over one
tree: save is async-capable and sharded-array aware, restore is bit-exact —
resuming a training run reproduces the exact trajectory stream it would have
produced uninterrupted (covered by tests/test_checkpoint.py).

Typed PRNG keys are converted to raw key data on save and re-wrapped on
restore (orbax serialises plain arrays only).
"""
from __future__ import annotations

import os
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np


def _is_typed_key(x) -> bool:
    return isinstance(x, jax.Array) and jnp.issubdtype(x.dtype, jax.dtypes.prng_key)


_KEY_MARKER = "__prng_key_data__"
_EMPTY_SHAPE = "__empty_shape__"
_EMPTY_DTYPE = "__empty_dtype_utf8__"


def pack_keys(tree: Any) -> Any:
    """Make a pytree orbax-serialisable.

    Two rewrites: typed PRNG-key leaves become raw key data (restore re-wraps
    with the process-default impl — the only impl this framework creates),
    and zero-size arrays (e.g. ``agent_message`` at msg_bits=0, which orbax
    refuses) become shape+dtype records.
    """

    def pack(x):
        if _is_typed_key(x):
            return {_KEY_MARKER: jax.random.key_data(x)}
        if hasattr(x, "size") and x.size == 0:
            return {
                _EMPTY_SHAPE: np.asarray(x.shape, dtype=np.int32),
                _EMPTY_DTYPE: np.frombuffer(
                    str(x.dtype).encode("utf-8"), dtype=np.uint8
                ).copy(),
            }
        return x

    return jax.tree.map(pack, tree, is_leaf=_is_typed_key)


def unpack_keys(tree: Any) -> Any:
    """Inverse of :func:`pack_keys`."""

    def is_packed(x):
        return isinstance(x, dict) and (_KEY_MARKER in x or _EMPTY_SHAPE in x)

    def unpack(x):
        if isinstance(x, dict) and _KEY_MARKER in x:
            return jax.random.wrap_key_data(jnp.asarray(x[_KEY_MARKER]))
        if isinstance(x, dict) and _EMPTY_SHAPE in x:
            dtype = bytes(np.asarray(x[_EMPTY_DTYPE])).decode("utf-8")
            return jnp.zeros(
                tuple(int(d) for d in np.asarray(x[_EMPTY_SHAPE])), dtype=dtype
            )
        return x

    return jax.tree.map(unpack, tree, is_leaf=is_packed)


class Checkpointer:
    """Thin orbax wrapper: numbered step checkpoints under one directory."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        import orbax.checkpoint as ocp

        self.directory = os.path.abspath(directory)
        self._mgr = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True
            ),
        )

    def save(self, step: int, tree: Any, wait: bool = False) -> None:
        import orbax.checkpoint as ocp

        self._mgr.save(step, args=ocp.args.StandardSave(pack_keys(tree)))
        if wait:
            self._mgr.wait_until_finished()

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        import orbax.checkpoint as ocp

        if step is None:
            step = self._mgr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if template is not None:
            packed = self._mgr.restore(
                step,
                args=ocp.args.StandardRestore(pack_keys(template)),
            )
        else:
            try:
                packed = self._mgr.restore(step)
            except ValueError as e:
                if "not found in jax.local_devices" not in str(e):
                    raise
                # cross-platform restore (e.g. a GPU-trained checkpoint
                # evaluated on CPU): the saved sharding names devices this
                # process doesn't have — re-read every leaf as host numpy
                # from the array metadata instead
                packed = self._restore_as_numpy(step)
        return unpack_keys(packed)

    def _restore_as_numpy(self, step: int) -> Any:
        import orbax.checkpoint as ocp

        path = os.path.join(self.directory, str(step), "default")
        ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler())
        meta = ckptr.metadata(path).item_metadata
        restore_args = jax.tree.map(
            lambda m: ocp.RestoreArgs(restore_type=np.ndarray), meta.tree
        )
        return ckptr.restore(
            path, args=ocp.args.PyTreeRestore(restore_args=restore_args)
        )

    @property
    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def close(self):
        self._mgr.wait_until_finished()
        self._mgr.close()
