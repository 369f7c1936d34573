"""Frozen dataclasses registered as JAX pytrees.

Every field is a pytree child, so an instance passes through ``jit``,
``vmap``, ``lax.scan``, sharding and checkpointing like a tuple of its
fields.  ``replace`` returns a copy with some fields changed.
"""
from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Decorator: ``cls`` as a frozen dataclass, registered as a pytree
    node whose children are its fields, with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
