"""Persistent XLA compilation cache wiring.

Without a persistent cache every new process compiles its programs again.
JAX ships a disk-backed executable cache keyed on the serialized HLO and
the compile options; pointing it at a stable directory turns a later
process's compile into a deserialization.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at a fixed path
inside the checkout, :data:`REPO_CACHE_DIR` (``<repo>/.jax_cache``, listed
in ``.gitignore``).  Call :func:`enable_persistent_cache` before building
any jitted program (train.py, bench.py, evaluate.py and chip_smoke.py do
this at startup).  Opt out with ``RWARE_TPU_NO_CACHE=1``.
"""
from __future__ import annotations

import os
from typing import Optional

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_persistent_cache() -> Optional[str]:
    """Turn on the persistent compilation cache and drop the size/time
    thresholds so every program is cached.  Returns the cache directory,
    or None when disabled via RWARE_TPU_NO_CACHE=1."""
    if os.environ.get("RWARE_TPU_NO_CACHE"):
        return None
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # the default thresholds skip sub-second compiles; cache them all
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
