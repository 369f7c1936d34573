"""rware_tpu — a JAX multi-robot warehouse (RWARE) framework.

A ground-up JAX/XLA re-design of ``semitable/robotic-warehouse``: the entire
environment — state, collision resolution, dynamics, rewards, observations —
is a pure, shape-static XLA program that ``vmap``s over thousands of
environments per device and shards over device meshes, while preserving the
reference's behavioural semantics (validated by golden and differential
tests).

Quick start::

    import jax, rware_tpu

    env = rware_tpu.make("rware-tiny-2ag-v2")
    state, obs = env.reset(jax.random.key(0))
    result = env.step(state, env.sample_actions(jax.random.key(1)))
"""

import os

from rware_tpu.config import WarehouseConfig
from rware_tpu.core.env import Warehouse
from rware_tpu.core.engine import StepResult
from rware_tpu.core.state import WarehouseState
from rware_tpu.registry import make, parse_env_id


def make_gym(env_id_or_config, **overrides):
    """Gymnasium-style adapter env (lazy import keeps gymnasium optional)."""
    from rware_tpu.gym_adapter import make_gym as _make_gym

    return _make_gym(env_id_or_config, **overrides)


def make_vec(env_id_or_config, num_envs=8, **overrides):
    """Gymnasium ``VectorEnv`` over the batched engine (lazy import)."""
    from rware_tpu.vector import make_vec as _make_vec

    return _make_vec(env_id_or_config, num_envs, **overrides)


def register_all(force=False, image=False):
    """Register the reference env-id grid with gymnasium (lazy import);
    ``image=True`` adds the -img/-imgdict/-Nd variants.  Runs once at
    import by default — call explicitly only after RWARE_TPU_NO_REGISTER=1
    or to add the image variants (see gym_adapter.register_all)."""
    from rware_tpu.gym_adapter import register_all as _register_all

    return _register_all(force=force, image=image)


from rware_tpu.types import (
    Action,
    Direction,
    ImageLayer,
    ObservationType,
    RewardType,
)

__version__ = "0.1.0"

# Drop-in compatibility: the reference registers its default env-id grid as
# an import side effect (rware/__init__.py:22-39), so users following its
# README expect `import` -> `gym.make` to just work.  Match that by default;
# RWARE_TPU_NO_REGISTER=1 (or RWARE_TPU_AUTO_REGISTER=0) opts out, and
# RWARE_TPU_AUTO_REGISTER=image additionally registers the -img/-imgdict
# variants (image_registration, rware/__init__.py:42-80).  register_all
# skips ids another package (e.g. the reference itself) already registered,
# so both can coexist in one process.
_auto = os.environ.get("RWARE_TPU_AUTO_REGISTER", "1").lower()
if os.environ.get("RWARE_TPU_NO_REGISTER", "").lower() in ("1", "true"):
    _auto = "0"
if _auto not in ("0", "false", ""):
    try:
        from rware_tpu.gym_adapter import register_all as _register_all

        _register_all(image=_auto == "image")
    except ImportError:  # gymnasium not installed: the JAX API still works
        pass

__all__ = [
    "Action",
    "Direction",
    "ImageLayer",
    "ObservationType",
    "RewardType",
    "StepResult",
    "Warehouse",
    "WarehouseConfig",
    "WarehouseState",
    "make",
    "make_gym",
    "make_vec",
    "parse_env_id",
    "register_all",
    "__version__",
]
