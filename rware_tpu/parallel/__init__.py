from rware_tpu.parallel.rollout import (
    Trajectory,
    autoreset_select,
    batched_reset,
    build_batched_rollout_fn,
    build_rollout_fn,
    random_policy,
)
from rware_tpu.parallel.sharding import (
    ENV_AXIS,
    env_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_env_batch,
)

__all__ = [
    "ENV_AXIS",
    "Trajectory",
    "autoreset_select",
    "batched_reset",
    "build_batched_rollout_fn",
    "build_rollout_fn",
    "env_sharding",
    "make_mesh",
    "random_policy",
    "replicate",
    "replicated",
    "shard_env_batch",
]
