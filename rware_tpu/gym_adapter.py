"""Gymnasium-compatible adapter over the functional engine.

Drop-in replacement for the reference ``Warehouse(gym.Env)``
(``/root/reference/rware/warehouse.py:140-292``): same constructor surface,
spaces, 5-tuple ``step`` contract, ``reset(seed)`` semantics, ``render`` and
``get_global_image``.  Internally it holds a ``WarehouseState`` pytree and
calls the jitted reset/step programs; the host boundary is exactly one
device->host transfer per step.

The adapter exists for API compatibility and interactive use.  Training
code should use the functional API (``rware_tpu.make`` + vmap/scan) — the
Python-object boundary here caps throughput at host speed by design.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Optional, Tuple

import gymnasium as gym
import numpy as np
import jax
import jax.numpy as jnp

from rware_tpu.config import WarehouseConfig
from rware_tpu.core.env import Warehouse
from rware_tpu.core.observations import build_global_layers_fn
from rware_tpu.core.state import WarehouseState
from rware_tpu.registry import parse_env_id
from rware_tpu.types import (
    DEFAULT_GLOBAL_IMAGE_LAYERS,
    Action,
    Direction,
    ImageLayer,
    ObservationType,
    RewardType,
)


class GymWarehouse(gym.Env):
    """Stateful Gymnasium view of the batched JAX warehouse."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    #: positional parameter order of the reference constructor
    #: (rware/warehouse.py:146-170) for drop-in compatibility.
    _REF_PARAM_ORDER = (
        "shelf_columns",
        "column_height",
        "shelf_rows",
        "n_agents",
        "msg_bits",
        "sensor_range",
        "request_queue_size",
        "max_inactivity_steps",
        "max_steps",
        "reward_type",
        "layout",
        "observation_type",
        "image_observation_layers",
        "image_observation_directional",
        "normalised_coordinates",
        "render_mode",
    )

    def __init__(
        self,
        config: Optional[WarehouseConfig] = None,
        *args,
        env_id: Optional[str] = None,
        **kwargs,
    ):
        if isinstance(config, int):
            # reference-style positional construction:
            # Warehouse(shelf_columns, column_height, ..., reward_type, **kw)
            pos = (config,) + args
            if len(pos) > len(self._REF_PARAM_ORDER):
                raise TypeError(
                    f"Warehouse takes at most {len(self._REF_PARAM_ORDER)} "
                    f"positional arguments ({len(pos)} given)"
                )
            kwargs.update(zip(self._REF_PARAM_ORDER, pos))
            config = None
        elif args:
            raise TypeError("unexpected positional arguments")
        if config is None:
            # env_id is parsed lazily here (not at registration) so that ids
            # whose configs are invalid — the reference registers some, e.g.
            # rware-tiny-17ag-easy-v2 wanting more requests than shelves —
            # fail at construction, matching the reference's reset-time crash.
            # Extra kwargs override the id's config, so
            # gym.make("rware-...-v2", max_steps=1000) works like upstream.
            if env_id:
                config = parse_env_id(env_id)
                if kwargs:
                    import dataclasses

                    config = dataclasses.replace(config, **kwargs)
            else:
                config = WarehouseConfig(**kwargs)
        elif kwargs or env_id:
            raise TypeError("Pass either a config or kwargs, not both")
        self._env = Warehouse(config)
        self.config = config
        self.render_mode = config.render_mode
        self.reward_range = (0, 1)
        self._state: Optional[WarehouseState] = None
        self._renderer = None
        self._global_image_cache = None

        self.action_space = self._build_action_space()
        self.observation_space = self._build_observation_space()

    # -- spaces (reference: rware/warehouse.py:255-288, 352-522) ---------------

    def _build_action_space(self) -> gym.spaces.Tuple:
        cfg = self.config
        if cfg.msg_bits == 0:
            sa = gym.spaces.Discrete(len(Action))
        else:
            sa = gym.spaces.MultiDiscrete([len(Action), *cfg.msg_bits * (2,)])
        return gym.spaces.Tuple(tuple(cfg.n_agents * [sa]))

    def _dict_obs_space(self) -> gym.spaces.Tuple:
        cfg = self.config
        h, w = cfg.grid_size
        max_grid_val = max(cfg.grid_size)
        if cfg.normalised_coordinates:
            high, dtype = np.ones(2), np.float32
        else:
            high, dtype = np.ones(2) * max_grid_val, np.int32
        location_space = gym.spaces.Box(np.zeros(2), high, shape=(2,), dtype=dtype)
        self_space = gym.spaces.Dict(
            OrderedDict(
                location=location_space,
                carrying_shelf=gym.spaces.MultiBinary(1),
                direction=gym.spaces.Discrete(4),
                on_highway=gym.spaces.MultiBinary(1),
            )
        )
        sensor = OrderedDict(
            has_agent=gym.spaces.MultiBinary(1),
            direction=gym.spaces.Discrete(4),
        )
        if cfg.msg_bits > 0:
            sensor["local_message"] = gym.spaces.MultiBinary(cfg.msg_bits)
        sensor["has_shelf"] = gym.spaces.MultiBinary(1)
        sensor["shelf_requested"] = gym.spaces.MultiBinary(1)
        per_agent = gym.spaces.Dict(
            OrderedDict(
                self=self_space,
                sensors=gym.spaces.Tuple(
                    cfg.n_sensor_cells * (gym.spaces.Dict(sensor),)
                ),
            )
        )
        return gym.spaces.Tuple(tuple(cfg.n_agents * [per_agent]))

    def _image_obs_space(self) -> gym.spaces.Tuple:
        cfg = self.config
        shape = (cfg.window_size, cfg.window_size)
        mins, maxs = [], []
        for layer in cfg.image_observation_layers:
            hi = 4.0 if layer == ImageLayer.AGENT_DIRECTION else 1.0
            mins.append(np.zeros(shape, dtype=np.float32))
            maxs.append(np.full(shape, hi, dtype=np.float32))
        box = gym.spaces.Box(np.stack(mins), np.stack(maxs), dtype=np.float32)
        return gym.spaces.Tuple(tuple(cfg.n_agents * [box]))

    def _build_observation_space(self) -> gym.spaces.Tuple:
        cfg = self.config
        ot = cfg.observation_type
        if ot == ObservationType.DICT:
            return self._dict_obs_space()
        if ot == ObservationType.FLATTENED:
            flatdim = cfg.flattened_obs_length
            box = gym.spaces.Box(
                -np.inf, np.inf, shape=(flatdim,), dtype=np.float32
            )
            return gym.spaces.Tuple(tuple(cfg.n_agents * [box]))
        if ot == ObservationType.IMAGE:
            return self._image_obs_space()
        # IMAGE_DICT: {image, features(6,)} per agent (rware/warehouse.py:390-427)
        image_space = self._image_obs_space()[0]
        feature_space = gym.spaces.Box(-np.inf, np.inf, (6,), dtype=np.float32)
        per_agent = gym.spaces.Dict(
            {"image": image_space, "features": feature_space}
        )
        return gym.spaces.Tuple(tuple(cfg.n_agents * [per_agent]))

    # -- observation conversion ------------------------------------------------

    def _flat_to_dict(self, flat: np.ndarray) -> dict:
        """Rebuild the reference's nested DICT obs from one flat vector
        (inverse of the _VectorWriter layout, rware/warehouse.py:631-674)."""
        cfg = self.config
        i = 0

        def take(k):
            nonlocal i
            out = flat[i : i + k]
            i += k
            return out

        loc = take(2)
        if not cfg.normalised_coordinates:
            loc = loc.astype(np.int32)
        obs = {
            "self": {
                "location": loc,
                "carrying_shelf": [int(take(1)[0])],
                "direction": int(np.argmax(take(4))),
                "on_highway": [int(take(1)[0])],
            }
        }
        sensors = []
        for _ in range(cfg.n_sensor_cells):
            cell = OrderedDict()
            cell["has_agent"] = [int(take(1)[0])]
            cell["direction"] = int(np.argmax(take(4)))
            # The reference also emits "local_message": None when msg_bits == 0
            # (warehouse.py:700-702); modern gymnasium Dict.contains rejects
            # the extra key, so it is omitted here unless msg_bits > 0.
            if cfg.msg_bits > 0:
                cell["local_message"] = [int(b) for b in take(cfg.msg_bits)]
            cell["has_shelf"] = [int(take(1)[0])]
            cell["shelf_requested"] = [int(take(1)[0])]
            sensors.append(cell)
        obs["sensors"] = tuple(sensors)
        return obs

    def _convert_obs(self, obs: Any) -> Tuple:
        cfg = self.config
        ot = cfg.observation_type
        if ot == ObservationType.FLATTENED:
            arr = np.asarray(obs, dtype=np.float32)
            return tuple(arr[i] for i in range(cfg.n_agents))
        if ot == ObservationType.DICT:
            arr = np.asarray(obs, dtype=np.float32)
            return tuple(self._flat_to_dict(arr[i]) for i in range(cfg.n_agents))
        if ot == ObservationType.IMAGE:
            arr = np.asarray(obs, dtype=np.float32)
            return tuple(arr[i] for i in range(cfg.n_agents))
        img = np.asarray(obs["image"], dtype=np.float32)
        feat = np.asarray(obs["features"], dtype=np.float32)
        return tuple(
            {"image": img[i], "features": feat[i]} for i in range(cfg.n_agents)
        )

    # -- gym API ---------------------------------------------------------------

    def seed(self, seed: Optional[int] = None):
        """Legacy seeding API (reference: rware/warehouse.py:962-964):
        stores the seed for the next reset."""
        self._pending_seed = seed
        return [seed]

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        pending = getattr(self, "_pending_seed", None)
        self._pending_seed = None  # a stored legacy seed applies exactly once
        if seed is None:
            seed = pending
        if seed is None:
            seed = int(self.np_random.integers(0, 2**31 - 1))
        state, obs = self._env.reset(jax.random.key(seed))
        self._state = state
        self._global_image_cache = None
        return self._convert_obs(obs), {}

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("Call reset() before step()")
        cfg = self.config
        if cfg.msg_bits > 0:
            acts = jnp.asarray(
                np.stack([np.asarray(a, dtype=np.int32) for a in actions])
            )
        else:
            acts = jnp.asarray(np.asarray(actions, dtype=np.int32))
        res = self._env.step(self._state, acts)
        self._state = res.state
        self._global_image_cache = None
        rewards = [float(r) for r in np.asarray(res.rewards)]
        info = {k: np.asarray(v) for k, v in res.info.items()}
        return (
            self._convert_obs(res.obs),
            rewards,
            bool(res.done),
            bool(res.truncated),
            info,
        )

    def render(self):
        from rware_tpu.rendering import Viewer

        if self._renderer is None:
            self._renderer = Viewer(self.config)
        return self._renderer.render(
            self._state, return_rgb_array=self.render_mode == "rgb_array"
        )

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None

    # -- reference-surface conveniences ---------------------------------------

    @property
    def state(self) -> WarehouseState:
        """The underlying device state (read/replace for test injection)."""
        return self._state

    @state.setter
    def state(self, value: WarehouseState):
        self._state = value
        self._global_image_cache = None

    @property
    def n_agents(self) -> int:
        return self.config.n_agents

    @property
    def grid_size(self) -> Tuple[int, int]:
        return self.config.grid_size

    @property
    def request_queue(self) -> List[int]:
        return np.asarray(self._state.request_queue).tolist()

    @property
    def goals(self) -> List[Tuple[int, int]]:
        return [tuple(g) for g in self._env.layout.goals.tolist()]

    @property
    def highways(self) -> np.ndarray:
        return self._env.layout.highways

    def get_global_image(
        self,
        image_layers=DEFAULT_GLOBAL_IMAGE_LAYERS,
        recompute: bool = False,
        pad_to_shape: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """Global layer-stack view (reference: rware/warehouse.py:966-1040):
        cached until the state changes, optional centre-pad to a target shape."""
        if self._global_image_cache is None or recompute:
            # jit cache is keyed per layers-tuple: repeated calls after state
            # changes reuse the compiled program instead of re-tracing
            layers = tuple(image_layers)
            if not hasattr(self, "_global_image_fns"):
                self._global_image_fns = {}
            if layers not in self._global_image_fns:
                self._global_image_fns[layers] = jax.jit(
                    build_global_layers_fn(self.config, layers)
                )
            img = np.asarray(self._global_image_fns[layers](self._state))
            if pad_to_shape is not None:
                # Reference semantics (warehouse.py:1022-1039): zip the target
                # shape against leading axes of (C, H, W); before = floor,
                # after = ceil of the split.
                dims = [
                    target - cur
                    for target, cur in zip(pad_to_shape, img.shape)
                ]
                if any(d < 0 for d in dims):
                    raise ValueError("pad_to_shape smaller than global image")
                pad = [(d // 2, d - d // 2) for d in dims]
                pad += [(0, 0)] * (img.ndim - len(pad))
                img = np.pad(img, pad)
            self._global_image_cache = img
        return self._global_image_cache


def make_gym(env_id_or_config, **overrides) -> GymWarehouse:
    """Create a Gymnasium-style env from an id string or config."""
    if isinstance(env_id_or_config, str):
        config = parse_env_id(env_id_or_config)
    else:
        config = env_id_or_config
    if overrides:
        import dataclasses

        config = dataclasses.replace(config, **overrides)
    return GymWarehouse(config)


def register_all(force: bool = False, image: bool = False) -> int:
    """Register the reference's default env-id grid with gymnasium
    (mirror of rware/__init__.py:22-39: 4 sizes x 1-19 agents x 3
    difficulties; ``image=True`` adds the -img/-imgdict/-Nd variants of
    ``image_registration``, rware/__init__.py:42-80).  Runs at
    ``import rware_tpu`` by default, matching the reference's import-time
    behavior (RWARE_TPU_NO_REGISTER=1 opts out); already-registered ids
    are skipped unless ``force``, so this package can coexist with the
    reference in one process.  Any OTHER valid id from the naming
    grammar (sensor ranges, column heights, RxC grids — the reference's
    ``full_registration`` space) works without registration through
    ``rware_tpu.make_gym``.  Returns the number of ids registered."""
    from rware_tpu.registry import SIZES

    prefixes = ["rware"]
    if image:
        prefixes += [
            "rware-img",
            "rware-imgdict",
            "rware-img-Nd",
            "rware-imgdict-Nd",
        ]
    count = 0
    for prefix in prefixes:
        for size in SIZES:
            for n_agents in range(1, 20):
                for diff in ["", "-easy", "-hard"]:
                    env_id = f"{prefix}-{size}-{n_agents}ag{diff}-v2"
                    if env_id in gym.registry and not force:
                        continue
                    gym.register(
                        id=env_id,
                        entry_point="rware_tpu.gym_adapter:GymWarehouse",
                        vector_entry_point="rware_tpu.vector:vector_entry_point",
                        kwargs={"env_id": env_id},
                    )
                    count += 1
    return count


def register_full(
    sensor_ranges=range(2, 6),
    column_heights=range(1, 16),
    force: bool = False,
) -> int:
    """Register the ``full_registration`` variants (rware/__init__.py:83-175):
    sensor-range ``-<S>s`` and column-height ``-<H>h`` grids over the default
    sizes/agents/difficulties.  The reference registers ~100k ids eagerly at
    import (taking minutes); here both grids stay opt-in and any further id
    from the grammar (e.g. explicit RxC) still works unregistered through
    :func:`make_gym`.  Returns the number of ids registered."""
    from rware_tpu.registry import SIZES

    count = 0
    variants = [f"rware-{s}s" for s in sensor_ranges]
    heights = list(column_heights)
    for size in SIZES:
        for n_agents in range(1, 20):
            for diff in ["", "-easy", "-hard"]:
                ids = [
                    f"{v}-{size}-{n_agents}ag{diff}-v2" for v in variants
                ] + [
                    f"rware-{size}-{h}h-{n_agents}ag{diff}-v2" for h in heights
                ]
                for env_id in ids:
                    if env_id in gym.registry and not force:
                        continue
                    gym.register(
                        id=env_id,
                        entry_point="rware_tpu.gym_adapter:GymWarehouse",
                        vector_entry_point="rware_tpu.vector:vector_entry_point",
                        kwargs={"env_id": env_id},
                    )
                    count += 1
    return count
