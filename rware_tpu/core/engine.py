"""The warehouse dynamics: pure, jittable reset/step programs.

This is the batched, jittable replacement for the reference's ``Warehouse.reset`` /
``Warehouse.step`` (``/root/reference/rware/warehouse.py:757-946``): the whole
transition — action decode, collision resolution, movement, load toggles,
delivery, request-queue resampling, rewards, termination and observation — is
one pure function of ``(state, actions)``, traced once and compiled by XLA.
A batch of environments is ``jax.vmap(step)``; a rollout is ``lax.scan``.

Semantics notes (each validated against the reference by the golden tests):
  * target cells are edge-clamped (rware/warehouse.py:102-116) so walking into
    a wall is a committed no-move;
  * the loaded-agent pre-cancel (rware/warehouse.py:829-843) downgrades the
    action to NOOP *before* resolution;
  * deliveries are processed goal-by-goal in goal order because each delivery
    immediately resamples the queue, shrinking the candidate set for the next
    goal (rware/warehouse.py:903-927);
  * on delivery with nobody on the goal cell the reference indexes
    ``rewards[agent_id - 1]`` with ``agent_id == 0``, silently crediting the
    LAST agent (Python -1 wraparound).  Reproduced here for parity — it is
    unreachable in normal play (shelves only reach goals while carried).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rware_tpu.config import WarehouseConfig
from rware_tpu.core.observations import (
    build_flattened_obs_fn,
    build_image_dict_features_fn,
    build_image_obs_fn,
)
from rware_tpu.core.state import WarehouseState
from rware_tpu.ops.resolver import resolve_moves
from rware_tpu.types import Action, ObservationType, RewardType

# Rotation tables in Direction-enum coding (UP=0, DOWN=1, LEFT=2, RIGHT=3).
# Physical rotation order is UP -> RIGHT -> DOWN -> LEFT (rware/warehouse.py:118-125).
ROT_RIGHT = np.array([3, 2, 0, 1], dtype=np.int32)  # d -> clockwise(d)
ROT_LEFT = np.array([2, 3, 1, 0], dtype=np.int32)  # d -> counterclockwise(d)

# Forward displacement per Direction (dx, dy).
DIR_DX = np.array([0, 0, -1, 1], dtype=np.int32)
DIR_DY = np.array([-1, 1, 0, 0], dtype=np.int32)


class StepResult(NamedTuple):
    state: WarehouseState
    obs: Any
    rewards: jax.Array  # (N,) float32
    done: jax.Array  # () bool
    truncated: jax.Array  # () bool — always False, matching rware/warehouse.py:942
    info: Dict[str, jax.Array]


def build_obs_fn(config: WarehouseConfig) -> Callable[[WarehouseState], Any]:
    """Observation function for the configured observation family.

    DICT observations share the FLATTENED device kernel: the reference
    guarantees flatten(DICT) == FLATTENED bit-for-bit
    (tests/test_env.py:406-512), so the nested-dict view is reconstructed
    host-side by the gym adapter from the flat vector.
    """
    obs_type = config.observation_type
    if obs_type in (ObservationType.FLATTENED, ObservationType.DICT):
        return build_flattened_obs_fn(config)
    if obs_type == ObservationType.IMAGE:
        return build_image_obs_fn(config)
    if obs_type == ObservationType.IMAGE_DICT:
        image_fn = build_image_obs_fn(config)
        feat_fn = build_image_dict_features_fn(config)
        return lambda state: {"image": image_fn(state), "features": feat_fn(state)}
    raise ValueError(f"Unknown observation type: {obs_type}")


def build_reset_fn(
    config: WarehouseConfig,
) -> Callable[[jax.Array], WarehouseState]:
    """Returns ``reset(key) -> state`` for one env (vmap for a batch).

    Mirrors rware/warehouse.py:757-800: shelves spawn at their row-major rack
    slots; agents spawn uniformly over ALL cells (shelf slots included)
    without replacement, with uniform directions; the request queue is a
    uniform sample of shelves without replacement.
    """
    layout = config.compile_layout()
    height, width = layout.grid_size
    n, s, r = config.n_agents, layout.n_shelves, config.request_queue_size
    slots_x = jnp.asarray(layout.shelf_slots[:, 0])
    slots_y = jnp.asarray(layout.shelf_slots[:, 1])

    def reset(key: jax.Array) -> WarehouseState:
        k_loc, k_dir, k_queue, k_state = jax.random.split(key, 4)
        cells = jax.random.choice(
            k_loc, height * width, shape=(n,), replace=False
        ).astype(jnp.int32)
        return WarehouseState(
            agent_x=cells % width,
            agent_y=cells // width,
            agent_dir=jax.random.randint(k_dir, (n,), 0, 4, dtype=jnp.int32),
            agent_carrying=jnp.full((n,), -1, dtype=jnp.int32),
            agent_has_delivered=jnp.zeros((n,), dtype=bool),
            agent_message=jnp.zeros((n, config.msg_bits), dtype=jnp.float32),
            shelf_x=slots_x,
            shelf_y=slots_y,
            request_queue=jax.random.choice(
                k_queue, s, shape=(r,), replace=False
            ).astype(jnp.int32),
            cur_steps=jnp.zeros((), dtype=jnp.int32),
            cur_inactive_steps=jnp.zeros((), dtype=jnp.int32),
            key=k_state,
        )

    return reset


def _masked_uniform_pick(key: jax.Array, mask: jax.Array) -> jax.Array:
    """Uniform sample of one True index of ``mask`` (assumes >= 1 True)."""
    count = jnp.sum(mask.astype(jnp.int32))
    k = jax.random.randint(key, (), 0, jnp.maximum(count, 1))
    # Index of the (k+1)-th set bit.
    return jnp.argmax(jnp.cumsum(mask.astype(jnp.int32)) > k).astype(jnp.int32)


def build_step_fn(
    config: WarehouseConfig,
    obs_fn: Optional[Callable[[WarehouseState], Any]] = None,
) -> Callable[[WarehouseState, jax.Array], StepResult]:
    """Returns ``step(state, actions) -> StepResult`` for one env.

    ``actions`` is (N,) int32 when msg_bits == 0, else (N, 1 + msg_bits) with
    the action in column 0 and the broadcast message bits after
    (rware/warehouse.py:809-814).
    """
    layout = config.compile_layout()
    height, width = layout.grid_size
    n = config.n_agents
    n_shelves = layout.n_shelves
    goals_x = jnp.asarray(layout.goals[:, 0])
    goals_y = jnp.asarray(layout.goals[:, 1])
    n_goals = layout.n_goals
    highways = jnp.asarray(layout.highways.astype(bool))
    reward_type = config.reward_type
    if obs_fn is None:
        obs_fn = build_obs_fn(config)
    rot_left = jnp.asarray(ROT_LEFT)
    rot_right = jnp.asarray(ROT_RIGHT)
    dir_dx = jnp.asarray(DIR_DX)
    dir_dy = jnp.asarray(DIR_DY)

    def step(state: WarehouseState, actions: jax.Array) -> StepResult:
        step_key, next_key = jax.random.split(state.key)

        if config.msg_bits > 0:
            acts = actions[:, 0].astype(jnp.int32)
            message = actions[:, 1:].astype(jnp.float32)
        else:
            acts = actions.astype(jnp.int32).reshape(n)
            message = state.agent_message

        ax, ay, adir = state.agent_x, state.agent_y, state.agent_dir
        carrying = state.agent_carrying  # (N,) shelf index or -1

        # --- requested target cells, edge-clamped (rware/warehouse.py:102-116).
        is_forward = acts == Action.FORWARD
        tx = jnp.clip(ax + jnp.where(is_forward, dir_dx[adir], 0), 0, width - 1)
        ty = jnp.clip(ay + jnp.where(is_forward, dir_dy[adir], 0), 0, height - 1)

        # --- pre-cancel: loaded agent moving onto a standing shelf, unless
        # that shelf is held by a loaded agent at the target
        # (rware/warehouse.py:829-843).
        shelf_at_target = jnp.any(
            (tx[:, None] == state.shelf_x[None, :])
            & (ty[:, None] == state.shelf_y[None, :]),
            axis=1,
        )
        agent_at_target = (tx[:, None] == ax[None, :]) & (ty[:, None] == ay[None, :])
        target_agent_loaded = jnp.any(agent_at_target & (carrying[None, :] >= 0), axis=1)
        moving = (tx != ax) | (ty != ay)
        cancelled = (
            (carrying >= 0) & moving & shelf_at_target & ~target_agent_loaded
        )
        acts = jnp.where(cancelled, Action.NOOP, acts)
        tx = jnp.where(cancelled, ax, tx)
        ty = jnp.where(cancelled, ay, ty)

        # --- collision resolution (the masked-commit kernel).
        committed = resolve_moves(ax, ay, tx, ty)
        # Failed agents were necessarily FORWARD (rware/warehouse.py:874-876)
        # and are downgraded to NOOP.
        acts = jnp.where(committed, acts, Action.NOOP)

        # --- execute movement (rware/warehouse.py:880-899).
        moved = committed & (acts == Action.FORWARD)
        new_ax = jnp.where(moved, tx, ax)
        new_ay = jnp.where(moved, ty, ay)
        new_dir = jnp.where(
            acts == Action.LEFT,
            rot_left[adir],
            jnp.where(acts == Action.RIGHT, rot_right[adir], adir),
        )

        # Carried shelves ride along: scatter new coords at carried indices
        # (out-of-range index for non-carriers drops the write).
        carry_idx = jnp.where(moved & (carrying >= 0), carrying, n_shelves)
        new_sx = state.shelf_x.at[carry_idx].set(new_ax, mode="drop")
        new_sy = state.shelf_y.at[carry_idx].set(new_ay, mode="drop")

        # Toggle load: pickup of a standing shelf under the agent; drops only
        # off-highway.  Shelf/agent co-location rules make the stale-grid read
        # in the reference equivalent to using pre-step shelf positions.
        toggling = acts == Action.TOGGLE_LOAD
        under = (new_ax[:, None] == state.shelf_x[None, :]) & (
            new_ay[:, None] == state.shelf_y[None, :]
        )
        shelf_under = jnp.where(
            jnp.any(under, axis=1), jnp.argmax(under, axis=1), -1
        ).astype(jnp.int32)
        pickup = toggling & (carrying < 0) & (shelf_under >= 0)

        on_highway = highways[new_ay, new_ax]
        drop = toggling & (carrying >= 0) & ~on_highway
        rewards = jnp.zeros((n,), dtype=jnp.float32)
        if reward_type == RewardType.TWO_STAGE:
            rewards = rewards + jnp.where(
                drop & state.agent_has_delivered, 0.5, 0.0
            )
        new_carrying = jnp.where(
            pickup, shelf_under, jnp.where(drop, -1, carrying)
        )
        new_has_delivered = jnp.where(drop, False, state.agent_has_delivered)

        # --- deliveries, queue resampling and rewards, goal by goal
        # (rware/warehouse.py:903-927).
        shelf_ids = jnp.arange(n_shelves, dtype=jnp.int32)

        def goal_body(g, carry_state):
            queue, rewards, has_delivered, n_delivered = carry_state
            gx, gy = goals_x[g], goals_y[g]
            at_goal = (new_sx == gx) & (new_sy == gy)
            sid = jnp.where(jnp.any(at_goal), jnp.argmax(at_goal), -1).astype(
                jnp.int32
            )
            slot_match = queue == sid
            delivered = (sid >= 0) & jnp.any(slot_match)
            slot = jnp.argmax(slot_match)

            # Replacement: uniform over shelves not currently queued; the
            # delivered shelf is still queued at sampling time and therefore
            # excluded (rware/warehouse.py:915-917).  When EVERY shelf is
            # queued (request_queue_size == n_shelves — the reference crashes
            # on np_random.choice([]) here) the delivered shelf simply stays
            # requested.
            in_queue = jnp.any(queue[:, None] == shelf_ids[None, :], axis=0)
            has_candidate = jnp.any(~in_queue)
            new_req = jnp.where(
                has_candidate,
                _masked_uniform_pick(
                    jax.random.fold_in(step_key, g), ~in_queue
                ),
                sid,
            )
            queue = jnp.where(delivered, queue.at[slot].set(new_req), queue)

            agent_at_goal = (new_ax == gx) & (new_ay == gy)
            # Reference quirk: no agent on the goal credits the LAST agent via
            # rewards[0 - 1] (rware/warehouse.py:921-927).
            aid = jnp.where(
                jnp.any(agent_at_goal), jnp.argmax(agent_at_goal), n - 1
            )
            if reward_type == RewardType.GLOBAL:
                rewards = rewards + jnp.where(delivered, 1.0, 0.0)
            elif reward_type == RewardType.INDIVIDUAL:
                rewards = rewards.at[aid].add(jnp.where(delivered, 1.0, 0.0))
            else:  # TWO_STAGE
                rewards = rewards.at[aid].add(jnp.where(delivered, 0.5, 0.0))
                has_delivered = has_delivered.at[aid].set(
                    jnp.where(delivered, True, has_delivered[aid])
                )
            return (
                queue,
                rewards,
                has_delivered,
                n_delivered + delivered.astype(jnp.int32),
            )

        if config.request_queue_size > 0:
            queue, rewards, new_has_delivered, n_delivered = jax.lax.fori_loop(
                0,
                n_goals,
                goal_body,
                (
                    state.request_queue,
                    rewards,
                    new_has_delivered,
                    jnp.zeros((), jnp.int32),
                ),
                unroll=True,
            )
        else:
            # Empty request queue (legal, see config): nothing can ever be
            # delivered, so the whole delivery section compiles away.
            queue, n_delivered = state.request_queue, jnp.zeros((), jnp.int32)
        any_delivered = n_delivered > 0

        # --- termination (rware/warehouse.py:929-942).
        inactive = jnp.where(any_delivered, 0, state.cur_inactive_steps + 1)
        steps = state.cur_steps + 1
        done = jnp.asarray(False)
        if config.max_inactivity_steps:
            done = done | (inactive >= config.max_inactivity_steps)
        if config.max_steps:
            done = done | (steps >= config.max_steps)

        new_state = state.replace(
            agent_x=new_ax,
            agent_y=new_ay,
            agent_dir=new_dir,
            agent_carrying=new_carrying,
            agent_has_delivered=new_has_delivered,
            agent_message=message,
            shelf_x=new_sx,
            shelf_y=new_sy,
            request_queue=queue,
            cur_steps=steps,
            cur_inactive_steps=inactive,
            key=next_key,
        )

        info = {
            "deliveries": n_delivered,
            "failed_moves": jnp.sum((~committed).astype(jnp.int32)),
        }
        return StepResult(
            state=new_state,
            obs=obs_fn(new_state),
            rewards=rewards,
            done=done,
            truncated=jnp.asarray(False),
            info=info,
        )

    return step
