"""Dynamics scenarios on the XLA engine (core/engine.py) and the batched
rollout (parallel/rollout.py): scripted deliveries and the queue rule,
episode counting under autoreset, message bits, an empty request queue,
two goals delivering in one step, crowded-grid invariants at up to 19
agents, and the batched rollout against one env stepped alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rware_tpu
from rware_tpu.parallel import batched_reset, build_batched_rollout_fn
from rware_tpu.testing import DOWN, UP, make_state
from rware_tpu.types import Action


def _broadcast(state, n):
    batched = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), state)
    return batched.replace(key=jax.random.split(jax.random.key(0), n))


def _noop_policy(env):
    return lambda key, obs: jnp.zeros(
        (env.n_agents,) if env.config.msg_bits == 0
        else (env.n_agents, 1 + env.config.msg_bits),
        jnp.int32,
    )


def _states_over_time(env, states, actions):
    """Step a batch through (T, B, N) actions without autoreset; returns
    the (T+1, B, ...) stacked states and (T, B, N) rewards."""
    step = jax.vmap(env._step_fn)

    def body(s, a):
        r = step(s, a)
        return r.state, (r.state, r.rewards)

    _, (seq, rew) = jax.jit(lambda s, a: jax.lax.scan(body, s, a))(
        states, actions
    )
    seq = jax.tree.map(lambda a, b: jnp.concatenate([a[None], b]), states, seq)
    return seq, rew


def test_delivery_reward_and_queue_rule():
    """Agent 0 carries requested shelf 0 one cell above the goal; FORWARD
    delivers: +1 to agent 0 (INDIVIDUAL), the slot is refilled with a
    uniformly drawn shelf that was NOT queued (the delivered one was still
    queued at sampling time), the other slot stays, inactivity resets."""
    env = rware_tpu.make("rware-tiny-2ag-v2")
    gx, gy = (int(v) for v in env.layout.goals[0])
    single = make_state(
        env.config, [(gx, gy - 1, DOWN), (0, 0, UP)],
        carrying=[0, -1], queue=[0, 1],
    )
    single = single.replace(cur_inactive_steps=jnp.int32(7))
    states = _broadcast(single, 256)
    res = jax.jit(jax.vmap(env._step_fn))(
        states, jnp.broadcast_to(jnp.asarray([1, 0], jnp.int32), (256, 2))
    )
    np.testing.assert_array_equal(np.asarray(res.rewards[:, 0]), 1.0)
    np.testing.assert_array_equal(np.asarray(res.rewards[:, 1]), 0.0)
    q = np.asarray(res.state.request_queue)
    assert (q[:, 1] == 1).all()
    assert not np.isin(q[:, 0], [0, 1]).any()
    assert (q[:, 0] < env.config.n_shelves).all()
    assert len(set(q[:, 0].tolist())) > 10  # drawn, not fixed
    np.testing.assert_array_equal(np.asarray(res.state.cur_inactive_steps), 0)
    np.testing.assert_array_equal(np.asarray(res.info["deliveries"]), 1)


def test_autoreset_counts_episode():
    """max_steps=3 and seven NOOP steps: every env ends an episode at
    steps 3 and 6 and is one step into the third when the rollout ends."""
    cfg = rware_tpu.WarehouseConfig(n_agents=2, request_queue_size=2, max_steps=3)
    env = rware_tpu.make(cfg)
    states, _ = batched_reset(env, jax.random.key(0), 64)
    roll = jax.jit(build_batched_rollout_fn(env, _noop_policy(env), n_steps=7))
    final, traj = roll(states, jax.random.split(jax.random.key(1), 64))
    dones = np.asarray(traj.dones)  # (T, B)
    assert dones.sum(axis=0).tolist() == [2] * 64
    assert dones[2].all() and dones[5].all()
    np.testing.assert_array_equal(np.asarray(final.cur_steps), 1)


def test_msg_bits_roundtrip():
    """Messages (rware/warehouse.py:152,809-814) are set from the action's
    bit columns every step and cleared on autoreset."""
    cfg = rware_tpu.WarehouseConfig(
        n_agents=2, msg_bits=2, request_queue_size=2, max_steps=4
    )
    env = rware_tpu.make(cfg)
    states, _ = batched_reset(env, jax.random.key(0), 16)
    rng = np.random.default_rng(3)
    acts = np.zeros((3, 16, 2, 3), np.int32)
    acts[..., 0] = rng.integers(0, 5, (3, 16, 2))
    acts[..., 1:] = rng.integers(0, 2, (3, 16, 2, 2))
    seq, _ = _states_over_time(env, states, jnp.asarray(acts))
    np.testing.assert_array_equal(
        np.asarray(seq.agent_message[1:]), acts[..., 1:].astype(np.float32)
    )

    def policy(key, obs):
        return jnp.ones((2, 3), jnp.int32)  # FORWARD, both bits set

    roll = jax.jit(build_batched_rollout_fn(env, policy, n_steps=4))
    final, traj = roll(states, jax.random.split(jax.random.key(1), 16))
    assert np.asarray(traj.dones[-1]).all()
    np.testing.assert_array_equal(np.asarray(final.agent_message), 0.0)


def test_zero_request_queue_rollout():
    """request_queue_size=0 is a legal config (rware-tiny-1ag-hard-v2):
    nothing is ever delivered."""
    cfg = rware_tpu.WarehouseConfig(n_agents=2, request_queue_size=0, max_steps=4)
    env = rware_tpu.make(cfg)
    states, _ = batched_reset(env, jax.random.key(0), 32)
    roll = jax.jit(build_batched_rollout_fn(env, n_steps=3))
    final, traj = roll(states, jax.random.split(jax.random.key(1), 32))
    assert float(np.asarray(traj.rewards).sum()) == 0.0
    np.testing.assert_array_equal(np.asarray(final.cur_steps), 3)
    assert final.request_queue.shape == (32, 0)


def test_two_goals_deliver_in_one_step():
    """Both goals of large-8ag (R = 8) deliver in the same step: both
    agents are paid, goals are processed in order (the second resample
    already sees the first refill), and the queue never repeats a shelf."""
    env = rware_tpu.make("rware-large-8ag-v2")
    cfg = env.config
    (g0x, g0y), (g1x, g1y) = ((int(x), int(y)) for x, y in env.layout.goals[:2])
    n, r = env.n_agents, cfg.request_queue_size
    pos = [(g0x, g0y - 1, DOWN), (g1x, g1y - 1, DOWN)]
    pos += [(2 + i, 0, UP) for i in range(n - 2)]
    single = make_state(cfg, pos, carrying=[0, 1] + [-1] * (n - 2),
                        queue=list(range(r)))
    states = _broadcast(single, 512)
    acts = jnp.zeros((512, n), jnp.int32).at[:, :2].set(Action.FORWARD)
    res = jax.jit(jax.vmap(env._step_fn))(states, acts)
    rew = np.asarray(res.rewards)
    np.testing.assert_array_equal(rew[:, :2], 1.0)
    np.testing.assert_array_equal(rew[:, 2:], 0.0)
    q = np.asarray(res.state.request_queue)
    assert (q[:, 2:] == np.arange(2, r)).all()
    assert all(len(set(row)) == r for row in q.tolist())
    assert not np.isin(q[:, 0], np.arange(r)).any()
    # shelf 1 was still queued when goal 1 resampled; shelf 0, delivered
    # at goal 0 just before, was not and may be drawn back
    assert not (q[:, 1] == 1).any()
    assert (q[:, 1] == 0).any()
    np.testing.assert_array_equal(np.asarray(res.info["deliveries"]), 2)


CROWDED = [
    "rware-tiny-2ag-v2", "rware-tiny-4ag-hard-v2", "rware-small-4ag-v2",
    "rware-medium-6ag-hard-v2", "rware-large-8ag-v2", "rware-tiny-12ag-v2",
    "rware-tiny-16ag-v2", "rware-large-19ag-v2",
]


@pytest.mark.parametrize("env_id", CROWDED)
def test_crowded_rollout_invariants(env_id):
    """Forward-biased random actions (dense chains, cycles and head-on
    swaps for the collision resolver), checked after every step: agents
    and shelves in bounds, no two agents and no two shelves on one cell,
    a carried shelf under its carrier, moves of at most one cell."""
    env = rware_tpu.make(env_id)
    h, w = env.grid_size
    n, b, t = env.n_agents, 64, 12
    states, _ = batched_reset(env, jax.random.key(5), b)
    raw = np.random.default_rng(11).integers(0, 10, (t, b, n))
    acts = jnp.asarray(np.where(raw < 6, Action.FORWARD, raw - 5), jnp.int32)
    seq, _ = _states_over_time(env, states, acts)
    ax, ay = np.asarray(seq.agent_x), np.asarray(seq.agent_y)
    sx, sy = np.asarray(seq.shelf_x), np.asarray(seq.shelf_y)
    carry = np.asarray(seq.agent_carrying)
    assert ((ax >= 0) & (ax < w) & (ay >= 0) & (ay < h)).all()
    assert ((sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)).all()
    agent_cells = ay * w + ax
    shelf_cells = sy * w + sx
    for step in range(t + 1):
        for e in range(b):
            assert len(set(agent_cells[step, e])) == n, (step, e)
            assert len(set(shelf_cells[step, e])) == sx.shape[-1], (step, e)
    held = carry >= 0
    idx = np.where(held, carry, 0)
    np.testing.assert_array_equal(
        np.where(held, np.take_along_axis(sx, idx, -1), ax), ax
    )
    np.testing.assert_array_equal(
        np.where(held, np.take_along_axis(sy, idx, -1), ay), ay
    )
    moves = np.abs(np.diff(ax, axis=0)) + np.abs(np.diff(ay, axis=0))
    assert moves.max() <= 1
    assert moves.sum() > 0  # the crowd did move


@pytest.mark.parametrize(
    "env_id",
    ["rware-tiny-2ag-v2", "rware-small-4ag-v2", "rware-medium-6ag-hard-v2",
     "rware-tiny-16ag-v2", "rware-img-tiny-2ag-v2"],
)
def test_batched_rollout_matches_single_env_steps(env_id):
    """vmap over envs and scan over time give, for one env of the batch,
    exactly what stepping that env alone through env.step gives."""
    env = rware_tpu.make(env_id)
    b, t = 8, 10
    states, _ = batched_reset(env, jax.random.key(2), b)
    roll = jax.jit(build_batched_rollout_fn(env, n_steps=t, autoreset=False))
    keys = jax.random.split(jax.random.key(3), b)
    final, traj = roll(states, keys)
    e = 5
    state = jax.tree.map(lambda x: x[e], states)
    for step in range(t):
        res = env.step(state, traj.actions[step, e])
        np.testing.assert_array_equal(
            np.asarray(res.rewards), np.asarray(traj.rewards[step, e])
        )
        assert bool(res.done) == bool(traj.dones[step, e])
        state = res.state
    for name in ("agent_x", "agent_y", "agent_dir", "agent_carrying",
                 "shelf_x", "shelf_y", "request_queue", "cur_steps"):
        np.testing.assert_array_equal(
            np.asarray(getattr(state, name)),
            np.asarray(getattr(final, name)[e]), err_msg=name,
        )
