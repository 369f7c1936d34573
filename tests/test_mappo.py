"""MAPPO (centralized-critic PPO, models/mappo.py): train steps with the
MLP and GRU actors, critic centralization, loss wiring, data-parallel
sharding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rware_tpu
from rware_tpu.models import IPPOConfig


def _max_change(a, b):
    return max(
        jax.tree.leaves(
            jax.tree.map(
                lambda x, y: float(
                    jnp.abs(x.astype(jnp.float32) - y.astype(jnp.float32)).max()
                ),
                a, b,
            )
        )
    )


def _step(build, init, env, cfg, runner=None):
    r0, actor, critic, tx = init(env, cfg, jax.random.key(0))
    ts = jax.jit(build(env, actor, critic, tx, cfg))
    return r0, ts(r0 if runner is None else runner), (actor, critic)


def test_mappo_train_step_runs_and_learns_signals():
    from rware_tpu.models.mappo import (
        build_mappo_train_step,
        init_mappo_runner,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = IPPOConfig(n_envs=256, rollout_len=8, epochs=2, minibatches=2)
    runner, (new_runner, metrics), _ = _step(
        build_mappo_train_step, init_mappo_runner, env, cfg
    )
    assert int(new_runner.update_idx) == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # both the actor and the central critic moved
    for part in ("actor", "critic"):
        assert _max_change(runner.params[part], new_runner.params[part]) > 0


def test_mappo_xla_collect_mode_runs():
    """The XLA collector stores the native trajectory layout: obs
    (T, L, N, RB, LANE) bf16, per-agent tensors (T, N, RB, LANE), done
    (T, 1, RB, LANE), and returns the post-rollout state and obs."""
    from rware_tpu.models.mappo import (
        LANE,
        _build_native_collect,
        init_mappo_runner,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = IPPOConfig(n_envs=256, rollout_len=8, epochs=1, minibatches=2)
    runner, actor, _, _ = init_mappo_runner(env, cfg, jax.random.key(0))

    def policy(params, obs, h):
        heads, _ = actor.apply(params, obs)
        return heads, h

    collect = jax.jit(_build_native_collect(env, cfg, policy))
    states, obs, h, traj = collect(
        runner.params["actor"], runner.env_states, runner.obs, None,
        jax.random.key(1),
    )
    T, L, N, RB = 8, env.config.policy_obs_length, env.n_agents, 256 // LANE
    assert traj["obs"].shape == (T, L, N, RB, LANE)
    assert traj["obs"].dtype == jnp.bfloat16
    for k in ("action", "logp", "reward"):
        assert traj[k].shape == (T, N, RB, LANE), k
    assert traj["done"].shape == (T, 1, RB, LANE)
    assert h is None and obs.shape == runner.obs.shape
    assert int(states.cur_steps[0]) == 8
    # env b's first observation lands at row b // LANE, lane b % LANE
    np.testing.assert_array_equal(
        np.asarray(traj["obs"][0, :, :, 1, 3], np.float32),
        np.asarray(runner.obs[LANE + 3], np.float32).T,
    )


def test_sharded_mappo_train_step_matches_metrics():
    """MAPPO over the 8-device CPU mesh computes what the single-device
    step does: the same rollout statistics and, up to summation order,
    the same losses and parameters."""
    from rware_tpu.models.mappo import (
        build_mappo_train_step,
        init_mappo_runner,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = IPPOConfig(n_envs=1024, rollout_len=8, epochs=1, minibatches=2)
    _assert_sharded_matches(
        env, cfg, init_mappo_runner, build_mappo_train_step
    )


def _assert_sharded_matches(env, cfg, init, build):
    from rware_tpu.parallel import make_mesh, replicate, shard_env_batch

    runner, actor, critic, tx = init(env, cfg, jax.random.key(0))
    ts = jax.jit(build(env, actor, critic, tx, cfg))
    r1, m1 = ts(runner)
    mesh = make_mesh()
    sharded = runner.replace(
        env_states=shard_env_batch(runner.env_states, mesh),
        obs=shard_env_batch(runner.obs, mesh),
        params=replicate(runner.params, mesh),
        opt_state=replicate(runner.opt_state, mesh),
    )
    if hasattr(runner, "carry"):
        sharded = sharded.replace(carry=shard_env_batch(runner.carry, mesh))
    r2, m2 = ts(sharded)
    assert float(m1["episodes_done"]) == float(m2["episodes_done"])
    for k in m1:
        np.testing.assert_allclose(
            float(m2[k]), float(m1[k]), rtol=1e-4, atol=1e-6, err_msg=k
        )
    for a, b in zip(jax.tree.leaves(r1.params), jax.tree.leaves(r2.params)):
        np.testing.assert_allclose(
            np.asarray(b, np.float32), np.asarray(a, np.float32), atol=1e-5
        )


def test_central_critic_is_centralized():
    """The critic's value for agent 0 must depend on agent 1's observation
    — the property that separates MAPPO's critic from IPPO's."""
    from rware_tpu.models.networks import CentralCritic

    n, L = 2, 71
    critic = CentralCritic(n_agents=n)
    params = critic.init(jax.random.key(0), jnp.zeros((1, n * L)))
    obs = jax.random.normal(jax.random.key(1), (4, n, L))
    joint = obs.reshape(4, n * L)
    v0 = critic.apply(params, joint)
    # perturb ONLY agent 1's slot
    obs2 = obs.at[:, 1, :].add(1.0)
    v1 = critic.apply(params, obs2.reshape(4, n * L))
    assert float(jnp.abs(v0[:, 0] - v1[:, 0]).max()) > 1e-4


def test_mappo_loss_native_matches_apply():
    """_critic_native_forward (native-layout batched dots) == critic.apply
    on the same joint observations."""
    from rware_tpu.models.mappo import (
        _critic_native_forward,
        _joint_native,
    )
    from rware_tpu.models.networks import CentralCritic

    T, L, N, RB, LANE = 3, 31, 2, 2, 128
    critic = CentralCritic(n_agents=N)
    params = critic.init(jax.random.key(0), jnp.zeros((1, N * L)))
    obs = jax.random.normal(
        jax.random.key(1), (T, L, N, RB, LANE)
    ).astype(jnp.bfloat16)
    v_native = _critic_native_forward(params, _joint_native(obs))
    # flat reference: (T, RB*LANE, N*L) agent-major rows
    flat = jnp.transpose(
        obs.reshape(T, L, N, RB * LANE), (0, 3, 2, 1)
    ).reshape(T, RB * LANE, N * L)
    v_flat = critic.apply(params, flat)  # (T, B, N)
    v_flat_native = jnp.moveaxis(v_flat, -1, 1).reshape(T, N, RB, LANE)
    np.testing.assert_allclose(
        np.asarray(v_native), np.asarray(v_flat_native),
        atol=5e-2,
    )


@pytest.mark.parametrize("msg_bits", [0, 2])
def test_native_forward_matches_apply(msg_bits):
    """_native_forward on native-layout obs (T, L, N, RB, LANE) ==
    ActorCritic.apply on the same obs in (T, B, N, L) layout."""
    from rware_tpu.models.mappo import _native_forward
    from rware_tpu.models.networks import ActorCritic

    T, L, N, RB, LANE, A = 3, 71, 2, 2, 128, 5
    model = ActorCritic(n_actions=A, msg_bits=msg_bits)
    params = model.init(jax.random.key(1), jnp.zeros((1, N, L)))
    # observations are 0/1 features, stored in bf16 by the collector
    obs = jax.random.bernoulli(
        jax.random.key(2), 0.3, (T, L, N, RB, LANE)
    ).astype(jnp.bfloat16)
    heads_n, value_n = jax.jit(_native_forward)(params, obs)
    obs_flat = jnp.transpose(
        obs.reshape(T, L, N, RB * LANE), (0, 3, 2, 1)
    ).astype(jnp.float32)
    heads_f, value_f = model.apply(params, obs_flat)

    def to_flat(x):  # (T, N, RB, LANE, ...) -> (T, B, N, ...)
        return jnp.moveaxis(x.reshape(T, N, RB * LANE, *x.shape[4:]), 2, 1)

    if msg_bits:
        assert heads_n[1].shape == (T, N, RB, LANE, msg_bits)
    for a, b in zip(jax.tree.leaves(heads_n), jax.tree.leaves(heads_f)):
        np.testing.assert_allclose(
            np.asarray(to_flat(a)), np.asarray(b), atol=3e-2
        )
    np.testing.assert_allclose(
        np.asarray(to_flat(value_n)), np.asarray(value_f), atol=3e-2
    )


def test_native_gae_matches_flat():
    """compute_gae_native on (T, N, RB, LANE) tensors with a (T, 1, RB,
    LANE) done mask == ippo.compute_gae on the same data in (T, B, N)."""
    from rware_tpu.models.ippo import compute_gae
    from rware_tpu.models.mappo import compute_gae_native

    cfg = IPPOConfig()
    T, N, RB, LANE = 7, 2, 3, 4
    B = RB * LANE
    k1, k2, k3, k4 = jax.random.split(jax.random.key(0), 4)
    rew = jax.random.normal(k1, (T, N, RB, LANE))
    val = jax.random.normal(k2, (T, N, RB, LANE))
    done = (jax.random.uniform(k3, (T, 1, RB, LANE)) < 0.2).astype(jnp.int32)
    last_v = jax.random.normal(k4, (N, RB, LANE))

    adv_n, tgt_n = compute_gae_native(cfg, rew, val, done, last_v)

    def to_flat(x):  # (T, N, RB, LANE) -> (T, B, N)
        return jnp.moveaxis(x.reshape(T, N, B), 1, 2)

    adv_f, tgt_f = compute_gae(
        cfg, to_flat(rew), to_flat(val), done.reshape(T, B),
        jnp.swapaxes(last_v.reshape(N, B), 0, 1),
    )
    np.testing.assert_allclose(
        np.asarray(to_flat(adv_n)), np.asarray(adv_f), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(to_flat(tgt_n)), np.asarray(tgt_f), rtol=1e-5, atol=1e-5
    )


def test_mappo_msg_bits_joint_policy():
    from rware_tpu.models.mappo import (
        build_mappo_train_step,
        init_mappo_runner,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=2)
    cfg = IPPOConfig(n_envs=256, rollout_len=8, epochs=1, minibatches=2)
    runner, (new_runner, metrics), (actor, _) = _step(
        build_mappo_train_step, init_mappo_runner, env, cfg
    )
    assert actor.msg_bits == 2
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert _max_change(
        runner.params["actor"]["params"]["message"],
        new_runner.params["actor"]["params"]["message"],
    ) > 0


def _rnn_batch(env, actor, critic, key, msg_bits=0, t=6, rb=2):
    """A random native-layout recurrent-MAPPO minibatch and params."""
    from rware_tpu.models.mappo import LANE

    n, l = env.n_agents, env.config.policy_obs_length
    ks = jax.random.split(key, 10)
    params = {
        "actor": actor.init(
            ks[0], actor.initialize_carry((1, n)), jnp.zeros((1, n, l))
        ),
        "critic": critic.init(ks[1], jnp.zeros((1, n * l))),
    }
    shape = (t, n, rb, LANE)
    batch = (
        (jax.random.uniform(ks[2], (t, l, n, rb, LANE)) < 0.3).astype(
            jnp.bfloat16
        ),
        jax.random.randint(ks[3], shape, 0, 5),
        -1.6 + 0.1 * jax.random.normal(ks[4], shape),
        0.1 * jax.random.normal(ks[5], shape),
        jax.random.normal(ks[6], shape),
        0.1 * jax.random.normal(ks[7], shape),
        (jax.random.uniform(ks[8], (t, 1, rb, LANE)) < 0.1).astype(jnp.int32),
        actor.initialize_carry((n, rb, LANE)),
    )
    if msg_bits:
        batch += (
            jax.random.bernoulli(ks[9], 0.5, (t, n * msg_bits, rb, LANE))
            .astype(jnp.int32),
        )
    return params, batch


def _assert_critic_grad_is_value_loss_grad(msg_bits):
    """The critic's gradient of the joint recurrent-MAPPO loss is exactly
    vf_coef x the gradient of the clipped value loss of the central critic
    alone (autodiff through _critic_native_forward): the actor terms take
    no part in it."""
    from rware_tpu.models.mappo import (
        _critic_native_forward,
        _joint_native,
        rnn_mappo_loss_native,
    )
    from rware_tpu.models.networks import CentralCritic, RecurrentActorCritic

    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=msg_bits)
    actor = RecurrentActorCritic(hidden=16, embed=16, msg_bits=msg_bits)
    critic = CentralCritic(n_agents=env.n_agents, hidden=(32, 32))
    cfg = IPPOConfig()
    params, batch = _rnn_batch(env, actor, critic, jax.random.key(3), msg_bits)
    grads = jax.grad(
        lambda p: rnn_mappo_loss_native(cfg, actor, p, batch)[0]
    )(params)
    obs, _, _, old_value, _, target = batch[:6]

    def value_loss(cp):
        value = _critic_native_forward(cp, _joint_native(obs))
        clipped = old_value + jnp.clip(
            value - old_value, -cfg.clip_eps, cfg.clip_eps
        )
        return cfg.vf_coef * 0.5 * jnp.maximum(
            (value - target) ** 2, (clipped - target) ** 2
        ).mean()

    ref = jax.grad(value_loss)(params["critic"])
    for a, b in zip(jax.tree.leaves(grads["critic"]), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    return grads


def test_rnn_mappo_train_step_runs_and_critic_matches_xla():
    """Recurrent MAPPO (GRU actor + central critic): the step runs,
    metrics are finite, the carry advances and both parts move; the
    critic's gradient is the central value loss's (see the helper)."""
    from rware_tpu.models.mappo import (
        build_rnn_mappo_train_step,
        init_rnn_mappo_runner,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = IPPOConfig(n_envs=256, rollout_len=8, epochs=1, minibatches=2)
    runner, (r1, m1), _ = _step(
        build_rnn_mappo_train_step, init_rnn_mappo_runner, env, cfg
    )
    for k, v in m1.items():
        assert np.isfinite(float(v)), k
    assert int(r1.update_idx) == 1
    assert not np.array_equal(
        np.asarray(r1.carry, np.float32), np.asarray(runner.carry, np.float32)
    )
    for part in ("actor", "critic"):
        assert _max_change(runner.params[part], r1.params[part]) > 0
    _assert_critic_grad_is_value_loss_grad(msg_bits=0)


def test_rnn_mappo_msg_bits_joint_policy_and_critic_parity():
    """Recurrent MAPPO WITH message bits: GRU actor + Bernoulli message
    head (joint move+msg loss) + central critic over the msg-augmented
    joint obs.  The step runs, the message head takes gradient, and the
    critic's gradient is the central value loss's."""
    from rware_tpu.models.mappo import (
        build_rnn_mappo_train_step,
        init_rnn_mappo_runner,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=2)
    cfg = IPPOConfig(n_envs=256, rollout_len=8, epochs=1, minibatches=2)
    runner, (r1, m1), (actor, _) = _step(
        build_rnn_mappo_train_step, init_rnn_mappo_runner, env, cfg
    )
    assert actor.msg_bits == 2
    for k, v in m1.items():
        assert np.isfinite(float(v)), k
    assert _max_change(
        runner.params["actor"]["params"]["message"],
        r1.params["actor"]["params"]["message"],
    ) > 0
    grads = _assert_critic_grad_is_value_loss_grad(msg_bits=2)
    assert float(jnp.abs(grads["actor"]["params"]["message"]["kernel"]).max()) > 0


def test_sharded_rnn_mappo_msg_train_step_matches_metrics():
    """Recurrent MAPPO with message bits over the 8-device CPU mesh (the
    GRU carry sharded along the env axis) computes what the single-device
    step does."""
    from rware_tpu.models.mappo import (
        build_rnn_mappo_train_step,
        init_rnn_mappo_runner,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=2)
    cfg = IPPOConfig(n_envs=1024, rollout_len=8, epochs=1, minibatches=2)
    _assert_sharded_matches(
        env, cfg, init_rnn_mappo_runner, build_rnn_mappo_train_step
    )
