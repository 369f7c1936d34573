"""Message-aware policy head: msg_bits configs are trainable end-to-end.

The env's composite action space is MultiDiscrete([5, 2, ..., 2])
(reference rware/warehouse.py:152,289-291); the policy models it as a
categorical move plus independent Bernoulli message bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rware_tpu
from rware_tpu.models import ActorCritic, IPPOConfig, build_train_step, init_runner
from rware_tpu.models.networks import bernoulli_logp, sample_action_msg


def test_msg_head_shapes():
    model = ActorCritic(n_actions=5, msg_bits=3)
    obs = jnp.zeros((4, 2, 71))
    params = model.init(jax.random.key(0), obs)
    (move, msg), value = model.apply(params, obs)
    assert move.shape == (4, 2, 5)
    assert msg.shape == (4, 2, 3)
    assert value.shape == (4, 2)
    assert "message" in params["params"]


def test_msg_head_off_is_unchanged():
    model = ActorCritic(n_actions=5)
    obs = jnp.zeros((4, 2, 71))
    params = model.init(jax.random.key(0), obs)
    logits, value = model.apply(params, obs)
    assert logits.shape == (4, 2, 5)
    assert "message" not in params["params"]


def test_sample_action_msg_logp():
    key = jax.random.key(1)
    move_logits = jnp.array([[2.0, 0.0, -1.0, 0.5, 0.1]])
    msg_logits = jnp.array([[0.7, -1.2]])
    action, logp = sample_action_msg(key, move_logits, msg_logits)
    assert action.shape == (1, 3)
    assert action.dtype == jnp.int32
    assert set(np.asarray(action[0, 1:]).tolist()) <= {0, 1}
    expected = (
        jax.nn.log_softmax(move_logits)[0, action[0, 0]]
        + bernoulli_logp(msg_logits, action[..., 1:]).sum()
    )
    np.testing.assert_allclose(float(logp[0]), float(expected), rtol=1e-6)


def test_bernoulli_logp_sums_to_one():
    logits = jnp.array([0.3, -2.0, 1.5])
    p0 = jnp.exp(bernoulli_logp(logits, jnp.zeros(3)))
    p1 = jnp.exp(bernoulli_logp(logits, jnp.ones(3)))
    np.testing.assert_allclose(np.asarray(p0 + p1), np.ones(3), rtol=1e-6)


def test_msg_train_step_end_to_end():
    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=2)
    cfg = IPPOConfig(n_envs=8, rollout_len=8, epochs=2, minibatches=2)
    runner, model, tx = init_runner(env, cfg, jax.random.key(0))
    assert model.msg_bits == 2
    step = jax.jit(build_train_step(env, model, tx, cfg))
    runner, metrics = step(runner)
    runner, metrics = step(runner)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, v)
    # params actually moved (message head included)
    fresh = model.init(jax.random.key(0), jnp.zeros((1, 2, runner.obs.shape[-1])))
    assert "message" in runner.params["params"]


def test_msg_gru_train_step_end_to_end():
    from rware_tpu.models.ippo_rnn import build_rnn_train_step, init_rnn_runner

    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=2)
    cfg = IPPOConfig(n_envs=8, rollout_len=8, epochs=1, minibatches=2)
    runner, model, tx = init_rnn_runner(env, cfg, jax.random.key(0))
    assert model.msg_bits == 2
    step = jax.jit(build_rnn_train_step(env, model, tx, cfg))
    runner, metrics = step(runner)
    runner, metrics = step(runner)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, v)
    assert float(jnp.mean(runner.env_states.agent_message)) > 0


def test_msg_entropy_includes_bits():
    """Uniform message head adds msg_bits * ln2 of entropy."""
    from rware_tpu.models.ippo import ppo_loss

    env = rware_tpu.make("rware-tiny-2ag-v2", msg_bits=2)
    cfg = IPPOConfig(n_envs=4, rollout_len=4)
    runner, model, tx = init_runner(env, cfg, jax.random.key(0))
    M, n = 6, env.n_agents
    L = runner.obs.shape[-1]
    batch = (
        jnp.zeros((M, n, L)),
        jnp.zeros((M, n, 3), dtype=jnp.int32),
        jnp.full((M, n), -2.0),
        jnp.zeros((M, n)),
        jnp.ones((M, n)),
        jnp.zeros((M, n)),
    )
    _, metrics = ppo_loss(model, cfg, runner.params, batch)
    # entropy of a near-uniform init: ~ln5 for the move + ~2*ln2 for bits
    assert float(metrics["entropy"]) > np.log(5) + 0.5
