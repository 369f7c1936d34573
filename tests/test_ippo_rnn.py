"""Recurrent IPPO tests: carry handling, episode-boundary resets, updates."""
import jax
import jax.numpy as jnp
import numpy as np

import rware_tpu
from rware_tpu.models.ippo import IPPOConfig
from rware_tpu.models.ippo_rnn import build_rnn_train_step, init_rnn_runner


def test_rnn_train_step_runs():
    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = IPPOConfig(n_envs=8, rollout_len=6, epochs=2, minibatches=2)
    runner, model, tx = init_rnn_runner(env, cfg, jax.random.key(0))
    ts = jax.jit(build_rnn_train_step(env, model, tx, cfg))
    new_runner, metrics = ts(runner)
    assert int(new_runner.update_idx) == 1
    assert new_runner.carry.shape == (8, 2, 128)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # params moved
    diffs = jax.tree.map(
        lambda a, b: float(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32)).max()),
        runner.params, new_runner.params,
    )
    assert max(jax.tree.leaves(diffs)) > 0


def test_carry_resets_on_episode_boundary():
    env = rware_tpu.make(
        rware_tpu.WarehouseConfig(n_agents=1, request_queue_size=1, max_steps=3)
    )
    cfg = IPPOConfig(n_envs=4, rollout_len=3, epochs=1, minibatches=1)
    runner, model, tx = init_rnn_runner(env, cfg, jax.random.key(0))
    ts = jax.jit(build_rnn_train_step(env, model, tx, cfg))
    new_runner, metrics = ts(runner)
    # every env hit max_steps=3 exactly at the end of the rollout
    assert int(metrics["episodes_done"]) == 4
    np.testing.assert_array_equal(
        np.asarray(new_runner.carry.astype(jnp.float32)), 0.0
    )


def test_rnn_is_stateful_across_steps():
    # same obs, different carries must give different logits (memory works)
    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = IPPOConfig(n_envs=4, rollout_len=2, epochs=1, minibatches=1)
    runner, model, tx = init_rnn_runner(env, cfg, jax.random.key(0))
    obs = runner.obs
    zero = runner.carry
    c1, (logits1, _) = model.apply(runner.params, zero, obs)
    c2, (logits2, _) = model.apply(runner.params, c1, obs)
    assert not np.allclose(np.asarray(logits1), np.asarray(logits2))


def test_gru_scan_custom_vjp_matches_autodiff():
    """The hand-derived _gru_scan backward (hidden-adjoint-only reverse
    loop + one big dot for the weight gradient) == jax.grad through
    the plain forward scan, on every input."""
    from rware_tpu.models.ippo_rnn import _gru_cell_fwd, _gru_scan

    hg = 16
    T, N, RB, LANE = 6, 2, 2, 8
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    wh = (jax.random.normal(ks[0], (hg, 3 * hg)) * 0.3).astype(jnp.bfloat16)
    bhn = jax.random.normal(ks[1], (hg,)) * 0.1
    ir = jax.random.normal(ks[2], (T, N, RB, LANE, hg))
    iz = jax.random.normal(ks[3], (T, N, RB, LANE, hg))
    inn = jax.random.normal(ks[4], (T, N, RB, LANE, hg))
    done = (jax.random.uniform(ks[5], (T, 1, RB, LANE)) < 0.2).astype(
        jnp.bfloat16
    )
    h0 = (jax.random.normal(ks[6], (N, RB, LANE, hg)) * 0.5).astype(
        jnp.bfloat16
    )
    dout = jax.random.normal(ks[7], (T, N, RB, LANE, hg))

    def ref_scan(wh, bhn, ir, iz, inn, done, h0):
        def cell(h, xs):
            ir_t, iz_t, inn_t, m_t = xs
            return _gru_cell_fwd(hg, wh, bhn, h, ir_t, iz_t, inn_t, m_t)

        _, hseq = jax.lax.scan(cell, h0, (ir, iz, inn, done))
        return hseq

    def loss(fn):
        return lambda a: jnp.sum(fn(*a).astype(jnp.float32) * dout)

    args = (wh, bhn, ir, iz, inn, done, h0)
    f_custom = loss(lambda *a: _gru_scan(hg, *a))
    f_ref = loss(ref_scan)
    # forward identical (same cell function, same scan)
    np.testing.assert_array_equal(
        np.asarray(f_custom(args)), np.asarray(f_ref(args))
    )
    g_custom = jax.grad(f_custom)(args)
    g_ref = jax.grad(f_ref)(args)
    names = ["wh", "bhn", "ir", "iz", "inn", "done", "h0"]
    for name, a, b in zip(names, g_custom, g_ref):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        if name == "done":
            # custom VJP declares the mask non-differentiable (zeros)
            np.testing.assert_array_equal(a, 0.0)
            continue
        scale = max(np.abs(b).max(), 1e-6)
        # bf16 gate cotangents bound the agreement
        assert np.abs(a - b).max() / scale < 2e-2, name


def test_gru_native_replay_matches_flat_replay():
    """_gru_native_replay (batched gate matmuls + recurrence-only scan) ==
    the per-step model.apply replay on the same trajectory."""
    import numpy as np

    from rware_tpu.models.ippo_rnn import _gru_native_replay
    from rware_tpu.models.networks import RecurrentActorCritic

    T, L, N, RB, LANE = 6, 31, 2, 2, 8
    B = RB * LANE
    model = RecurrentActorCritic(n_actions=5, hidden=16, embed=12)
    key = jax.random.key(0)
    params = model.init(
        key, model.initialize_carry((1, N)), jnp.zeros((1, N, L))
    )
    k1, k2 = jax.random.split(key)
    obs_n = jax.random.normal(k1, (T, N, RB, LANE, L)).astype(jnp.bfloat16)
    done_n = (
        jax.random.uniform(k2, (T, 1, RB, LANE)) < 0.2
    ).astype(jnp.int32)
    h0 = model.initialize_carry((B, N))  # zeros

    h0n = jnp.transpose(h0, (1, 0, 2)).reshape(N, RB, LANE, 16)
    logits_n, value_n = jax.jit(
        lambda p: _gru_native_replay(model, p, obs_n, done_n, h0n)
    )(params)

    # flat replay in (T, B, N, ...) layout
    obs_f = jnp.moveaxis(
        obs_n.reshape(T, N, B, L), 2, 1
    ).astype(jnp.float32)
    done_f = done_n.reshape(T, B)

    def replay(carry, xs):
        o, d = xs
        nc, (lg, v) = model.apply(params, carry, o)
        nc = jnp.where(d[:, None, None] != 0, jnp.zeros_like(nc), nc)
        return nc, (lg, v)

    _, (logits_f, value_f) = jax.lax.scan(replay, h0, (obs_f, done_f))

    # native (T, N, RB, LANE, A) -> (T, B, N, A)
    ln = jnp.moveaxis(logits_n.reshape(T, N, B, 5), 2, 1)
    vn = jnp.moveaxis(value_n.reshape(T, N, B), 2, 1)
    np.testing.assert_allclose(
        np.asarray(ln), np.asarray(logits_f), atol=5e-2
    )
    np.testing.assert_allclose(
        np.asarray(vn), np.asarray(value_f), atol=5e-2
    )


def test_sharded_rnn_train_step_matches_metrics():
    """The recurrent train step over the 8-device CPU mesh, the carry
    sharded along the env axis: rollout statistics, env states and carry
    equal the single-device step, parameters up to summation order."""
    from rware_tpu.parallel import make_mesh
    from train import shard_runner

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = IPPOConfig(n_envs=64, rollout_len=8, epochs=1, minibatches=2)
    runner, model, tx = init_rnn_runner(env, cfg, jax.random.key(0))
    ts = jax.jit(build_rnn_train_step(env, model, tx, cfg))
    r1, m1 = ts(runner)
    r2, m2 = ts(shard_runner(runner, make_mesh()))
    for k, v in m2.items():
        assert np.isfinite(float(v)), k
    assert float(m1["episodes_done"]) == float(m2["episodes_done"])
    np.testing.assert_allclose(
        float(m1["reward_per_env"]), float(m2["reward_per_env"]), rtol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(r1.env_states.agent_x), np.asarray(r2.env_states.agent_x)
    )
    np.testing.assert_array_equal(
        np.asarray(r1.carry, np.float32), np.asarray(r2.carry, np.float32)
    )
    for a, b in zip(jax.tree.leaves(r1.params), jax.tree.leaves(r2.params)):
        np.testing.assert_allclose(
            np.asarray(b, np.float32), np.asarray(a, np.float32), atol=3e-4
        )
