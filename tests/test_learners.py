"""Every learner of train.py, built the way train.py builds it: one update
on the CPU for each algorithm and network, with and without message bits,
on FLATTENED and IMAGE observations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rware_tpu
import train

PAIRS = [
    ("ippo", "mlp"), ("ippo", "gru"), ("mappo", "mlp"), ("mappo", "gru"),
    ("seac-ppo", "mlp"), ("seac-ppo", "gru"), ("seac", "mlp"),
]


def build(algo, net, *extra, n_envs=512, mesh=None):
    """(runner, jitted train step) exactly as train.main builds them."""
    args = train.parse_args(
        ["--algo", algo, "--net", net, "--n-envs", str(n_envs),
         "--rollout-len", "4", *extra]
    )
    env = (
        rware_tpu.make(args.env, msg_bits=args.msg_bits)
        if args.msg_bits is not None
        else rware_tpu.make(args.env)
    )
    runner, step, steps_per_update = train.build_learner(
        args, env, jax.random.key(args.seed), mesh
    )
    assert steps_per_update == n_envs * (args.rollout_len or 128)
    return runner, step


@pytest.mark.parametrize("obs", ["flat", "image"])
@pytest.mark.parametrize("msg_bits", [0, 2])
@pytest.mark.parametrize("algo,net", PAIRS)
def test_learner_one_update(algo, net, msg_bits, obs):
    env_id = "rware-tiny-2ag-v2" if obs == "flat" else "rware-img-tiny-2ag-v2"
    extra = ["--env", env_id]
    if msg_bits:
        extra += ["--msg-bits", str(msg_bits)]
    runner, step = build(algo, net, *extra)
    params0 = jax.device_get(runner.params)
    new, metrics = step(runner)  # donates runner
    assert int(new.update_idx) == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    leaves0, leaves1 = jax.tree.leaves(params0), jax.tree.leaves(new.params)
    assert len(leaves0) == len(leaves1)
    moved = max(
        float(np.abs(np.asarray(b, np.float32) - np.asarray(a, np.float32)).max())
        for a, b in zip(leaves0, leaves1)
    )
    assert moved > 0
    for leaf in leaves1:
        assert np.isfinite(np.asarray(leaf, np.float32)).all()
    if msg_bits:
        p = new.params["actor"] if algo == "mappo" else new.params
        assert p["params"]["message"]["kernel"].shape[-1] == msg_bits


def test_every_algo_net_pair_builds():
    """train.py's --algo x --net choices are exactly the matrix above (a
    new learner must join it); --algo seac has no recurrent variant, and
    there is no user-selected collector."""
    parser_algos = {"ippo", "mappo", "seac", "seac-ppo"}
    assert {a for a, _ in PAIRS} == parser_algos
    assert {(a, n) for a, n in PAIRS if a != "seac"} == {
        (a, n) for a in parser_algos - {"seac"} for n in ("mlp", "gru")
    }
    with pytest.raises(SystemExit):
        train.parse_args(["--collect", "xla"])


def test_main_returns_runner_and_history(monkeypatch):
    monkeypatch.setenv("RWARE_TPU_NO_CACHE", "1")
    runner, history = train.main(
        ["--n-envs", "64", "--rollout-len", "4", "--updates", "3",
         "--log-every", "2"]
    )
    assert int(runner.update_idx) == 3
    assert [h["step"] for h in history] == [2, 3]
    assert all(np.isfinite(h["pg_loss"]) for h in history)
    assert jnp.issubdtype(runner.obs.dtype, jnp.floating)


@pytest.mark.parametrize("net", ["mlp", "gru"])
def test_ippo_block_minibatches(net):
    runner, step = build("ippo", net, "--minibatch-mode", "block")
    new, metrics = step(runner)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k


def test_main_mesh_matches_single_device(monkeypatch):
    """train.py --mesh on the 8 virtual CPU devices logs what the
    single-device run logs."""
    monkeypatch.setenv("RWARE_TPU_NO_CACHE", "1")
    argv = ["--n-envs", "64", "--rollout-len", "4", "--updates", "2",
            "--log-every", "1"]
    _, h1 = train.main(argv)
    runner, h8 = train.main(argv + ["--mesh"])
    assert len(runner.obs.sharding.device_set) == len(jax.devices()) == 8
    for a, b in zip(h1, h8):
        for k in ("episodes_done", "reward_per_env", "pg_loss", "entropy"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6)
