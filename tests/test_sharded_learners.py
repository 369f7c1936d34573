"""Data parallelism as train.py --mesh runs it: every learner's step on
the 8 virtual CPU devices (env batch sharded, the rest replicated)
computes what the unsharded step computes.  Random draws do not depend on
the sharding, so only summation order differs: rollout statistics agree
exactly, losses to float32 rounding, and parameters to a fraction of one
Adam step (lr = 3e-4; Adam's first steps are sign-like, so an element with
a near-zero gradient can move by a different amount).  The whole update
agrees to 1% in relative L2 norm."""
import jax
import numpy as np
import pytest

from rware_tpu.parallel import make_mesh
from test_learners import PAIRS, build


@pytest.mark.parametrize("algo,net", PAIRS)
def test_sharded_step_matches_unsharded(algo, net):
    assert len(jax.devices()) == 8
    runner, step = build(algo, net, n_envs=1024)
    params0 = jax.device_get(runner.params)
    r1, m1 = step(runner)
    sharded, step8 = build(algo, net, n_envs=1024, mesh=make_mesh())
    assert len(sharded.obs.sharding.device_set) == 8
    r2, m2 = step8(sharded)
    assert len(r2.env_states.agent_x.sharding.device_set) == 8
    assert float(m1["episodes_done"]) == float(m2["episodes_done"])
    for k in m1:
        np.testing.assert_allclose(
            float(m2[k]), float(m1[k]), rtol=1e-4, atol=1e-6, err_msg=k
        )
    flat = [
        np.concatenate([np.asarray(x, np.float64).ravel()
                        for x in jax.tree.leaves(p)])
        for p in (params0, r1.params, r2.params)
    ]
    np.testing.assert_allclose(flat[2], flat[1], atol=3e-4)
    gap = np.linalg.norm(flat[2] - flat[1]) / np.linalg.norm(flat[1] - flat[0])
    assert gap < 1e-2, gap
    np.testing.assert_array_equal(
        np.asarray(r1.env_states.agent_x), np.asarray(r2.env_states.agent_x)
    )


@pytest.mark.parametrize("algo,net", [("ippo", "mlp"), ("mappo", "gru")])
def test_sharded_step_compiles_once(algo, net):
    """The sharded step's outputs keep its inputs' shardings, so the second
    update reuses the first update's program (a recompile per update would
    cost a compile's time on every step)."""
    runner, step = build(algo, net, n_envs=512, mesh=make_mesh())
    before = jax.tree.map(lambda x: x.sharding, runner)
    runner, _ = step(runner)
    assert jax.tree.map(lambda x: x.sharding, runner) == before
    runner, _ = step(runner)
    assert step._cache_size() == 1
