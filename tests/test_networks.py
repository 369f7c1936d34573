"""The plain-JAX networks against flax.linen modules of the same
architecture: same parameter tree, and on the same parameters the same
outputs bit for bit on the CPU.  Also the pytree dataclass helper under
jit, vmap and replace."""
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rware_tpu import pytree
from rware_tpu.models.networks import (
    ActorCritic,
    CentralCritic,
    RecurrentActorCritic,
)


def _flax_modules():
    nn = pytest.importorskip("flax.linen")

    class FlaxActorCritic(nn.Module):
        n_actions: int = 5
        hidden: Sequence[int] = (128, 128)
        msg_bits: int = 0
        dtype: Any = jnp.bfloat16

        @nn.compact
        def __call__(self, obs):
            x = obs.astype(self.dtype)
            for i, width in enumerate(self.hidden):
                x = nn.tanh(nn.Dense(width, dtype=self.dtype, name=f"dense_{i}")(x))
            logits = nn.Dense(self.n_actions, dtype=jnp.float32, name="policy")(x)
            value = nn.Dense(1, dtype=jnp.float32, name="value")(x)
            if self.msg_bits > 0:
                msg = nn.Dense(self.msg_bits, dtype=jnp.float32, name="message")(x)
                return (logits, msg), jnp.squeeze(value, -1)
            return logits, jnp.squeeze(value, -1)

    class FlaxCentralCritic(nn.Module):
        n_agents: int
        hidden: Sequence[int] = (128, 128)
        dtype: Any = jnp.bfloat16

        @nn.compact
        def __call__(self, joint):
            x = joint.astype(self.dtype)
            for i, width in enumerate(self.hidden):
                x = nn.tanh(nn.Dense(width, dtype=self.dtype, name=f"dense_{i}")(x))
            return nn.Dense(self.n_agents, dtype=jnp.float32, name="value")(x)

    class FlaxRecurrent(nn.Module):
        n_actions: int = 5
        hidden: int = 128
        embed: int = 128
        msg_bits: int = 0
        dtype: Any = jnp.bfloat16

        @nn.compact
        def __call__(self, carry, obs):
            x = obs.astype(self.dtype)
            x = nn.tanh(nn.Dense(self.embed, dtype=self.dtype, name="embed")(x))
            carry, x = nn.GRUCell(self.hidden, dtype=self.dtype, name="gru")(carry, x)
            logits = nn.Dense(self.n_actions, dtype=jnp.float32, name="policy")(x)
            value = nn.Dense(1, dtype=jnp.float32, name="value")(x)
            if self.msg_bits > 0:
                msg = nn.Dense(self.msg_bits, dtype=jnp.float32, name="message")(x)
                return carry, ((logits, msg), jnp.squeeze(value, -1))
            return carry, (logits, jnp.squeeze(value, -1))

    return FlaxActorCritic, FlaxCentralCritic, FlaxRecurrent


def _assert_same_tree(a, b):
    sa = jax.tree.map(lambda x: (x.shape, x.dtype), a)
    sb = jax.tree.map(lambda x: (x.shape, x.dtype), b)
    assert sa == sb


def _assert_bitwise(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(
            np.asarray(x, np.float32), np.asarray(y, np.float32)
        )


@pytest.mark.parametrize("hidden", [(128, 128), (64,)])
@pytest.mark.parametrize("msg_bits", [0, 2])
def test_actor_critic_matches_flax(msg_bits, hidden):
    FlaxAC, _, _ = _flax_modules()
    obs = jax.random.normal(jax.random.key(1), (7, 3, 71))
    ours = ActorCritic(n_actions=5, hidden=hidden, msg_bits=msg_bits)
    ref = FlaxAC(n_actions=5, hidden=hidden, msg_bits=msg_bits)
    ref_params = ref.init(jax.random.key(0), obs)
    params = ours.init(jax.random.key(0), obs)
    _assert_same_tree(params, jax.tree.map(jnp.asarray, dict(ref_params)))
    _assert_bitwise(ours.apply(ref_params, obs), ref.apply(ref_params, obs))


def test_central_critic_matches_flax():
    _, FlaxCC, _ = _flax_modules()
    joint = jax.random.normal(jax.random.key(1), (9, 4 * 31))
    ours, ref = CentralCritic(n_agents=4), FlaxCC(n_agents=4)
    ref_params = ref.init(jax.random.key(0), joint)
    _assert_same_tree(ours.init(jax.random.key(0), joint), dict(ref_params))
    _assert_bitwise(ours.apply(ref_params, joint), ref.apply(ref_params, joint))


@pytest.mark.parametrize("msg_bits", [0, 1])
def test_recurrent_actor_critic_matches_flax(msg_bits):
    _, _, FlaxRNN = _flax_modules()
    ours = RecurrentActorCritic(n_actions=5, msg_bits=msg_bits)
    ref = FlaxRNN(n_actions=5, msg_bits=msg_bits)
    obs = jax.random.normal(jax.random.key(1), (5, 2, 71))
    carry = ours.initialize_carry((5, 2))
    ref_params = ref.init(jax.random.key(0), carry, obs)
    params = ours.init(jax.random.key(0), carry, obs)
    _assert_same_tree(params, dict(ref_params))
    # three steps, so the carry path (orthogonal hidden kernels) is exercised
    c_ours = c_ref = carry
    for t in range(3):
        o = obs + t
        c_ours, out_ours = ours.apply(ref_params, c_ours, o)
        c_ref, out_ref = ref.apply(ref_params, c_ref, o)
        _assert_bitwise((c_ours, out_ours), (c_ref, out_ref))


def test_initializers_follow_flax_rules():
    """Zero biases, lecun-normal kernels (std ≈ 1/sqrt(fan_in)) and
    orthogonal recurrent kernels."""
    model = RecurrentActorCritic(hidden=64, embed=32)
    p = model.init(
        jax.random.key(0), model.initialize_carry((1,)), jnp.zeros((1, 400))
    )["params"]
    assert float(jnp.abs(p["gru"]["ir"]["bias"]).max()) == 0.0
    assert "bias" not in p["gru"]["hr"] and "bias" in p["gru"]["hn"]
    std = float(p["embed"]["kernel"].std())
    assert abs(std - 1 / np.sqrt(400)) < 0.2 / np.sqrt(400)
    w = np.asarray(p["gru"]["hz"]["kernel"])
    np.testing.assert_allclose(w.T @ w, np.eye(64), atol=1e-5)


@pytree.dataclass
class _Pair:
    a: jax.Array
    b: jax.Array


def test_pytree_dataclass_jit_vmap_replace():
    x = _Pair(a=jnp.arange(3.0), b=jnp.ones((3, 2)))
    y = jax.jit(lambda p: p.replace(a=p.a * 2))(x)
    assert isinstance(y, _Pair)
    np.testing.assert_array_equal(np.asarray(y.a), [0.0, 2.0, 4.0])
    np.testing.assert_array_equal(np.asarray(y.b), np.ones((3, 2)))
    s = jax.vmap(lambda p: p.a + p.b.sum())(x)
    np.testing.assert_array_equal(np.asarray(s), [2.0, 3.0, 4.0])
    assert len(jax.tree.leaves(x)) == 2
    with pytest.raises(AttributeError):
        x.a = jnp.zeros(3)  # frozen
