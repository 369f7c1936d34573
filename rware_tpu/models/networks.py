"""Policy/value networks for warehouse agents, in plain JAX.

The reference ships no models (SURVEY.md §2: "no training code"); the
framework's learner stack targets the IPPO/SEAC-style baselines usually run
on RWARE.  Parameters are shared across agents: inputs are
(..., N, obs_dim) and the agent axis is just another batch axis, so one
matmul serves all agents of all envs.

Each network is a frozen dataclass with ``init(key, *example_inputs) ->
params`` and ``apply(params, *inputs)``.  ``params`` is the nested dict
``{"params": {layer: {"kernel": (in, out), "bias": (out,)}}}`` with the
layer names flax.linen gives the same architecture (``dense_i``,
``policy``, ``value``, ``message``, ``embed``, ``gru/{ir,iz,in,hr,hz,hn}``),
so checkpoints written by the earlier flax networks still load.
Kernels are lecun-normal, biases zero, the GRU's recurrent kernels
orthogonal; parameters are stored in float32 and each layer computes in its
``dtype`` (bfloat16 hidden layers, float32 heads).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()
_orthogonal = jax.nn.initializers.orthogonal()


def _dense_init(key, n_in, n_out, *, bias=True, kernel_init=_lecun_normal):
    p = {"kernel": kernel_init(key, (n_in, n_out), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((n_out,), jnp.float32)
    return p


def _dense(p, x, dtype):
    """``x @ kernel + bias`` with inputs and parameters cast to ``dtype``
    and the product computed in it."""
    y = jax.lax.dot_general(
        x.astype(dtype),
        p["kernel"].astype(dtype),
        (((x.ndim - 1,), (0,)), ((), ())),
    )
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def _head_init(key, n_in, heads):
    keys = jax.random.split(key, len(heads))
    return {
        name: _dense_init(k, n_in, width)
        for k, (name, width) in zip(keys, heads)
    }


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Shared-parameter MLP actor-critic.

    ``apply`` returns (logits over n_actions, value); hidden layers compute
    in ``dtype`` (bfloat16), logits and values in float32.

    ``msg_bits > 0`` adds an independent-Bernoulli message head (the env's
    MultiDiscrete([5, 2, ..., 2]) action space, reference
    rware/warehouse.py:152,289-291): the first return becomes a
    ``(move_logits, msg_logits)`` pair.  ``msg_bits=0`` keeps the original
    signature and parameter tree.
    """

    n_actions: int = 5
    hidden: Sequence[int] = (128, 128)
    msg_bits: int = 0
    dtype: Any = jnp.bfloat16

    def _heads(self):
        heads = [("policy", self.n_actions), ("value", 1)]
        if self.msg_bits > 0:
            heads.append(("message", self.msg_bits))
        return heads

    def init(self, key: jax.Array, obs: jax.Array) -> dict:
        widths = (obs.shape[-1], *self.hidden)
        k_trunk, k_head = jax.random.split(key)
        keys = jax.random.split(k_trunk, len(self.hidden))
        p = {
            f"dense_{i}": _dense_init(keys[i], widths[i], widths[i + 1])
            for i in range(len(self.hidden))
        }
        p.update(_head_init(k_head, widths[-1], self._heads()))
        return {"params": p}

    def apply(self, params: dict, obs: jax.Array) -> Tuple[Any, jax.Array]:
        p = params["params"]
        x = obs
        for i in range(len(self.hidden)):
            x = jnp.tanh(_dense(p[f"dense_{i}"], x, self.dtype))
        logits = _dense(p["policy"], x, jnp.float32)
        value = _dense(p["value"], x, jnp.float32)[..., 0]
        if self.msg_bits > 0:
            return (logits, _dense(p["message"], x, jnp.float32)), value
        return logits, value


@dataclasses.dataclass(frozen=True)
class CentralCritic:
    """Centralized value function for MAPPO: V(joint obs) -> one value per
    agent.

    Inputs are the CONCATENATION of every agent's observation
    (..., N * obs_dim, agent-major), so the critic conditions on the full
    decentralized state — the centralized-training / decentralized-
    execution split of MAPPO (Yu et al., 2022), the other standard PPO
    baseline the RWARE literature runs (EPyMARL).  The actor stays the
    shared-parameter :class:`ActorCritic` policy head (its local value
    head is unused under MAPPO).  One (N*L, H) matmul serves all envs;
    the N output heads give per-agent values from the joint state.
    """

    n_agents: int
    hidden: Sequence[int] = (128, 128)
    dtype: Any = jnp.bfloat16

    def init(self, key: jax.Array, joint_obs: jax.Array) -> dict:
        widths = (joint_obs.shape[-1], *self.hidden)
        k_trunk, k_head = jax.random.split(key)
        keys = jax.random.split(k_trunk, len(self.hidden))
        p = {
            f"dense_{i}": _dense_init(keys[i], widths[i], widths[i + 1])
            for i in range(len(self.hidden))
        }
        p.update(_head_init(k_head, widths[-1], [("value", self.n_agents)]))
        return {"params": p}

    def apply(self, params: dict, joint_obs: jax.Array) -> jax.Array:
        p = params["params"]
        x = joint_obs
        for i in range(len(self.hidden)):
            x = jnp.tanh(_dense(p[f"dense_{i}"], x, self.dtype))
        return _dense(p["value"], x, jnp.float32)  # (..., N)


@dataclasses.dataclass(frozen=True)
class RecurrentActorCritic:
    """GRU actor-critic for partially observable play.

    ``apply(params, carry, obs)`` consumes one timestep; carry is the GRU
    state (..., hidden).  Use ``initialize_carry`` for the zero state.  It
    sits inside the rollout ``lax.scan``, so the recurrence and the env
    step compile into one program.  The cell is flax's GRUCell:
    r = σ(W_ir x + b_ir + W_hr h), z = σ(W_iz x + b_iz + W_hz h),
    n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z) n + z h.
    """

    n_actions: int = 5
    hidden: int = 128
    embed: int = 128
    msg_bits: int = 0
    dtype: Any = jnp.bfloat16

    def init(self, key: jax.Array, carry: jax.Array, obs: jax.Array) -> dict:
        del carry  # the hidden width is a field
        k_embed, k_in, k_rec, k_head = jax.random.split(key, 4)
        ki = jax.random.split(k_in, 3)
        kh = jax.random.split(k_rec, 3)
        e, h = self.embed, self.hidden
        gru = {
            name: _dense_init(k, e, h) for k, name in zip(ki, ("ir", "iz", "in"))
        }
        for k, name in zip(kh, ("hr", "hz", "hn")):
            gru[name] = _dense_init(
                k, h, h, bias=name == "hn", kernel_init=_orthogonal
            )
        heads = [("policy", self.n_actions), ("value", 1)]
        if self.msg_bits > 0:
            heads.append(("message", self.msg_bits))
        p = {
            "embed": _dense_init(k_embed, obs.shape[-1], e),
            "gru": gru,
            **_head_init(k_head, h, heads),
        }
        return {"params": p}

    def apply(self, params: dict, carry: jax.Array, obs: jax.Array):
        p = params["params"]
        g = p["gru"]
        dt = self.dtype
        x = jnp.tanh(_dense(p["embed"], obs, dt))
        h = carry
        r = jax.nn.sigmoid(_dense(g["ir"], x, dt) + _dense(g["hr"], h, dt))
        z = jax.nn.sigmoid(_dense(g["iz"], x, dt) + _dense(g["hz"], h, dt))
        n = jnp.tanh(_dense(g["in"], x, dt) + r * _dense(g["hn"], h, dt))
        h = (1.0 - z) * n + z * h
        logits = _dense(p["policy"], h, jnp.float32)
        value = _dense(p["value"], h, jnp.float32)[..., 0]
        if self.msg_bits > 0:
            msg_logits = _dense(p["message"], h, jnp.float32)
            return h, ((logits, msg_logits), value)
        return h, (logits, value)

    def initialize_carry(self, batch_shape: Tuple[int, ...]) -> jax.Array:
        return jnp.zeros(batch_shape + (self.hidden,), dtype=self.dtype)


def sample_action(key: jax.Array, logits: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Categorical sample + log-prob, stable in float32."""
    action = jax.random.categorical(key, logits)
    logp = jnp.take_along_axis(
        jax.nn.log_softmax(logits), action[..., None], axis=-1
    ).squeeze(-1)
    return action.astype(jnp.int32), logp


def bernoulli_logp(logits: jax.Array, bits: jax.Array) -> jax.Array:
    """log p(bits) for independent Bernoullis parameterised by logits."""
    bits = bits.astype(jnp.float32)
    return bits * jax.nn.log_sigmoid(logits) + (1.0 - bits) * jax.nn.log_sigmoid(
        -logits
    )


def sample_action_msg(
    key: jax.Array, move_logits: jax.Array, msg_logits: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Sample the env's composite (move, message-bits) action.

    Returns ``action`` of shape ``(..., 1 + msg_bits)`` int32 — the layout
    the engine's step consumes for msg-bit configs — and the joint log-prob
    (categorical move + independent Bernoulli bits)."""
    k_move, k_msg = jax.random.split(key)
    move, logp_move = sample_action(k_move, move_logits)
    bits = jax.random.bernoulli(k_msg, jax.nn.sigmoid(msg_logits)).astype(
        jnp.int32
    )
    logp = logp_move + bernoulli_logp(msg_logits, bits).sum(-1)
    return jnp.concatenate([move[..., None], bits], axis=-1), logp
