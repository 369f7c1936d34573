"""IPPO: independent PPO with parameter sharing — the flagship learner.

The reference has no training stack; this is the learner the RWARE
literature runs on it (IPPO as in the SEAC/EPyMARL line of work).
Design: the entire train step — T-step rollout (policy + env fused in one
``lax.scan``), GAE, and E epochs × M minibatches of clipped-PPO SGD — is ONE
jitted program over an env-batched state.  Multi-device: shard the env axis
of ``env_states``/``obs`` over the mesh, replicate params; XLA turns the
gradient reduction into an all-reduce (see rware_tpu.parallel.sharding).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from rware_tpu import pytree
from rware_tpu.core.env import Warehouse
from rware_tpu.core.state import WarehouseState
from rware_tpu.models.networks import ActorCritic, sample_action


@dataclasses.dataclass(frozen=True)
class IPPOConfig:
    n_envs: int = 1024
    rollout_len: int = 128
    epochs: int = 4
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    anneal_lr: bool = False
    total_updates: int = 1000  # for lr annealing
    # "shuffle": classic PPO random-permutation minibatches (random-index
    # gathers); "block": a random per-epoch offset then contiguous slices —
    # sequential reads, minibatches are time-bands over all envs
    minibatch_mode: str = "shuffle"


@pytree.dataclass
class RunnerState:
    """Everything the train loop carries between updates."""

    params: Any
    opt_state: Any
    env_states: WarehouseState  # env-batched (B, ...)
    obs: jax.Array  # (B, N, L)
    key: jax.Array
    update_idx: jax.Array  # () int32


class Transition(NamedTuple):
    obs: jax.Array  # (B, N, L)
    action: jax.Array  # (B, N)
    logp: jax.Array  # (B, N)
    value: jax.Array  # (B, N)
    reward: jax.Array  # (B, N)
    done: jax.Array  # (B,)


def policy_obs_fn(env: Warehouse):
    """Per-env observation as flat (N, L) vectors for the MLP learners.

    FLATTENED/DICT configs pass through; IMAGE configs flatten the
    (N, C, w2, w2) window stack; IMAGE_DICT configs flatten the window
    stack and append the 6 self features [dir-onehot(4), on_highway,
    carrying] (reference rware/warehouse.py:725-742 — matching the
    in-kernel collector).  L = config.policy_obs_length either way.
    """
    from rware_tpu.types import ObservationType

    obs_fn = env._obs_fn
    ot = env.config.observation_type
    n = env.n_agents
    if ot == ObservationType.IMAGE:
        return lambda s: obs_fn(s).reshape(n, -1)
    if ot == ObservationType.IMAGE_DICT:
        def imgdict_obs(s):
            o = obs_fn(s)
            return jnp.concatenate(
                [o["image"].reshape(n, -1), o["features"]], axis=-1
            )

        return imgdict_obs
    return obs_fn


def compute_gae(cfg: IPPOConfig, rewards, values, dones, last_value):
    """GAE over a (T, B, N) trajectory with (T, B) done masks."""

    def body(carry, xs):
        g, next_v = carry
        reward, value, done = xs
        not_done = 1.0 - done.astype(jnp.float32)[:, None]
        delta = reward + cfg.gamma * next_v * not_done - value
        g = delta + cfg.gamma * cfg.gae_lambda * not_done * g
        return (g, value), g

    (_, _), advantages = jax.lax.scan(
        body,
        (jnp.zeros_like(last_value), last_value),
        (rewards, values, dones),
        reverse=True,
    )
    return advantages, advantages + values


def ppo_loss(model, cfg: IPPOConfig, params, batch):
    """Clipped-PPO loss on a flat (M, N, ...) minibatch.

    Message mode is detected statically from the action rank: a composite
    ``(M, N, 1 + msg_bits)`` action (vs plain ``(M, N)``) means the model
    carries a Bernoulli message head, and logp/entropy are joint over the
    move categorical and the message bits.
    """
    from rware_tpu.models.networks import bernoulli_logp

    obs, action, old_logp, old_value, adv, target = batch
    msg_mode = action.ndim == obs.ndim
    heads, value = model.apply(params, obs)
    if msg_mode:
        move_logits, msg_logits = heads
        move, bits = action[..., 0], action[..., 1:]
        logp_all = jax.nn.log_softmax(move_logits)
        logp = (
            jnp.take_along_axis(logp_all, move[..., None], -1).squeeze(-1)
            + bernoulli_logp(msg_logits, bits).sum(-1)
        )
        p_msg = jax.nn.sigmoid(msg_logits)
        msg_entropy = -(
            p_msg * jax.nn.log_sigmoid(msg_logits)
            + (1.0 - p_msg) * jax.nn.log_sigmoid(-msg_logits)
        ).sum(-1)
    else:
        logits = heads
        logp_all = jax.nn.log_softmax(logits)
        logp = jnp.take_along_axis(logp_all, action[..., None], -1).squeeze(-1)
        msg_entropy = 0.0
    ratio = jnp.exp(logp - old_logp)
    adv_norm = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg1 = ratio * adv_norm
    pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_norm
    pg_loss = -jnp.minimum(pg1, pg2).mean()

    v_clipped = old_value + jnp.clip(
        value - old_value, -cfg.clip_eps, cfg.clip_eps
    )
    v_loss = 0.5 * jnp.maximum(
        (value - target) ** 2, (v_clipped - target) ** 2
    ).mean()

    entropy = (-(jnp.exp(logp_all) * logp_all).sum(-1) + msg_entropy).mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    return total, {
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": entropy,
        "approx_kl": ((ratio - 1) - jnp.log(ratio)).mean(),
    }


def ppo_update_epochs(model, cfg: IPPOConfig, tx, params, opt_state, dataset, key):
    """E epochs x M minibatches of SGD over a flat dataset tuple.

    cfg.minibatch_mode selects how minibatches are drawn (see IPPOConfig).
    """
    n_data = dataset[0].shape[0]
    mb_size = n_data // cfg.minibatches

    def sgd_step(params, opt_state, batch):
        (loss, metrics), grads = jax.value_and_grad(
            ppo_loss, argnums=2, has_aux=True
        )(model, cfg, params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, metrics

    if cfg.minibatch_mode == "block":

        def epoch(carry, key):
            params, opt_state = carry
            off = jax.random.randint(key, (), 0, n_data)
            rolled = jax.tree.map(lambda x: jnp.roll(x, off, axis=0), dataset)

            def minibatch(carry, i):
                params, opt_state = carry
                batch = jax.tree.map(
                    lambda x: jax.lax.dynamic_slice_in_dim(
                        x, i * mb_size, mb_size, 0
                    ),
                    rolled,
                )
                params, opt_state, metrics = sgd_step(params, opt_state, batch)
                return (params, opt_state), metrics

            return jax.lax.scan(
                minibatch, (params, opt_state), jnp.arange(cfg.minibatches)
            )

    else:

        def epoch(carry, key):
            params, opt_state = carry
            perm = jax.random.permutation(key, n_data)

            def minibatch(carry, idx):
                params, opt_state = carry
                batch = jax.tree.map(
                    lambda x: jnp.take(x, idx, axis=0), dataset
                )
                params, opt_state, metrics = sgd_step(params, opt_state, batch)
                return (params, opt_state), metrics

            idxs = perm[: mb_size * cfg.minibatches].reshape(
                cfg.minibatches, mb_size
            )
            return jax.lax.scan(minibatch, (params, opt_state), idxs)

    return jax.lax.scan(
        epoch, (params, opt_state), jax.random.split(key, cfg.epochs)
    )


def make_optimizer(cfg: IPPOConfig) -> optax.GradientTransformation:
    sched = (
        optax.linear_schedule(
            cfg.lr, 0.0, cfg.total_updates * cfg.epochs * cfg.minibatches
        )
        if cfg.anneal_lr
        else cfg.lr
    )
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(sched, eps=1e-5),
    )


def init_runner(
    env: Warehouse,
    cfg: IPPOConfig,
    key: jax.Array,
    model: Optional[ActorCritic] = None,
) -> Tuple[RunnerState, ActorCritic, optax.GradientTransformation]:
    """Initialise params, optimiser and a fresh batch of env states."""
    if model is None:
        model = ActorCritic(
            n_actions=env.n_actions, msg_bits=env.config.msg_bits
        )
    k_param, k_env, k_run = jax.random.split(key, 3)
    obs_dim = env.config.policy_obs_length
    params = model.init(k_param, jnp.zeros((1, env.n_agents, obs_dim)))
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)
    env_keys = jax.random.split(k_env, cfg.n_envs)
    env_states = jax.vmap(env._reset_fn)(env_keys)
    obs = jax.vmap(policy_obs_fn(env))(env_states)
    runner = RunnerState(
        params=params,
        opt_state=opt_state,
        env_states=env_states,
        obs=obs,
        key=k_run,
        update_idx=jnp.zeros((), jnp.int32),
    )
    return runner, model, tx


def build_train_step(
    env: Warehouse,
    model: ActorCritic,
    tx: optax.GradientTransformation,
    cfg: IPPOConfig,
) -> Callable[[RunnerState], Tuple[RunnerState, dict]]:
    """Returns the fully fused ``train_step(runner) -> (runner, metrics)``."""
    from rware_tpu.parallel.rollout import autoreset_select

    step_fn = jax.vmap(env._step_fn)
    reset_fn = env._reset_fn
    obs_fn = policy_obs_fn(env)

    msg_mode = getattr(model, "msg_bits", 0) > 0

    def collect(carry, key):
        params, env_states, obs = carry
        k_act, _ = jax.random.split(key)
        heads, value = model.apply(params, obs)
        if msg_mode:
            from rware_tpu.models.networks import sample_action_msg

            action, logp = sample_action_msg(k_act, *heads)
        else:
            action, logp = sample_action(k_act, heads)
        res = step_fn(env_states, action)
        next_states = jax.vmap(
            lambda s, d: autoreset_select(reset_fn, s, d)
        )(res.state, res.done)
        next_obs = jax.vmap(obs_fn)(next_states)
        t = Transition(obs, action, logp, value, res.rewards, res.done)
        return (params, next_states, next_obs), t

    def train_step(runner: RunnerState) -> Tuple[RunnerState, dict]:
        key, k_roll, k_perm = jax.random.split(runner.key, 3)

        # --- rollout: T fused env+policy steps.
        roll_keys = jax.random.split(k_roll, cfg.rollout_len)
        (params, env_states, obs), traj = jax.lax.scan(
            collect, (runner.params, runner.env_states, runner.obs), roll_keys
        )
        _, last_value = model.apply(params, obs)
        advantages, targets = compute_gae(
            cfg, traj.reward, traj.value, traj.done, last_value
        )

        # --- flatten (T, B, N) -> (T*B, N, ...): the agent axis stays a
        # batch axis of the matmul.
        def flat(x):
            return x.reshape((cfg.rollout_len * cfg.n_envs,) + x.shape[2:])

        dataset = (
            flat(traj.obs),
            flat(traj.action),
            flat(traj.logp),
            flat(traj.value),
            flat(advantages),
            flat(targets),
        )
        (params, opt_state), metrics = ppo_update_epochs(
            model, cfg, tx, runner.params, runner.opt_state, dataset, k_perm
        )

        mean_reward = traj.reward.sum() / cfg.n_envs
        out_metrics = {
            "reward_per_env": mean_reward,
            "episodes_done": traj.done.sum(),
            **jax.tree.map(lambda x: x.mean(), metrics),
        }
        new_runner = RunnerState(
            params=params,
            opt_state=opt_state,
            env_states=env_states,
            obs=obs,
            key=key,
            update_idx=runner.update_idx + 1,
        )
        return new_runner, out_metrics

    return train_step
