"""MAPPO: centralized-critic PPO, with an MLP or a GRU actor.

The other standard PPO baseline the RWARE literature runs (MAPPO, Yu et
al. 2022; EPyMARL's strongest config): decentralized shared-parameter
actors plus a CENTRALIZED critic that conditions on the concatenation of
every agent's observation (centralized training, decentralized execution).

Trajectory layout: the collector stores the rollout in a "native" layout
that keeps the env batch B = RB * LANE as the two minor axes — obs
(T, L, N, RB, LANE), per-agent tensors (T, N, RB, LANE), done
(T, 1, RB, LANE).  Critic values over the stored trajectory are one
batched dot per update: the joint-obs axis is a transpose+reshape of the
obs block (_joint_native).  GAE and the clipped update run on the same
layout, and each minibatch is a contiguous slice — a time window (MLP
actor) or a band of env rows (GRU actor, whose replay cannot slice time).

The reference ships no training code (SURVEY.md §2); this learner is
framework-added capability alongside IPPO/SEAC.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from rware_tpu.core.env import Warehouse
from rware_tpu.models.ippo import (
    IPPOConfig,
    RunnerState,
    make_optimizer,
    policy_obs_fn,
)
from rware_tpu.models.ippo_rnn import RNNRunnerState, _gru_native_replay
from rware_tpu.models.networks import (
    ActorCritic,
    CentralCritic,
    RecurrentActorCritic,
    bernoulli_logp,
    sample_action,
    sample_action_msg,
)
from rware_tpu.parallel.rollout import autoreset_select

# minor extent of the native trajectory layout: n_envs must be a multiple
LANE = 128


def _native_trunk(p, obs, contract_axis):
    """Dense-stack (dense_0, dense_1, ...) walker on native-layout inputs:
    contracts ``contract_axis`` of ``obs`` against dense_0 without
    materialising a transposed copy, bf16 hidden compute with f32
    accumulation and bf16-rounded tanh pre-activations.  Shared by the
    actor (_native_forward) and the CentralCritic (_critic_native_forward).
    Returns the f32 trunk output with the contracted axis moved to the
    end."""
    x = jax.lax.dot_general(
        obs.astype(jnp.bfloat16),
        p["dense_0"]["kernel"].astype(jnp.bfloat16),
        (((contract_axis,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    x = jnp.tanh((x + p["dense_0"]["bias"]).astype(jnp.bfloat16))
    i = 1
    while f"dense_{i}" in p:
        d = p[f"dense_{i}"]
        x = jax.lax.dot_general(
            x,
            d["kernel"].astype(jnp.bfloat16),
            (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        x = jnp.tanh((x + d["bias"]).astype(jnp.bfloat16))
        i += 1
    return x.astype(jnp.float32)


def _native_forward(params, obs):
    """ActorCritic forward on native-layout obs (..., L, N, RB, LANE).

    Contracts the L axis (axis -4) against dense_0; hidden compute bf16
    with f32 accumulation + f32 heads, as models.networks.ActorCritic.
    Returns logits (..., N, RB, LANE, A) f32 and value (..., N, RB, LANE)
    f32 (plus message logits for msg configs, as ``apply`` does).
    """
    p = params["params"]
    xf = _native_trunk(p, obs, obs.ndim - 4)

    def head(name):
        return (
            jax.lax.dot_general(
                xf,
                p[name]["kernel"].astype(jnp.float32),
                (((xf.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            + p[name]["bias"]
        )

    logits = head("policy")
    value = jnp.squeeze(head("value"), axis=-1)
    if "message" in p:
        return (logits, head("message")), value
    return logits, value


def _joint_native(obs: jax.Array) -> jax.Array:
    """Native-layout obs (T, L, N, RB, LANE) -> joint-obs rows
    (T, N*L, RB, LANE), agent-major (agent i's features contiguous)."""
    t, l, n, rb, lane = obs.shape
    return jnp.transpose(obs, (0, 2, 1, 3, 4)).reshape(t, n * l, rb, lane)


def _critic_native_forward(critic_params, joint_obs: jax.Array) -> jax.Array:
    """CentralCritic forward on native-layout joint obs (T, N*L, RB, LANE):
    the dense-stack walker contracting the joint-feature axis in place,
    then the f32 per-agent value head.  Returns (T, N, RB, LANE) f32."""
    p = critic_params["params"]
    x = _native_trunk(p, joint_obs, 1)  # (T, RB, LANE, H)
    v = jax.lax.dot_general(
        x,
        p["value"]["kernel"].astype(jnp.float32),
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) + p["value"]["bias"]  # (T, RB, LANE, N)
    return jnp.moveaxis(v, -1, 1)


def compute_gae_native(cfg: IPPOConfig, reward, value, done, last_value):
    """GAE on native-layout tensors: reward/value (T, N, RB, LANE), done
    (T, 1, RB, LANE) int32, last_value (N, RB, LANE)."""

    def body(carry, xs):
        g, next_v = carry
        r, v, d = xs
        not_done = 1.0 - d.astype(jnp.float32)  # (1, RB, LANE) broadcasts on N
        delta = r + cfg.gamma * next_v * not_done - v
        g = delta + cfg.gamma * cfg.gae_lambda * not_done * g
        return (g, v), g

    (_, _), advantages = jax.lax.scan(
        body,
        (jnp.zeros_like(last_value), last_value),
        (reward, value, done),
        reverse=True,
    )
    return advantages, advantages + value


def clipped_ppo_terms(cfg: IPPOConfig, heads, value,
                      action, old_logp, old_value, adv, target, bits=None):
    """The clipped-PPO objective on native-layout tensors, given the
    policy heads and the central critic's value.

    ``bits`` (message bits, (T, N*M, RB, LANE) agent-major rows i*M + m)
    switches to the joint move+Bernoulli policy: joint ratio and joint
    entropy, matching the collector's stored logp."""
    msg_entropy = 0.0
    if bits is not None:
        logits, msg_logits = heads  # msg_logits (T, N, RB, LANE, M)
        t, nm, rb, lane = bits.shape
        n = action.shape[1]
        bitsf = jnp.moveaxis(
            bits.reshape(t, n, nm // n, rb, lane), 2, -1
        ).astype(jnp.float32)  # (T, N, RB, LANE, M)
        logp_msg = bernoulli_logp(msg_logits, bitsf).sum(-1)
        p_msg = jax.nn.sigmoid(msg_logits)
        msg_entropy = -(
            p_msg * jax.nn.log_sigmoid(msg_logits)
            + (1.0 - p_msg) * jax.nn.log_sigmoid(-msg_logits)
        ).sum(-1)
    else:
        logits = heads
    logp_all = jax.nn.log_softmax(logits)
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, logits.shape, logits.ndim - 1)
        == action[..., None]
    )
    logp = jnp.sum(jnp.where(onehot, logp_all, 0.0), axis=-1)
    if bits is not None:
        logp = logp + logp_msg
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


def mappo_loss_native(cfg: IPPOConfig, params, batch):
    """Clipped MAPPO loss on a native-layout minibatch
    (obs, action, logp, value, adv, target[, bits]).

    ``params`` = {"actor": ..., "critic": ...}; the policy term uses the
    actor, the value term the CENTRAL critic on the joint observation
    rows.  ``old_value``/``adv``/``target`` are critic-based (the actor's
    local value head takes no part in MAPPO)."""
    obs, action, old_logp, old_value, adv, target, *bits = batch
    heads, _ = _native_forward(params["actor"], obs)
    value = _critic_native_forward(params["critic"], _joint_native(obs))
    return clipped_ppo_terms(
        cfg, heads, value, action, old_logp, old_value, adv, target,
        bits[0] if bits else None,
    )


def rnn_mappo_loss_native(cfg: IPPOConfig, actor, params, batch):
    """Clipped recurrent-MAPPO loss on an env-band minibatch
    (obs, action, logp, value, adv, target, done, h0n[, bits]): the GRU
    actor replays the band from its carry at rollout start h0n
    (N, RB, LANE, H), the central critic reads the joint observation."""
    obs, action, old_logp, old_value, adv, target, done, h0n, *bits = batch
    obs_replay = jnp.transpose(obs, (0, 2, 3, 4, 1))  # (T, N, RB, LANE, L)
    heads, _ = _gru_native_replay(actor, params["actor"], obs_replay, done, h0n)
    value = _critic_native_forward(params["critic"], _joint_native(obs))
    return clipped_ppo_terms(
        cfg, heads, value, action, old_logp, old_value, adv, target,
        bits[0] if bits else None,
    )


def ppo_update_epochs_native(cfg: IPPOConfig, tx, params, opt_state,
                             dataset, key, loss_fn, axes):
    """E epochs x M minibatches over a native-layout dataset tuple.

    Entry i is sliced along ``axes[i]``: each minibatch is a contiguous
    slice after a random per-epoch rotation — sequential reads, no index
    gathers.  ``loss_fn(params, batch) -> (loss, metrics)``."""
    extent = dataset[0].shape[axes[0]]
    if extent % cfg.minibatches:
        raise ValueError(
            f"minibatches={cfg.minibatches} must divide the minibatch axis "
            f"extent {extent}"
        )
    mb = extent // cfg.minibatches

    def epoch(carry, k):
        off = jax.random.randint(k, (), 0, extent)
        rolled = tuple(jnp.roll(x, off, axis=ax) for x, ax in zip(dataset, axes))

        def minibatch(carry, i):
            params, opt_state = carry
            batch = tuple(
                jax.lax.dynamic_slice_in_dim(x, i * mb, mb, ax)
                for x, ax in zip(rolled, axes)
            )
            (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, batch
            )
            updates, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), metrics

        return jax.lax.scan(minibatch, carry, jnp.arange(cfg.minibatches))

    return jax.lax.scan(
        epoch, (params, opt_state), jax.random.split(key, cfg.epochs)
    )


def make_mappo_optimizer(cfg: IPPOConfig) -> optax.GradientTransformation:
    """Split per-part optimizer: the actor and the central critic each get
    their own clip_by_global_norm -> adam chain (the standard MAPPO recipe
    — Yu et al. 2022 run independent actor/critic optimizers), operating
    on {"actor": ..., "critic": ...} grad/param pytrees."""
    tx_a = make_optimizer(cfg)
    tx_c = make_optimizer(cfg)

    def init(params):
        return {
            "actor": tx_a.init(params["actor"]),
            "critic": tx_c.init(params["critic"]),
        }

    def update(grads, state, params=None):
        ua, sa = tx_a.update(
            grads["actor"], state["actor"],
            None if params is None else params["actor"],
        )
        uc, sc = tx_c.update(
            grads["critic"], state["critic"],
            None if params is None else params["critic"],
        )
        return (
            {"actor": ua, "critic": uc},
            {"actor": sa, "critic": sc},
        )

    return optax.GradientTransformation(init, update)


def _build_native_collect(env: Warehouse, cfg: IPPOConfig, policy):
    """XLA rollout that stores the native-layout trajectory.

    ``policy(params, obs, h) -> (heads, new_h)``; ``h`` is the GRU carry
    (B, N, H), reset to zeros at episode boundaries, or None for an MLP
    actor.  Returns ``collect(params, env_states, obs, h, key) ->
    (env_states, obs, h, traj)``."""
    step_fn = jax.vmap(env._step_fn)
    reset_fn = env._reset_fn
    obs_fn = jax.vmap(policy_obs_fn(env))
    msg = env.config.msg_bits
    n_agents = env.n_agents
    obs_dim = env.config.policy_obs_length
    t_len = cfg.rollout_len
    if cfg.n_envs % LANE:
        raise ValueError(
            f"n_envs={cfg.n_envs} must be a multiple of LANE={LANE} for "
            "the native trajectory layout"
        )
    rb = cfg.n_envs // LANE

    def native(x):  # (T, B, N, ...) -> (T, N, ..., RB, LANE)
        x = jnp.moveaxis(x, 1, -1)
        return x.reshape(x.shape[:-1] + (rb, LANE))

    def collect(params, env_states, obs, h, key):
        def one(carry, k):
            states, obs, h = carry
            heads, h = policy(params, obs, h)
            if msg:
                action, logp = sample_action_msg(k, *heads)
                move = action[..., 0]
            else:
                action, logp = sample_action(k, heads)
                move = action
            res = step_fn(states, action)
            nxt = jax.vmap(lambda s, d: autoreset_select(reset_fn, s, d))(
                res.state, res.done
            )
            if h is not None:
                h = jnp.where(res.done[:, None, None], jnp.zeros_like(h), h)
            out = (obs, move, logp, res.rewards, res.done) + (
                (action[..., 1:],) if msg else ()
            )
            return (nxt, obs_fn(nxt), h), out

        (env_states, obs, h), t = jax.lax.scan(
            one, (env_states, obs, h), jax.random.split(key, t_len)
        )
        obs_t, move_t, logp_t, rew_t, done_t = t[:5]
        traj = {
            # (T, B, N, L) -> (T, L, N, RB, LANE)
            "obs": jnp.transpose(obs_t, (0, 3, 2, 1))
            .reshape(t_len, obs_dim, n_agents, rb, LANE)
            .astype(jnp.bfloat16),
            "action": native(move_t).astype(jnp.int32),
            "logp": native(logp_t),
            "reward": native(rew_t),
            "done": done_t.reshape(t_len, 1, rb, LANE).astype(jnp.int32),
        }
        if msg:
            # (T, B, N, M) -> agent-major rows (T, N*M, RB, LANE)
            traj["bits"] = (
                jnp.transpose(t[5], (0, 2, 3, 1))
                .reshape(t_len, -1, rb, LANE)
                .astype(jnp.int32)
            )
        return env_states, obs, h, traj

    return collect


def _critic_targets(cfg, critic, critic_params, traj, obs):
    """Old critic values over the stored trajectory, the bootstrap value
    from the post-rollout joint observation, and native GAE."""
    values = _critic_native_forward(
        critic_params, _joint_native(traj["obs"])
    )  # (T, N, RB, LANE)
    b, n, l = obs.shape
    last_value = critic.apply(critic_params, obs.reshape(b, n * l))  # (B, N)
    last_value = jnp.swapaxes(last_value, 0, 1).reshape(n, b // LANE, LANE)
    advantages, targets = compute_gae_native(
        cfg, traj["reward"], values, traj["done"], last_value
    )
    return values, advantages, targets


def _rollout_metrics(cfg, traj, metrics):
    return {
        "reward_per_env": traj["reward"].sum() / cfg.n_envs,
        "episodes_done": traj["done"].sum(),
        **jax.tree.map(lambda x: x.mean(), metrics),
    }


def init_mappo_runner(
    env: Warehouse,
    cfg: IPPOConfig,
    key: jax.Array,
    actor: Optional[ActorCritic] = None,
    critic: Optional[CentralCritic] = None,
) -> Tuple[RunnerState, ActorCritic, CentralCritic,
           optax.GradientTransformation]:
    """params = {"actor": ..., "critic": ...} under the split per-part
    optimizer (make_mappo_optimizer)."""
    if actor is None:
        actor = ActorCritic(
            n_actions=env.n_actions, msg_bits=env.config.msg_bits
        )
    if critic is None:
        critic = CentralCritic(n_agents=env.n_agents)
    k_actor, k_critic, k_env, k_run = jax.random.split(key, 4)
    obs_dim = env.config.policy_obs_length
    n = env.n_agents
    params = {
        "actor": actor.init(k_actor, jnp.zeros((1, n, obs_dim))),
        "critic": critic.init(k_critic, jnp.zeros((1, n * obs_dim))),
    }
    tx = make_mappo_optimizer(cfg)
    env_states = jax.vmap(env._reset_fn)(
        jax.random.split(k_env, cfg.n_envs)
    )
    obs = jax.vmap(policy_obs_fn(env))(env_states)
    runner = RunnerState(
        params=params,
        opt_state=tx.init(params),
        env_states=env_states,
        obs=obs,
        key=k_run,
        update_idx=jnp.zeros((), jnp.int32),
    )
    return runner, actor, critic, tx


def build_mappo_train_step(
    env: Warehouse,
    actor: ActorCritic,
    critic: CentralCritic,
    tx: optax.GradientTransformation,
    cfg: IPPOConfig,
):
    """One jitted MAPPO update: XLA collect into the native layout ->
    critic values over the stored trajectory -> native GAE -> E x M
    clipped updates of {actor, critic} on time-window minibatches."""

    def policy(params, obs, h):
        heads, _ = actor.apply(params, obs)
        return heads, h

    collect = _build_native_collect(env, cfg, policy)

    def loss_fn(params, batch):
        return mappo_loss_native(cfg, params, batch)

    def train_step(runner: RunnerState) -> Tuple[RunnerState, dict]:
        key, k_perm, k_roll = jax.random.split(runner.key, 3)
        env_states, obs, _, traj = collect(
            runner.params["actor"], runner.env_states, runner.obs, None,
            k_roll,
        )
        values, advantages, targets = _critic_targets(
            cfg, critic, runner.params["critic"], traj, obs
        )
        dataset = (
            traj["obs"], traj["action"], traj["logp"],
            values, advantages, targets,
        ) + ((traj["bits"],) if "bits" in traj else ())
        (params, opt_state), metrics = ppo_update_epochs_native(
            cfg, tx, runner.params, runner.opt_state, dataset, k_perm,
            loss_fn, axes=(0,) * len(dataset),
        )
        return (
            RunnerState(
                params=params,
                opt_state=opt_state,
                env_states=env_states,
                obs=obs,
                key=key,
                update_idx=runner.update_idx + 1,
            ),
            _rollout_metrics(cfg, traj, metrics),
        )

    return train_step


# ---------------------------------------------------------------------------
# Recurrent MAPPO: GRU actor + central critic.
# ---------------------------------------------------------------------------


def init_rnn_mappo_runner(
    env: Warehouse,
    cfg: IPPOConfig,
    key: jax.Array,
    actor: Optional[RecurrentActorCritic] = None,
    critic: Optional[CentralCritic] = None,
):
    """Recurrent MAPPO runner: ``params = {"actor": RecurrentActorCritic
    pytree, "critic": CentralCritic pytree}`` on an RNNRunnerState (the
    GRU carry rides the runner exactly as in recurrent IPPO), under the
    split per-part optimizer.

    This is the literature's strongest RWARE config (MAPPO as in Yu et
    al. 2022 is recurrent)."""
    if actor is None:
        actor = RecurrentActorCritic(
            n_actions=env.n_actions, msg_bits=env.config.msg_bits
        )
    if critic is None:
        critic = CentralCritic(n_agents=env.n_agents)
    k_actor, k_critic, k_env, k_run = jax.random.split(key, 4)
    obs_dim = env.config.policy_obs_length
    n = env.n_agents
    carry0 = actor.initialize_carry((1, n))
    params = {
        "actor": actor.init(k_actor, carry0, jnp.zeros((1, n, obs_dim))),
        "critic": critic.init(k_critic, jnp.zeros((1, n * obs_dim))),
    }
    tx = make_mappo_optimizer(cfg)
    env_states = jax.vmap(env._reset_fn)(
        jax.random.split(k_env, cfg.n_envs)
    )
    obs = jax.vmap(policy_obs_fn(env))(env_states)
    runner = RNNRunnerState(
        params=params,
        opt_state=tx.init(params),
        env_states=env_states,
        obs=obs,
        carry=actor.initialize_carry((cfg.n_envs, n)),
        key=k_run,
        update_idx=jnp.zeros((), jnp.int32),
    )
    return runner, actor, critic, tx


def build_rnn_mappo_train_step(
    env: Warehouse,
    actor: RecurrentActorCritic,
    critic: CentralCritic,
    tx: optax.GradientTransformation,
    cfg: IPPOConfig,
):
    """One jitted recurrent-MAPPO update: XLA collect with the GRU actor
    (episode-boundary carry resets) -> central-critic values over the
    stored trajectory -> native GAE -> E x M env-band minibatch updates,
    each replaying the GRU over its band from the carry at rollout start
    (_gru_native_replay).

    Message bits are supported: the actor samples the Bernoulli message
    head, the loss takes the joint move+message log-prob, and the central
    critic is msg-agnostic — the joint obs already carries neighbours'
    message features through policy_obs_length."""
    n_agents = env.n_agents
    hg = int(actor.hidden)

    def policy(params, obs, h):
        h, (heads, _) = actor.apply(params, h, obs)
        return heads, h

    collect = _build_native_collect(env, cfg, policy)

    def loss_fn(params, batch):
        return rnn_mappo_loss_native(cfg, actor, params, batch)

    def train_step(runner: RNNRunnerState):
        key, k_perm, k_roll = jax.random.split(runner.key, 3)
        h0 = runner.carry  # (B, N, H) at rollout start
        env_states, obs, carry, traj = collect(
            runner.params["actor"], runner.env_states, runner.obs, h0, k_roll
        )
        values, advantages, targets = _critic_targets(
            cfg, critic, runner.params["critic"], traj, obs
        )
        h0n = jnp.transpose(h0, (1, 0, 2)).reshape(
            n_agents, cfg.n_envs // LANE, LANE, hg
        )
        dataset = (
            traj["obs"], traj["action"], traj["logp"], values, advantages,
            targets, traj["done"], h0n,
        ) + ((traj["bits"],) if "bits" in traj else ())
        # env-row axis of each entry (obs rows sit one axis further in,
        # the carry has no time axis)
        axes = (3, 2, 2, 2, 2, 2, 2, 1, 2)[: len(dataset)]
        (params, opt_state), metrics = ppo_update_epochs_native(
            cfg, tx, runner.params, runner.opt_state, dataset, k_perm,
            loss_fn, axes=axes,
        )
        return (
            RNNRunnerState(
                params=params,
                opt_state=opt_state,
                env_states=env_states,
                obs=obs,
                carry=carry,
                key=key,
                update_idx=runner.update_idx + 1,
            ),
            _rollout_metrics(cfg, traj, metrics),
        )

    return train_step
