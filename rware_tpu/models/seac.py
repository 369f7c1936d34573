"""SEAC: Shared Experience Actor-Critic (Christianos et al., NeurIPS 2020).

The algorithm the reference env was built to study: each agent keeps its OWN
actor-critic parameters but also learns from the other agents' transitions
via importance-weighted off-policy corrections —

  L_pi(i)  = -logpi_i(a_i|o_i) A_ii  - lambda * sum_{j!=i} w_ij logpi_i(a_j|o_j) A_ij
  L_v(i)   = ||V_i(o_i) - R_ii||^2  + lambda * sum_{j!=i} w_ij ||V_i(o_j) - R_ij||^2
  w_ij     = pi_i(a_j|o_j) / pi_j(a_j|o_j)   (stop-gradient)

where A_ij / R_ij are advantage/return of agent j's experience evaluated
with agent i's critic.  Layout: per-agent parameters are ONE stacked
pytree with a leading agent axis, every cross-pair (i evaluates j's
experience) is a vmap x vmap — an (N, N) grid of batched MLP forwards that
XLA batches into single matmuls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from rware_tpu import pytree
from rware_tpu.core.env import Warehouse
from rware_tpu.models.networks import ActorCritic, sample_action


@dataclasses.dataclass(frozen=True)
class SEACConfig:
    n_envs: int = 256
    rollout_len: int = 5  # short n-step rollouts, as in the paper (A2C-style)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    seac_lambda: float = 1.0  # weight of shared-experience terms
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5


@pytree.dataclass
class SEACRunner:
    params: Any  # stacked per-agent params, leading axis N
    opt_state: Any
    env_states: Any  # (B, ...)
    obs: jax.Array  # (B, N, L)
    key: jax.Array
    update_idx: jax.Array


class SEACTransition(NamedTuple):
    obs: jax.Array  # (B, N, L)
    action: jax.Array  # (B, N), or (B, N, 1 + msg_bits) for msg configs
    logp: jax.Array  # (B, N) log pi_j(a_j|o_j) of the acting agent
    reward: jax.Array  # (B, N)
    done: jax.Array  # (B,)


def init_seac(
    env: Warehouse,
    cfg: SEACConfig,
    key: jax.Array,
    model: Optional[ActorCritic] = None,
) -> Tuple[SEACRunner, ActorCritic, optax.GradientTransformation]:
    if model is None:
        model = ActorCritic(
            n_actions=env.n_actions, msg_bits=env.config.msg_bits
        )
    n = env.n_agents
    obs_dim = env.config.policy_obs_length
    k_par, k_env, k_run = jax.random.split(key, 3)
    # independent init per agent: stacked params with leading agent axis
    params = jax.vmap(
        lambda k: model.init(k, jnp.zeros((1, obs_dim)))
    )(jax.random.split(k_par, n))
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(cfg.lr, eps=1e-5),
    )
    opt_state = tx.init(params)
    env_states = jax.vmap(env._reset_fn)(jax.random.split(k_env, cfg.n_envs))
    from rware_tpu.models.ippo import policy_obs_fn

    obs = jax.vmap(policy_obs_fn(env))(env_states)
    return (
        SEACRunner(
            params=params,
            opt_state=opt_state,
            env_states=env_states,
            obs=obs,
            key=k_run,
            update_idx=jnp.zeros((), jnp.int32),
        ),
        model,
        tx,
    )


def build_seac_train_step(
    env: Warehouse,
    model: ActorCritic,
    tx: optax.GradientTransformation,
    cfg: SEACConfig,
) -> Callable[[SEACRunner], Tuple[SEACRunner, dict]]:
    step_fn = jax.vmap(env._step_fn)
    reset_fn = env._reset_fn
    from rware_tpu.models.ippo import policy_obs_fn
    from rware_tpu.models.networks import bernoulli_logp, sample_action_msg

    obs_fn = policy_obs_fn(env)
    n = env.n_agents
    msg_mode = getattr(model, "msg_bits", 0) > 0

    def apply_own(params, obs):
        # params: stacked (N, ...); obs: (B, N, L) -> per-agent forward.
        # vmap over the agent axis pairing params[i] with obs[:, i].
        return jax.vmap(
            lambda p, o: model.apply(p, o), in_axes=(0, 1), out_axes=1
        )(params, obs)

    def collect(carry, key):
        params, env_states, obs = carry
        k_act, _ = jax.random.split(key)
        heads, _ = apply_own(params, obs)  # (B, N, A)
        if msg_mode:
            action, logp = sample_action_msg(k_act, *heads)
        else:
            action, logp = sample_action(k_act, heads)
        res = step_fn(env_states, action)
        from rware_tpu.parallel.rollout import autoreset_select

        next_states = jax.vmap(
            lambda s, d: autoreset_select(reset_fn, s, d)
        )(res.state, res.done)
        next_obs = jax.vmap(obs_fn)(next_states)
        return (params, next_states, next_obs), SEACTransition(
            obs, action, logp, res.rewards, res.done
        )

    def cross_joint_logp(heads_cross, action):
        """log pi_i(a_j | o_j) with the (move, bits) composite action when
        the model carries a message head; returns (logp_cross, entropy_map)
        both (N_i, T, B, N_j)."""
        if msg_mode:
            logits_cross, msg_cross = heads_cross
            move = action[..., 0]
            bits = action[..., 1:]
        else:
            logits_cross = heads_cross
            move = action
        logp_all = jax.nn.log_softmax(logits_cross)
        logp_cross = jnp.take_along_axis(
            logp_all, move[None, ..., None], axis=-1
        ).squeeze(-1)
        probs = jnp.exp(logp_all)
        ent_map = -(probs * logp_all).sum(-1)
        if msg_mode:
            logp_cross = logp_cross + bernoulli_logp(
                msg_cross, bits[None]
            ).sum(-1)
            p_msg = jax.nn.sigmoid(msg_cross)
            ent_map = ent_map - (
                p_msg * jax.nn.log_sigmoid(msg_cross)
                + (1.0 - p_msg) * jax.nn.log_sigmoid(-msg_cross)
            ).sum(-1)
        return logp_cross, ent_map

    def loss_fn(params, traj: SEACTransition, last_obs):
        T, B = traj.reward.shape[0], traj.reward.shape[1]

        # cross forwards: agent i's network on agent j's observations.
        # obs (T, B, N, L) -> heads (N_i, T, B, N_j, ...), values
        # (N_i, T, B, N_j)
        def apply_i(p):
            return model.apply(p, traj.obs)

        heads_cross, values_cross = jax.vmap(apply_i)(params)
        _, last_values_cross = jax.vmap(lambda p: model.apply(p, last_obs))(
            params
        )  # (N_i, B, N_j)

        # GAE of agent j's reward stream under agent i's critic.
        not_done = 1.0 - traj.done.astype(jnp.float32)  # (T, B)

        def gae_for_i(values_i, last_value_i):
            def body(carry, xs):
                g, next_v = carry
                v, r, nd = xs
                delta = r + cfg.gamma * next_v * nd[:, None] - v
                g = delta + cfg.gamma * cfg.gae_lambda * nd[:, None] * g
                return (g, v), g

            (_, _), adv = jax.lax.scan(
                body,
                (jnp.zeros_like(last_value_i), last_value_i),
                (values_i, traj.reward, not_done),
                reverse=True,
            )
            return adv

        adv_cross = jax.vmap(gae_for_i)(values_cross, last_values_cross)
        target_cross = adv_cross + values_cross  # (N_i, T, B, N_j)

        # log pi_i(a_j | o_j): (N_i, T, B, N_j) — joint over move + bits
        logp_cross, ent_map = cross_joint_logp(heads_cross, traj.action)

        # importance weights w_ij = pi_i / pi_j (stop-grad), w_ii = 1
        w = jnp.exp(jax.lax.stop_gradient(logp_cross) - traj.logp[None])
        eye = jnp.eye(n)[:, None, None, :]  # (N_i, 1, 1, N_j)
        weight = eye + cfg.seac_lambda * w * (1.0 - eye)

        adv_sg = jax.lax.stop_gradient(adv_cross)
        pg_loss = -(weight * logp_cross * adv_sg).sum() / (T * B * n)
        v_loss = (
            0.5
            * (weight * (values_cross - jax.lax.stop_gradient(target_cross)) ** 2).sum()
            / (T * B * n)
        )

        # entropy of each agent's OWN policy only: the (i == j) diagonal
        entropy = jnp.diagonal(ent_map, axis1=0, axis2=3).mean()

        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        return total, {
            "pg_loss": pg_loss,
            "v_loss": v_loss,
            "entropy": entropy,
            "mean_is_weight": w.mean(),
        }

    def train_step(runner: SEACRunner) -> Tuple[SEACRunner, dict]:
        key, k_roll = jax.random.split(runner.key)
        roll_keys = jax.random.split(k_roll, cfg.rollout_len)
        (params, env_states, obs), traj = jax.lax.scan(
            collect, (runner.params, runner.env_states, runner.obs), roll_keys
        )
        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            runner.params, traj, obs
        )
        updates, opt_state = tx.update(grads, runner.opt_state, runner.params)
        params = optax.apply_updates(runner.params, updates)
        metrics = {
            **metrics,
            "reward_per_env": traj.reward.sum() / cfg.n_envs,
            "episodes_done": traj.done.sum(),
        }
        return (
            SEACRunner(
                params=params,
                opt_state=opt_state,
                env_states=env_states,
                obs=obs,
                key=key,
                update_idx=runner.update_idx + 1,
            ),
            metrics,
        )

    return train_step


# ---------------------------------------------------------------------------
# SEAC-PPO: the shared-experience objective on a PPO trust region.
#
# The paper's 5-step A2C needs tens of millions of steps before the sparse
# delivery reward registers (its Table 2 budgets); on an accelerator the
# long-rollout PPO machinery is cheap, so this variant keeps SEAC's defining
# structure — per-agent parameters, each agent learning from every agent's
# experience with importance weighting — but replaces the plain policy
# gradient with the clipped surrogate: for agent i on agent j's data the
# ratio pi_i_new(a_j|o_j) / pi_j_behaviour(a_j|o_j) IS the SEAC importance
# weight, and clipping it bounds the off-policy correction exactly where
# SEAC truncates w_ij.  This is the learner validated to improve reward
# (BASELINE.md, SEAC learning validation).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SEACPPOConfig:
    n_envs: int = 1024
    rollout_len: int = 128
    epochs: int = 4
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    seac_lambda: float = 1.0
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5


def init_seac_ppo(
    env: Warehouse,
    cfg: SEACPPOConfig,
    key: jax.Array,
    model: Optional[ActorCritic] = None,
):
    """Same runner layout as init_seac (stacked per-agent params)."""
    base = SEACConfig(
        n_envs=cfg.n_envs, rollout_len=cfg.rollout_len, lr=cfg.lr,
        max_grad_norm=cfg.max_grad_norm,
    )
    return init_seac(env, base, key, model)


def build_seac_ppo_train_step(
    env: Warehouse,
    model: ActorCritic,
    tx: optax.GradientTransformation,
    cfg: SEACPPOConfig,
) -> Callable[[SEACRunner], Tuple[SEACRunner, dict]]:
    """One jitted shared-experience PPO update: per-agent XLA collect ->
    old-policy cross values -> cross GAE -> E x M minibatch updates over
    the (N_i, N_j) grid.  Message configs take every cross log-prob and
    ratio jointly over (move, bits)."""
    step_fn = jax.vmap(env._step_fn)
    reset_fn = env._reset_fn
    from rware_tpu.models.ippo import policy_obs_fn
    from rware_tpu.models.networks import bernoulli_logp, sample_action_msg

    obs_fn = policy_obs_fn(env)
    n = env.n_agents
    eye = jnp.eye(n)  # (N_i, N_j)
    msg_mode = getattr(model, "msg_bits", 0) > 0

    def apply_own(params, obs):
        return jax.vmap(
            lambda p, o: model.apply(p, o), in_axes=(0, 1), out_axes=1
        )(params, obs)

    def collect(carry, key):
        params, env_states, obs = carry
        k_act, _ = jax.random.split(key)
        heads, _ = apply_own(params, obs)
        if msg_mode:
            action, logp = sample_action_msg(k_act, *heads)
        else:
            action, logp = sample_action(k_act, heads)
        res = step_fn(env_states, action)
        from rware_tpu.parallel.rollout import autoreset_select

        next_states = jax.vmap(
            lambda s, d: autoreset_select(reset_fn, s, d)
        )(res.state, res.done)
        next_obs = jax.vmap(obs_fn)(next_states)
        return (params, next_states, next_obs), SEACTransition(
            obs, action, logp, res.rewards, res.done
        )

    def cross_logp(heads_cross, action):
        """Joint log pi_i(a_j | o_j) and per-pair entropy.

        heads (..., N_i, N_j, A) (+ msg (..., N_i, N_j, Mb)), action
        (..., N_j[, 1 + Mb]) -> (logp (..., N_i, N_j), ent_map same)."""
        if msg_mode:
            logits_cross, msg_cross = heads_cross
            move = action[..., 0]
            bits = action[..., 1:]
        else:
            logits_cross = heads_cross
            move = action
        lsm = jax.nn.log_softmax(logits_cross)
        logp = jnp.take_along_axis(
            lsm, move[..., None, :, None], axis=-1
        ).squeeze(-1)
        ent_map = -(jnp.exp(lsm) * lsm).sum(-1)
        if msg_mode:
            logp = logp + bernoulli_logp(
                msg_cross, bits[..., None, :, :]
            ).sum(-1)
            p_msg = jax.nn.sigmoid(msg_cross)
            ent_map = ent_map - (
                p_msg * jax.nn.log_sigmoid(msg_cross)
                + (1.0 - p_msg) * jax.nn.log_sigmoid(-msg_cross)
            ).sum(-1)
        return logp, ent_map

    def minibatch_loss(params, batch):
        obs, action, behav_logp, old_value, adv, target = batch
        # obs (M, N, L) -> cross forward (M, N_i, N_j, ...)
        heads_cross, values_cross = jax.vmap(
            lambda p: model.apply(p, obs), out_axes=1
        )(params)
        logp_cross, ent_map = cross_logp(heads_cross, action)

        # ratio of agent i's policy to the BEHAVIOUR policy that produced
        # the sample (agent j's old policy): the SEAC importance weight
        ratio = jnp.exp(logp_cross - behav_logp[:, None, :])
        adv_norm = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg1 = ratio * adv_norm
        pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_norm
        surr = -jnp.minimum(pg1, pg2)  # (M, N_i, N_j)

        weight = eye + cfg.seac_lambda * (1.0 - eye)
        pg_loss = (surr * weight).sum(-1).mean()

        v_clipped = old_value + jnp.clip(
            values_cross - old_value, -cfg.clip_eps, cfg.clip_eps
        )
        v_err = jnp.maximum(
            (values_cross - target) ** 2, (v_clipped - target) ** 2
        )
        v_loss = 0.5 * (v_err * weight).sum(-1).mean()

        # entropy of each agent's own policy (the i == j diagonal)
        entropy = jnp.diagonal(ent_map, axis1=1, axis2=2).mean()

        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        own_ratio = jnp.diagonal(ratio, axis1=1, axis2=2)
        return total, {
            "pg_loss": pg_loss,
            "v_loss": v_loss,
            "entropy": entropy,
            "approx_kl": ((own_ratio - 1) - jnp.log(own_ratio)).mean(),
        }

    def train_step(runner: SEACRunner) -> Tuple[SEACRunner, dict]:
        key, k_roll, k_perm = jax.random.split(runner.key, 3)
        params = runner.params
        roll_keys = jax.random.split(k_roll, cfg.rollout_len)
        (params, env_states, obs), traj = jax.lax.scan(
            collect,
            (runner.params, runner.env_states, runner.obs),
            roll_keys,
        )

        # old-policy cross evaluation for advantages/targets/old values
        _, values_cross = jax.vmap(
            lambda p: model.apply(p, traj.obs), out_axes=2
        )(params)  # (T, B, N_i, N_j)
        _, last_values_cross = jax.vmap(
            lambda p: model.apply(p, obs), out_axes=1
        )(params)  # (B, N_i, N_j)

        not_done = 1.0 - traj.done.astype(jnp.float32)  # (T, B)

        def gae_body(carry, xs):
            g, next_v = carry
            v, r, nd = xs
            delta = r[:, None, :] + cfg.gamma * next_v * nd[:, None, None] - v
            g = delta + cfg.gamma * cfg.gae_lambda * nd[:, None, None] * g
            return (g, v), g

        (_, _), adv_cross = jax.lax.scan(
            gae_body,
            (jnp.zeros_like(last_values_cross), last_values_cross),
            (values_cross, traj.reward, not_done),
            reverse=True,
        )  # (T, B, N_i, N_j)
        target_cross = adv_cross + values_cross

        d = cfg.rollout_len * cfg.n_envs

        def flat(x):
            return x.reshape((d,) + x.shape[2:])

        dataset = (
            flat(traj.obs),
            flat(traj.action),
            flat(traj.logp),
            flat(values_cross),
            flat(adv_cross),
            flat(target_cross),
        )

        mb = d // cfg.minibatches

        def sgd_step(params, opt_state, batch):
            (loss, metrics), grads = jax.value_and_grad(
                minibatch_loss, has_aux=True
            )(params, batch)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, metrics

        def epoch(carry, k):
            params, opt_state = carry
            off = jax.random.randint(k, (), 0, d)
            rolled = jax.tree.map(lambda x: jnp.roll(x, off, axis=0), dataset)

            def minibatch(carry, i):
                params, opt_state = carry
                batch = jax.tree.map(
                    lambda x: jax.lax.dynamic_slice_in_dim(
                        x, i * mb, mb, 0
                    ),
                    rolled,
                )
                params, opt_state, metrics = sgd_step(
                    params, opt_state, batch
                )
                return (params, opt_state), metrics

            return jax.lax.scan(
                minibatch, (params, opt_state), jnp.arange(cfg.minibatches)
            )

        (params, opt_state), metrics = jax.lax.scan(
            epoch,
            (params, runner.opt_state),
            jax.random.split(k_perm, cfg.epochs),
        )
        out_metrics = {
            "reward_per_env": traj.reward.sum() / cfg.n_envs,
            "episodes_done": traj.done.sum(),
            **jax.tree.map(lambda x: x.mean(), metrics),
        }
        return (
            SEACRunner(
                params=params,
                opt_state=opt_state,
                env_states=env_states,
                obs=obs,
                key=key,
                update_idx=runner.update_idx + 1,
            ),
            out_metrics,
        )

    return train_step


# ---------------------------------------------------------------------------
# Recurrent SEAC-PPO: per-agent GRU actors with shared experience.
#
# The SEAC paper (Christianos et al., NeurIPS 2020) is feedforward A2C;
# RWARE's strong baselines are recurrent, so this completes the algorithm x
# network matrix (IPPO/MAPPO both ship GRU variants).  The recurrent cross
# terms are well-defined from the stored rollout: evaluating pi_i on agent
# j's experience replays agent i's GRU over agent j's OBSERVATION SEQUENCE
# (episode-boundary carry resets included, exactly as in collection).  The
# (N_i, N_j) grid of replays is one lax.scan over time of a doubly-vmapped
# GRU cell — N^2 batched matmuls per step.
#
# Initial hidden for cross streams: the diagonal (own stream) uses the
# carry stored at rollout start, so the first epoch's own-ratio is exactly
# 1 (PPO clipping semantics); off-diagonal pairs start from zeros — agent
# i never observed stream j, and hidden states are not comparable across
# parameter sets.  Within the T=128 window, in-episode resets re-anchor
# the carry, and the importance weight w_ij (stop-gradient through the
# behaviour logp) already absorbs the residual policy mismatch.
# ---------------------------------------------------------------------------


@pytree.dataclass
class SEACGRURunner:
    params: Any  # stacked per-agent GRU params, leading axis N
    opt_state: Any
    env_states: Any  # (B, ...)
    obs: jax.Array  # (B, N, L)
    carry: jax.Array  # (B, N, H) each agent's own hidden
    key: jax.Array
    update_idx: jax.Array


def init_seac_gru(
    env: Warehouse,
    cfg: "SEACPPOConfig",
    key: jax.Array,
    model=None,
):
    """Stacked per-agent RecurrentActorCritic params + zero carries."""
    from rware_tpu.models.networks import RecurrentActorCritic

    if model is None:
        model = RecurrentActorCritic(
            n_actions=env.n_actions, msg_bits=env.config.msg_bits
        )
    n = env.n_agents
    obs_dim = env.config.policy_obs_length
    k_par, k_env, k_run = jax.random.split(key, 3)
    params = jax.vmap(
        lambda k: model.init(
            k, model.initialize_carry((1,)), jnp.zeros((1, obs_dim))
        )
    )(jax.random.split(k_par, n))
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(cfg.lr, eps=1e-5),
    )
    env_states = jax.vmap(env._reset_fn)(
        jax.random.split(k_env, cfg.n_envs)
    )
    from rware_tpu.models.ippo import policy_obs_fn

    obs = jax.vmap(policy_obs_fn(env))(env_states)
    runner = SEACGRURunner(
        params=params,
        opt_state=tx.init(params),
        env_states=env_states,
        obs=obs,
        carry=model.initialize_carry((cfg.n_envs, n)),
        key=k_run,
        update_idx=jnp.zeros((), jnp.int32),
    )
    return runner, model, tx


def _gru_cross_replay(model, params, obs, done, h0_diag,
                      values_only=False, remat=False):
    """Replay every agent's GRU over every agent's observation stream.

    params stacked (N_i, ...), obs (T, B, N_j, L), done (T, B),
    h0_diag (B, N_j, H) = each agent's OWN initial hidden (used on the
    diagonal; off-diagonal pairs start from zeros).

    Returns (heads, values, last_carry): heads (T, B, N_i, N_j, A)
    (+ msg head for msg configs; None when values_only), values
    (T, B, N_i, N_j) f32, last_carry (B, N_i, N_j, H).
    """
    n = obs.shape[2]
    eye_mask = jnp.eye(n, dtype=bool)[None, :, :, None]  # (1, Ni, Nj, 1)
    h0 = jnp.where(
        eye_mask, h0_diag[:, None, :, :], jnp.zeros_like(h0_diag[:, None])
    )  # (B, N_i, N_j, H)

    def cell(carry, xs):
        o_t, d_t = xs  # (B, N_j, L), (B,)
        new_carry, (heads, value) = jax.vmap(
            lambda p, c: model.apply(p, c, o_t), in_axes=(0, 1),
            out_axes=1,
        )(params, carry)
        new_carry = jnp.where(
            d_t[:, None, None, None], jnp.zeros_like(new_carry), new_carry
        )
        out = (None, value) if values_only else (heads, value)
        return new_carry, out

    if remat:
        # store only the per-step carries; recompute gate activations in
        # the backward sweep — residual memory falls from O(T N^2 mb 4H)
        # to O(T N^2 mb H), the difference between medium-6ag (N^2 = 36
        # streams) fitting HBM at B=4096 and OOMing (measured 19.1 GB)
        cell = jax.checkpoint(cell)
    last_carry, (heads, values) = jax.lax.scan(cell, h0, (obs, done))
    return heads, values, last_carry


def build_seac_gru_train_step(
    env: Warehouse,
    model,
    tx: optax.GradientTransformation,
    cfg: "SEACPPOConfig",
    remat: Optional[bool] = None,
) -> Callable[[SEACGRURunner], Tuple[SEACGRURunner, dict]]:
    """One jitted recurrent shared-experience PPO update: per-agent GRU
    collect (own streams) -> cross recurrent replay for old values ->
    cross GAE -> E x M ENV-BAND minibatch updates (recurrent replay
    cannot slice time), each replaying the (N_i, N_j) GRU grid through
    jax.value_and_grad.  Message bits ride the same joint (move, bits)
    machinery as the MLP variant.  ``remat`` (default: decided from the
    replay's residual size) recomputes the cell in the backward sweep."""
    step_fn = jax.vmap(env._step_fn)
    reset_fn = env._reset_fn
    from rware_tpu.models.ippo import policy_obs_fn
    from rware_tpu.models.networks import (
        bernoulli_logp,
        sample_action,
        sample_action_msg,
    )

    obs_fn = policy_obs_fn(env)
    n = env.n_agents
    eye = jnp.eye(n)
    msg_mode = getattr(model, "msg_bits", 0) > 0
    if cfg.n_envs % cfg.minibatches:
        raise ValueError(
            f"minibatches={cfg.minibatches} must divide "
            f"n_envs={cfg.n_envs} (env-band minibatches)"
        )
    if remat is None:
        # auto: the minibatch replay's autodiff residuals scale with
        # T x (envs/minibatches) x N^2 x 4H bf16 x ~4 tensors;
        # remat past ~2^31 elements (tiny-2ag at B=4096 fits without)
        resid = (
            4.0 * cfg.rollout_len * (cfg.n_envs // cfg.minibatches)
            * n * n * 4 * 128
        )
        remat = resid > 2**31

    def apply_own(params, carry, obs):
        # params (N,...) x carry (B, N, H) x obs (B, N, L)
        return jax.vmap(
            lambda p, c, o: model.apply(p, c, o), in_axes=(0, 1, 1),
            out_axes=1,
        )(params, carry, obs)

    def collect(carry_state, key):
        params, env_states, obs, carry = carry_state
        k_act, _ = jax.random.split(key)
        new_carry, (heads, _value) = apply_own(params, carry, obs)
        if msg_mode:
            action, logp = sample_action_msg(k_act, *heads)
        else:
            action, logp = sample_action(k_act, heads)
        res = step_fn(env_states, action)
        from rware_tpu.parallel.rollout import autoreset_select

        next_states = jax.vmap(
            lambda s, d: autoreset_select(reset_fn, s, d)
        )(res.state, res.done)
        next_obs = jax.vmap(obs_fn)(next_states)
        next_carry = jnp.where(
            res.done[:, None, None], jnp.zeros_like(new_carry), new_carry
        )
        return (params, next_states, next_obs, next_carry), SEACTransition(
            obs, action, logp, res.rewards, res.done
        )

    def cross_logp_ent(heads_cross, action):
        """Joint log pi_i(a_j|o_j) over the (T, M, N_i, N_j) grid."""
        if msg_mode:
            logits_cross, msg_cross = heads_cross
            move = action[..., 0]
            bits = action[..., 1:]
        else:
            logits_cross = heads_cross
            move = action
        lsm = jax.nn.log_softmax(logits_cross)
        logp = jnp.take_along_axis(
            lsm, move[..., None, :, None], axis=-1
        ).squeeze(-1)
        ent_map = -(jnp.exp(lsm) * lsm).sum(-1)
        if msg_mode:
            logp = logp + bernoulli_logp(
                msg_cross, bits[..., None, :, :]
            ).sum(-1)
            p_msg = jax.nn.sigmoid(msg_cross)
            ent_map = ent_map - (
                p_msg * jax.nn.log_sigmoid(msg_cross)
                + (1.0 - p_msg) * jax.nn.log_sigmoid(-msg_cross)
            ).sum(-1)
        return logp, ent_map

    def minibatch_loss(params, batch):
        (obs, done, action, behav_logp, old_value, adv, target,
         h0_diag) = batch
        heads_cross, values_cross, _ = _gru_cross_replay(
            model, params, obs, done, h0_diag, remat=remat
        )
        logp_cross, ent_map = cross_logp_ent(heads_cross, action)

        ratio = jnp.exp(logp_cross - behav_logp[:, :, None, :])
        adv_norm = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg1 = ratio * adv_norm
        pg2 = jnp.clip(
            ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps
        ) * adv_norm
        surr = -jnp.minimum(pg1, pg2)  # (T, M, N_i, N_j)

        weight = eye + cfg.seac_lambda * (1.0 - eye)
        pg_loss = (surr * weight).sum(-1).mean()

        v_clipped = old_value + jnp.clip(
            values_cross - old_value, -cfg.clip_eps, cfg.clip_eps
        )
        v_err = jnp.maximum(
            (values_cross - target) ** 2, (v_clipped - target) ** 2
        )
        v_loss = 0.5 * (v_err * weight).sum(-1).mean()

        entropy = jnp.diagonal(ent_map, axis1=2, axis2=3).mean()
        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        own_ratio = jnp.diagonal(ratio, axis1=2, axis2=3)
        return total, {
            "pg_loss": pg_loss,
            "v_loss": v_loss,
            "entropy": entropy,
            "approx_kl": ((own_ratio - 1) - jnp.log(own_ratio)).mean(),
        }

    def train_step(runner: SEACGRURunner) -> Tuple[SEACGRURunner, dict]:
        key, k_roll, k_perm = jax.random.split(runner.key, 3)
        params = runner.params
        h0_diag = runner.carry
        roll_keys = jax.random.split(k_roll, cfg.rollout_len)
        (params, env_states, obs, carry), traj = jax.lax.scan(
            collect,
            (params, runner.env_states, runner.obs, runner.carry),
            roll_keys,
        )

        # old-policy cross values (recurrent replay) + bootstrap
        _, values_cross, last_c = _gru_cross_replay(
            model, params, traj.obs, traj.done, h0_diag, values_only=True
        )  # (T, B, N_i, N_j)
        _, (_, last_values_cross) = jax.vmap(
            lambda p, c: model.apply(p, c, obs), in_axes=(0, 1),
            out_axes=1,
        )(params, last_c)  # (B, N_i, N_j)

        not_done = 1.0 - traj.done.astype(jnp.float32)  # (T, B)

        def gae_body(carry_g, xs):
            g, next_v = carry_g
            v, r, nd = xs
            delta = (
                r[:, None, :] + cfg.gamma * next_v * nd[:, None, None] - v
            )
            g = delta + cfg.gamma * cfg.gae_lambda * nd[:, None, None] * g
            return (g, v), g

        (_, _), adv_cross = jax.lax.scan(
            gae_body,
            (jnp.zeros_like(last_values_cross), last_values_cross),
            (values_cross, traj.reward, not_done),
            reverse=True,
        )
        target_cross = adv_cross + values_cross

        # env-axis dataset: T-major leaves sliced on axis 1, h0 on axis 0
        dataset = (
            traj.obs, traj.done, traj.action, traj.logp,
            values_cross, adv_cross, target_cross,
        )
        mb = cfg.n_envs // cfg.minibatches

        def sgd_step(params, opt_state, batch):
            (loss, metrics), grads = jax.value_and_grad(
                minibatch_loss, has_aux=True
            )(params, batch)
            updates, opt_state = tx.update(grads, opt_state, params)
            return (
                optax.apply_updates(params, updates), opt_state, metrics
            )

        def epoch(carry_e, k):
            params, opt_state = carry_e
            off = jax.random.randint(k, (), 0, cfg.n_envs)
            rolled = jax.tree.map(
                lambda x: jnp.roll(x, off, axis=1), dataset
            )
            rolled_h0 = jnp.roll(h0_diag, off, axis=0)

            def minibatch(carry_m, i):
                params, opt_state = carry_m
                band = tuple(
                    jax.lax.dynamic_slice_in_dim(x, i * mb, mb, 1)
                    for x in rolled
                ) + (
                    jax.lax.dynamic_slice_in_dim(
                        rolled_h0, i * mb, mb, 0
                    ),
                )
                params, opt_state, metrics = sgd_step(
                    params, opt_state, band
                )
                return (params, opt_state), metrics

            return jax.lax.scan(
                minibatch, (params, opt_state),
                jnp.arange(cfg.minibatches),
            )

        (params, opt_state), metrics = jax.lax.scan(
            epoch,
            (params, runner.opt_state),
            jax.random.split(k_perm, cfg.epochs),
        )
        out_metrics = {
            "reward_per_env": traj.reward.sum() / cfg.n_envs,
            "episodes_done": traj.done.sum(),
            **jax.tree.map(lambda x: x.mean(), metrics),
        }
        return (
            SEACGRURunner(
                params=params,
                opt_state=opt_state,
                env_states=env_states,
                obs=obs,
                carry=carry,
                key=key,
                update_idx=runner.update_idx + 1,
            ),
            out_metrics,
        )

    return train_step
