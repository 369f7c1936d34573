"""Recurrent IPPO: GRU policies over partial observations.

RWARE is partially observable (3x3 sensor windows), so the standard strong
baselines use recurrent policies.  Same fused design as the MLP learner
(models/ippo.py): rollout + GAE + update in one jitted program.  The GRU
carry lives in the runner next to the env states; episode boundaries reset
it on device.  PPO epochs shuffle ENV indices (sequences stay intact) and
re-run the GRU over the stored trajectory from the stored initial carry —
sequence-parallel over the minibatch, time-sequential in a lax.scan
(hidden-state matmuls batch over B*N).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from rware_tpu import pytree
from rware_tpu.core.env import Warehouse
from rware_tpu.models.ippo import IPPOConfig, make_optimizer
from rware_tpu.models.networks import RecurrentActorCritic, sample_action


@pytree.dataclass
class RNNRunnerState:
    params: Any
    opt_state: Any
    env_states: Any  # (B, ...)
    obs: jax.Array  # (B, N, L)
    carry: jax.Array  # (B, N, H) GRU hidden
    key: jax.Array
    update_idx: jax.Array


class RNNTransition(NamedTuple):
    obs: jax.Array  # (B, N, L)
    carry_in: jax.Array  # (B, N, H) hidden BEFORE this step
    action: jax.Array
    logp: jax.Array
    value: jax.Array
    reward: jax.Array
    done: jax.Array  # (B,)


def init_rnn_runner(
    env: Warehouse,
    cfg: IPPOConfig,
    key: jax.Array,
    model: Optional[RecurrentActorCritic] = None,
) -> Tuple[RNNRunnerState, RecurrentActorCritic, optax.GradientTransformation]:
    if model is None:
        model = RecurrentActorCritic(
            n_actions=env.n_actions, msg_bits=env.config.msg_bits
        )
    k_param, k_env, k_run = jax.random.split(key, 3)
    obs_dim = env.config.policy_obs_length
    carry0 = model.initialize_carry((1, env.n_agents))
    params = model.init(
        k_param, carry0, jnp.zeros((1, env.n_agents, obs_dim))
    )
    tx = make_optimizer(cfg)
    env_states = jax.vmap(env._reset_fn)(jax.random.split(k_env, cfg.n_envs))
    from rware_tpu.models.ippo import policy_obs_fn

    obs = jax.vmap(policy_obs_fn(env))(env_states)
    runner = RNNRunnerState(
        params=params,
        opt_state=tx.init(params),
        env_states=env_states,
        obs=obs,
        carry=model.initialize_carry((cfg.n_envs, env.n_agents)),
        key=k_run,
        update_idx=jnp.zeros((), jnp.int32),
    )
    return runner, model, tx


def build_rnn_train_step(
    env: Warehouse,
    model: RecurrentActorCritic,
    tx: optax.GradientTransformation,
    cfg: IPPOConfig,
) -> Callable[[RNNRunnerState], Tuple[RNNRunnerState, dict]]:
    step_fn = jax.vmap(env._step_fn)
    reset_fn = env._reset_fn
    from rware_tpu.models.ippo import policy_obs_fn

    obs_fn = policy_obs_fn(env)
    msg_mode = getattr(model, "msg_bits", 0) > 0

    def collect(carry_state, key):
        params, env_states, obs, carry = carry_state
        k_act, _ = jax.random.split(key)
        new_carry, (heads, value) = model.apply(params, carry, obs)
        if msg_mode:
            from rware_tpu.models.networks import sample_action_msg

            action, logp = sample_action_msg(k_act, *heads)
        else:
            action, logp = sample_action(k_act, heads)
        res = step_fn(env_states, action)
        from rware_tpu.parallel.rollout import autoreset_select

        next_states = jax.vmap(
            lambda s, d: autoreset_select(reset_fn, s, d)
        )(res.state, res.done)
        next_obs = jax.vmap(obs_fn)(next_states)
        # reset hidden at episode boundaries
        next_carry = jnp.where(
            res.done[:, None, None], jnp.zeros_like(new_carry), new_carry
        )
        t = RNNTransition(obs, carry, action, logp, value, res.rewards, res.done)
        return (params, next_states, next_obs, next_carry), t

    def gae(traj: RNNTransition, last_value):
        def body(carry, t):
            g, next_v = carry
            nd = 1.0 - t.done.astype(jnp.float32)[:, None]
            delta = t.reward + cfg.gamma * next_v * nd - t.value
            g = delta + cfg.gamma * cfg.gae_lambda * nd * g
            return (g, t.value), g

        (_, _), adv = jax.lax.scan(
            body, (jnp.zeros_like(last_value), last_value), traj, reverse=True
        )
        return adv, adv + traj.value

    def loss_fn(params, batch):
        # batch: trajectory slices for a minibatch of envs, (T, M, N, ...)
        traj, adv, target = batch
        init_carry = traj.carry_in[0]  # (M, N, H) hidden at rollout start

        def replay(carry, xs):
            obs, done = xs
            new_carry, (heads, value) = model.apply(params, carry, obs)
            new_carry = jnp.where(
                done[:, None, None], jnp.zeros_like(new_carry), new_carry
            )
            return new_carry, (heads, value)

        _, (heads, value) = jax.lax.scan(
            replay, init_carry, (traj.obs, traj.done)
        )
        if msg_mode:
            from rware_tpu.models.networks import bernoulli_logp

            logits, msg_logits = heads
            move, bits = traj.action[..., 0], traj.action[..., 1:]
            logp_all = jax.nn.log_softmax(logits)
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
            logp = jnp.take_along_axis(
                logp_all, traj.action[..., None], -1
            ).squeeze(-1)
            msg_entropy = 0.0
        ratio = jnp.exp(logp - traj.logp)
        adv_norm = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg1 = ratio * adv_norm
        pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_norm
        pg_loss = -jnp.minimum(pg1, pg2).mean()
        v_clipped = traj.value + jnp.clip(
            value - traj.value, -cfg.clip_eps, cfg.clip_eps
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

    def train_step(runner: RNNRunnerState) -> Tuple[RNNRunnerState, dict]:
        key, k_roll, k_perm = jax.random.split(runner.key, 3)
        roll_keys = jax.random.split(k_roll, cfg.rollout_len)
        (params, env_states, obs, carry), traj = jax.lax.scan(
            collect,
            (runner.params, runner.env_states, runner.obs, runner.carry),
            roll_keys,
        )
        _, (_, last_value) = model.apply(params, carry, obs)
        advantages, targets = gae(traj, last_value)

        mb_envs = cfg.n_envs // cfg.minibatches

        def epoch(carry_es, key):
            params, opt_state = carry_es
            perm = jax.random.permutation(key, cfg.n_envs)

            def minibatch(carry_es, idx):
                params, opt_state = carry_es
                batch = jax.tree.map(
                    lambda x: jnp.take(x, idx, axis=1),
                    (traj, advantages, targets),
                )
                (loss, metrics), grads = jax.value_and_grad(
                    loss_fn, has_aux=True
                )(params, batch)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), metrics

            idxs = perm[: mb_envs * cfg.minibatches].reshape(
                cfg.minibatches, mb_envs
            )
            return jax.lax.scan(minibatch, (params, opt_state), idxs)

        (params, opt_state), metrics = jax.lax.scan(
            epoch,
            (runner.params, runner.opt_state),
            jax.random.split(k_perm, cfg.epochs),
        )
        out_metrics = {
            "reward_per_env": traj.reward.sum() / cfg.n_envs,
            "episodes_done": traj.done.sum(),
            **jax.tree.map(lambda x: x.mean(), metrics),
        }
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
            out_metrics,
        )

    return train_step


def _gru_cell_fwd(hg, wh, bhn, h, ir_t, iz_t, inn_t, m_t):
    """One GRU step on (N, RB, LANE, Hg) blocks; m_t (1, RB, LANE) is the
    episode-boundary mask AFTER this step.  Returns (carry, new_h)."""
    one = jnp.bfloat16(1.0)
    hh = jax.lax.dot_general(
        h, wh, (((3,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (N, RB, LANE, 3Hg)
    r = jax.nn.sigmoid(ir_t + hh[..., :hg]).astype(jnp.bfloat16)
    z = jax.nn.sigmoid(iz_t + hh[..., hg:2 * hg]).astype(jnp.bfloat16)
    n = jnp.tanh(
        inn_t.astype(jnp.bfloat16)
        + r * (hh[..., 2 * hg:] + bhn).astype(jnp.bfloat16)
    )
    new_h = (one - z) * n + z * h
    carry = jnp.where((m_t != 0)[..., None], jnp.bfloat16(0.0), new_h)
    return carry, new_h


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _gru_scan(hg, wh, bhn, ir, iz, inn, done_mask, h0):
    """Time recurrence of the native GRU replay with a HAND-DERIVED
    backward.

    XLA's scan transpose carries the (Hg, 3Hg) weight-gradient
    accumulation and every gate residual through the reverse loop.  Here
    the reverse scan carries ONLY the (N, RB, LANE, Hg) hidden adjoint and
    emits per-step gate cotangents; every weight/input gradient is then
    one big dot over all (T x sample) rows outside the loop, and all
    residuals are recomputed from the function's own inputs/outputs (no
    extra forward storage).

    wh (Hg, 3Hg) bf16 = [W_hr | W_hz | W_hn], bhn (Hg,) f32, gates
    ir/iz/inn (T, N, RB, LANE, Hg) f32, done_mask (T, 1, RB, LANE) bf16,
    h0 (N, RB, LANE, Hg) bf16.  Returns hseq (T, N, RB, LANE, Hg) bf16 —
    the per-step hidden BEFORE the boundary reset.
    """

    def cell(h, xs):
        ir_t, iz_t, inn_t, m_t = xs
        return _gru_cell_fwd(hg, wh, bhn, h, ir_t, iz_t, inn_t, m_t)

    _, hseq = jax.lax.scan(
        cell, h0, (ir, iz, inn, done_mask), unroll=8
    )
    return hseq


def _gru_scan_fwd(hg, wh, bhn, ir, iz, inn, done_mask, h0):
    hseq = _gru_scan(hg, wh, bhn, ir, iz, inn, done_mask, h0)
    return hseq, (wh, bhn, ir, iz, inn, done_mask, h0, hseq)


def _gru_scan_bwd(hg, res, dhseq):
    wh, bhn, ir, iz, inn, done_mask, h0, hseq = res
    # hidden INPUT at step t: h0 at t=0, else the reset-masked previous
    # output — recomputed from saved outputs, not stored by the forward
    h_prev = jnp.concatenate(
        [
            h0[None],
            jnp.where(
                (done_mask[:-1] != 0)[..., None], jnp.bfloat16(0.0),
                hseq[:-1],
            ),
        ],
        axis=0,
    )  # (T, N, RB, LANE, Hg) bf16
    whT = jnp.swapaxes(wh, 0, 1)  # (3Hg, Hg) bf16

    def cell_bwd(dc, xs):
        ir_t, iz_t, inn_t, m_t, hp_t, dh_out_t = xs
        # recompute this step's gates (matches _gru_cell_fwd bit-for-bit)
        hh = jax.lax.dot_general(
            hp_t, wh, (((3,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        r = jax.nn.sigmoid(ir_t + hh[..., :hg])
        z = jax.nn.sigmoid(iz_t + hh[..., hg:2 * hg])
        hhn = (hh[..., 2 * hg:] + bhn).astype(jnp.bfloat16)
        n = jnp.tanh(
            inn_t.astype(jnp.bfloat16) + r.astype(jnp.bfloat16) * hhn
        ).astype(jnp.float32)
        # adjoint of new_h: the head cotangent plus the carry chain
        # (carry_t = where(done_t, 0, new_h_t) feeds step t+1)
        dnh = dh_out_t + jnp.where((m_t != 0)[..., None], 0.0, dc)
        hpf = hp_t.astype(jnp.float32)
        dz_pre = dnh * (hpf - n) * z * (1.0 - z)
        dn_pre = dnh * (1.0 - z) * (1.0 - n * n)
        dhhn = dn_pre * r
        dr_pre = dn_pre * hhn.astype(jnp.float32) * r * (1.0 - r)
        # first 3Hg in wh's gate order so the dh matmul and the outside
        # dWh dot slice contiguously; dn_pre rides as the 4th block
        dgates = jnp.concatenate(
            [dr_pre, dz_pre, dhhn, dn_pre], axis=-1
        ).astype(jnp.bfloat16)
        dh_prev = dnh * z + jax.lax.dot_general(
            dgates[..., : 3 * hg], whT, (((3,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return dh_prev, dgates

    dh0, dgates_seq = jax.lax.scan(
        cell_bwd,
        jnp.zeros_like(h0, jnp.float32),
        (ir, iz, inn, done_mask, h_prev, dhseq.astype(jnp.float32)),
        reverse=True,
        unroll=8,
    )  # dgates_seq (T, N, RB, LANE, 4Hg) bf16
    # weight gradient: ONE dot over every (t, sample) row
    rows = h_prev.reshape(-1, hg)
    dg3 = dgates_seq[..., : 3 * hg].reshape(-1, 3 * hg)
    dwh = jax.lax.dot_general(
        rows, dg3, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).astype(wh.dtype)  # (Hg, 3Hg)
    dbhn = (
        dgates_seq[..., 2 * hg: 3 * hg]
        .astype(jnp.float32)
        .sum(axis=tuple(range(dgates_seq.ndim - 1)))
    )
    d_ir = dgates_seq[..., :hg].astype(ir.dtype)
    d_iz = dgates_seq[..., hg: 2 * hg].astype(iz.dtype)
    d_inn = dgates_seq[..., 3 * hg:].astype(inn.dtype)
    return (
        dwh, dbhn.astype(bhn.dtype), d_ir, d_iz, d_inn,
        jnp.zeros_like(done_mask), dh0.astype(h0.dtype),
    )


_gru_scan.defvjp(_gru_scan_fwd, _gru_scan_bwd)


def _gru_native_replay(model: RecurrentActorCritic, params, obs, done, h0):
    """Replay the GRU over a native-layout trajectory.

    Batched-gate formulation: the embed and input-gate dots run once over
    every (t, agent, env) sample, and only the hidden recurrence is a scan
    (_gru_scan, with its hand-derived backward).

    obs (T, N, RB, LANE, L) bf16 — the REPLAY layout, features minor
    (transposed from the collected (T, L, N, RB, LANE) once per update),
    done (T, 1, RB, LANE) int32, h0 (N, RB, LANE, Hg).  Returns
    (logits (T, N, RB, LANE, A), value (T, N, RB, LANE)) — the per-step
    GRU outputs BEFORE the episode-boundary reset, matching
    build_rnn_train_step's replay ordering.
    """
    p = params["params"]
    g = p["gru"]

    # ONE fused input-gate contraction [ir | iz | in]
    wi = jnp.concatenate(
        [g["ir"]["kernel"], g["iz"]["kernel"], g["in"]["kernel"]], axis=1
    )
    bi = jnp.concatenate(
        [g["ir"]["bias"], g["iz"]["bias"], g["in"]["bias"]], axis=0
    )
    hg = int(model.hidden)
    # one fused (Hg, 3Hg) hidden contraction per step instead of three:
    # the T-sequential recurrence is bound by per-step latency, not FLOPs
    wh = jnp.concatenate(
        [
            g["hr"]["kernel"].astype(jnp.bfloat16),
            g["hz"]["kernel"].astype(jnp.bfloat16),
            g["hn"]["kernel"].astype(jnp.bfloat16),
        ],
        axis=1,
    )  # (Hg, 3Hg)
    bhn = g["hn"]["bias"]
    done_mask = (done != 0).astype(jnp.bfloat16)

    e = jax.lax.dot_general(
        obs.astype(jnp.bfloat16),
        p["embed"]["kernel"].astype(jnp.bfloat16),
        (((obs.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (T, N, RB, LANE, E)
    e = jnp.tanh((e + p["embed"]["bias"]).astype(jnp.bfloat16))
    iall = jax.lax.dot_general(
        e, wi.astype(jnp.bfloat16),
        (((e.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) + bi
    hseq = _gru_scan(
        hg, wh, bhn,
        iall[..., :hg], iall[..., hg:2 * hg], iall[..., 2 * hg:],
        done_mask, h0.astype(jnp.bfloat16),
    )  # (T, N, RB, LANE, Hg)
    # head dots straight on the bf16 hidden (f32 accumulation): no
    # hseq-sized f32 copy per pass; the bf16 weight rounding costs ~3
    # decimal digits on logits, inside the bf16 noise the rest of the
    # pipeline already carries
    heads_w = [p["policy"]["kernel"], p["value"]["kernel"]]
    if "message" in p:
        heads_w.append(p["message"]["kernel"])
    whead = jnp.concatenate(heads_w, axis=1).astype(jnp.bfloat16)
    heads = jax.lax.dot_general(
        hseq, whead, (((hseq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    a = p["policy"]["kernel"].shape[1]
    logits = heads[..., :a] + p["policy"]["bias"]
    value = heads[..., a] + p["value"]["bias"][0]
    if "message" in p:
        msg_logits = heads[..., a + 1:] + p["message"]["bias"]
        return (logits, msg_logits), value
    return logits, value
