#!/usr/bin/env python
"""Evaluate a trained policy checkpoint: batched on-device episodes.

Examples:
  python evaluate.py --checkpoint-dir ckpts/run1 --episodes 256
  python evaluate.py --env rware-tiny-2ag-v2 --random   # random baseline
  python evaluate.py --checkpoint-dir ckpts/run1 --render-frames out/  # pngs
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="rware-tiny-2ag-v2")
    p.add_argument(
        "--msg-bits", type=int, default=None,
        help="override the env's message-channel width (ids cannot "
        "express it); must match the checkpointed policy's message head",
    )
    p.add_argument(
        "--algo", choices=["auto", "ippo", "seac", "mappo"], default="auto",
        help="policy type in the checkpoint; 'auto' infers it from the "
        "checkpoint structure (an 'actor' key means MAPPO, a leading "
        "agent axis on every leaf means SEAC) — pass it explicitly for "
        "ambiguous trees, e.g. a 2-agent SEAC stack whose leaves happen "
        "to have leading dim 2",
    )
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--episodes", type=int, default=128)
    p.add_argument("--max-steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--random", action="store_true", help="random policy baseline")
    p.add_argument("--greedy", action="store_true", help="argmax actions")
    p.add_argument("--render-frames", default=None, help="dir for PNG frames of env 0")
    p.add_argument("--platform", default=None)
    return p.parse_args()


def main():
    args = parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    # persistent XLA executable cache: the 500-step recurrent eval scan
    # is a long compile; with the cache later invocations deserialize it
    from rware_tpu.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    import rware_tpu
    from rware_tpu.models import ActorCritic, sample_action

    env = (
        rware_tpu.make(args.env, msg_bits=args.msg_bits)
        if args.msg_bits is not None
        else rware_tpu.make(args.env)
    )
    B = args.episodes
    n = env.n_agents

    params = None
    per_agent_params = False
    if not args.random:
        if not args.checkpoint_dir:
            raise SystemExit("--checkpoint-dir required unless --random")
        from rware_tpu.checkpoint import Checkpointer

        ckpt = Checkpointer(args.checkpoint_dir)
        tree = ckpt.restore()
        params = tree["params"]
        if args.algo == "mappo" and "actor" not in params:
            raise SystemExit(
                "--algo mappo but the checkpoint has no 'actor' key"
            )
        if args.algo in ("auto", "mappo") and "actor" in params:
            # MAPPO checkpoint: decentralized execution — evaluation uses
            # the actor only (the central critic is a training-time object)
            params = params["actor"]
        leaves = jax.tree.leaves(params)
        if args.algo == "auto":
            # SEAC stores per-agent stacks (leading agent axis on every
            # leaf); sniffing is ambiguous by construction when a leaf's
            # leading dim happens to equal n — --algo seac/ippo overrides
            per_agent_params = (
                all(l.shape[0] == n for l in leaves) and n > 1
            )
        else:
            per_agent_params = args.algo == "seac"
            if per_agent_params and not all(l.shape[0] == n for l in leaves):
                raise SystemExit(
                    "--algo seac but the checkpoint leaves have no "
                    f"leading {n}-agent axis"
                )
        recurrent = "gru" in params.get("params", {})
        ckpt.close()
    else:
        recurrent = False
    if recurrent:
        from rware_tpu.models import RecurrentActorCritic

        model = RecurrentActorCritic(
            n_actions=env.n_actions, msg_bits=env.config.msg_bits
        )
    else:
        model = ActorCritic(
            n_actions=env.n_actions, msg_bits=env.config.msg_bits
        )
    msg_mode = env.config.msg_bits > 0

    def policy(key, obs, params, carry):
        """Returns (action, new_carry); carry is None for feedforward."""
        if args.random:
            return env_random_actions(key), carry
        if recurrent and per_agent_params:
            # recurrent SEAC: stacked per-agent GRUs, each on its own
            # obs stream with its own hidden slice
            carry, (logits, _) = jax.vmap(
                lambda p, c, o: model.apply(p, c, o),
                in_axes=(0, 1, 1), out_axes=1,
            )(params, carry, obs)
        elif recurrent:
            carry, (logits, _) = model.apply(params, carry, obs)
        elif per_agent_params:
            logits, _ = jax.vmap(
                lambda p, o: model.apply(p, o), in_axes=(0, 1), out_axes=1
            )(params, obs)
        else:
            logits, _ = model.apply(params, obs)
        if msg_mode:
            from rware_tpu.models.networks import sample_action_msg

            move_logits, msg_logits = logits
            if args.greedy:
                action = jnp.concatenate(
                    [
                        jnp.argmax(move_logits, -1)[..., None],
                        (msg_logits > 0).astype(jnp.int32),
                    ],
                    axis=-1,
                ).astype(jnp.int32)
                return action, carry
            action, _ = sample_action_msg(key, move_logits, msg_logits)
            return action, carry
        if args.greedy:
            return jnp.argmax(logits, axis=-1).astype(jnp.int32), carry
        action, _ = sample_action(key, logits)
        return action, carry

    def env_random_actions(key):
        return jax.vmap(env.sample_actions)(jax.random.split(key, B))

    # the policies consume the flattened policy view for every obs family
    # (FLATTENED passthrough, IMAGE/IMAGE_DICT window flatten, DICT
    # flatten) — the same view training uses (models/ippo.policy_obs_fn)
    from rware_tpu.models.ippo import policy_obs_fn

    policy_view = policy_obs_fn(env)
    keys = jax.random.split(jax.random.key(args.seed), B)
    states = jax.vmap(env._reset_fn)(keys)
    obs = jax.vmap(policy_view)(states)

    carry0 = (
        model.initialize_carry((B, n)) if recurrent else jnp.zeros((B,))
    )

    @jax.jit
    def run(states, obs, params, key):
        def body(carry_t, k):
            states, obs, rnn_carry, returns, lengths, alive = carry_t
            actions, rnn_carry = policy(k, obs, params, rnn_carry)
            res = jax.vmap(env._step_fn)(states, actions)
            returns = returns + res.rewards.sum(-1) * alive
            lengths = lengths + alive
            alive = alive * (1.0 - res.done.astype(jnp.float32))
            next_obs = jax.vmap(policy_view)(res.state)
            if recurrent:
                rnn_carry = jnp.where(
                    res.done[:, None, None],
                    jnp.zeros_like(rnn_carry),
                    rnn_carry,
                )
            return (
                res.state, next_obs, rnn_carry, returns, lengths, alive,
            ), res.done

        init = (
            states,
            obs,
            carry0,
            jnp.zeros(B),
            jnp.zeros(B),
            jnp.ones(B),
        )
        (states, obs, _, returns, lengths, alive), dones = jax.lax.scan(
            body, init, jax.random.split(key, args.max_steps)
        )
        return returns, lengths, alive

    returns, lengths, alive = run(states, obs, params, jax.random.key(args.seed + 1))
    returns = np.asarray(returns)
    lengths = np.asarray(lengths)
    print(
        f"episodes={B} mean_return={returns.mean():.3f} "
        f"std={returns.std():.3f} mean_length={lengths.mean():.1f} "
        f"unfinished={int(np.asarray(alive).sum())}"
    )

    if args.render_frames:
        from rware_tpu.rendering import Viewer

        os.makedirs(args.render_frames, exist_ok=True)
        viewer = Viewer(env.config)
        state = jax.tree.map(lambda x: x[0], states)
        key = jax.random.key(args.seed + 2)
        single_obs = policy_view(state)
        rcarry = (
            model.initialize_carry((1, n)) if recurrent else jnp.zeros((1,))
        )
        for t in range(60):
            frame = viewer.frame(state)
            try:
                from PIL import Image

                Image.fromarray(frame).save(
                    os.path.join(args.render_frames, f"frame_{t:03d}.png")
                )
            except ImportError:
                np.save(
                    os.path.join(args.render_frames, f"frame_{t:03d}.npy"), frame
                )
            key, k = jax.random.split(key)
            actions, rcarry = policy(k, single_obs[None], params, rcarry)
            res = env.step(state, actions[0])
            state = res.state
            single_obs = policy_view(state)
        print(f"wrote 60 frames to {args.render_frames}")


if __name__ == "__main__":
    main()
