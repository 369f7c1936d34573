#!/usr/bin/env python
"""Train IPPO or SEAC on a warehouse config — the end-to-end driver.

Examples:
  python train.py --env rware-tiny-2ag-v2 --updates 100
  python train.py --algo mappo --net gru --n-envs 4096 --updates 400
  python train.py --algo seac --env rware-small-4ag-v2 --n-envs 512
  python train.py --resume --checkpoint-dir ckpts/run1
  python train.py --mesh --n-envs 16384   # data parallel over all GPUs

Multi-host: launch one process per host with jax.distributed coordinates in
the environment and pass --distributed; the env batch shards over all
devices.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="rware-tiny-2ag-v2")
    p.add_argument(
        "--algo", choices=["ippo", "mappo", "seac", "seac-ppo"],
        default="ippo",
        help="seac-ppo = shared-experience PPO (the SEAC variant validated "
        "to learn; see models/seac.py)",
    )
    p.add_argument(
        "--net", choices=["mlp", "gru"], default="mlp",
        help="policy network (gru = recurrent actor; ippo, mappo and "
        "seac-ppo)",
    )
    p.add_argument(
        "--minibatch-mode", choices=["shuffle", "block"], default="shuffle",
        help="IPPO minibatching: block = contiguous random-offset slices "
        "(time-band minibatches, no index gathers)",
    )
    p.add_argument(
        "--msg-bits", type=int, default=None,
        help="override the env's message-channel width (ids cannot express "
        "it); the policies then train a Bernoulli message head",
    )
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--n-envs", type=int, default=256)
    p.add_argument("--rollout-len", type=int, default=None)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--profile-dir", default=None, help="capture a jax trace here")
    p.add_argument("--platform", default=None, help="force the jax platform (e.g. cpu)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--mesh", action="store_true", help="shard envs over all devices")
    return p.parse_args(argv)


def build_learner(args, env, key, mesh=None):
    """(runner, jitted train_step, env-steps per update) for the chosen
    algorithm and network; with ``mesh``, data parallel over it."""
    from rware_tpu.models import IPPOConfig
    from rware_tpu.models.seac import SEACConfig, SEACPPOConfig

    common = dict(n_envs=args.n_envs, lr=args.lr, ent_coef=args.ent_coef)
    t_len = args.rollout_len or 128
    if args.algo == "ippo":
        cfg = IPPOConfig(
            rollout_len=t_len, minibatch_mode=args.minibatch_mode, **common
        )
        if args.net == "gru":
            from rware_tpu.models.ippo_rnn import (
                build_rnn_train_step as build,
                init_rnn_runner as init,
            )
        else:
            from rware_tpu.models.ippo import (
                build_train_step as build,
                init_runner as init,
            )
        runner, model, tx = init(env, cfg, key)
        step = build(env, model, tx, cfg)
    elif args.algo == "mappo":
        cfg = IPPOConfig(rollout_len=t_len, **common)
        if args.net == "gru":
            from rware_tpu.models.mappo import (
                build_rnn_mappo_train_step as build,
                init_rnn_mappo_runner as init,
            )
        else:
            from rware_tpu.models.mappo import (
                build_mappo_train_step as build,
                init_mappo_runner as init,
            )
        runner, actor, critic, tx = init(env, cfg, key)
        step = build(env, actor, critic, tx, cfg)
    elif args.algo == "seac-ppo":
        cfg = SEACPPOConfig(rollout_len=t_len, **common)
        if args.net == "gru":
            from rware_tpu.models.seac import (
                build_seac_gru_train_step as build,
                init_seac_gru as init,
            )
        else:
            from rware_tpu.models.seac import (
                build_seac_ppo_train_step as build,
                init_seac_ppo as init,
            )
        runner, model, tx = init(env, cfg, key)
        step = build(env, model, tx, cfg)
    else:
        from rware_tpu.models.seac import build_seac_train_step, init_seac

        cfg = SEACConfig(rollout_len=args.rollout_len or 5, **common)
        runner, model, tx = init_seac(env, cfg, key)
        step = build_seac_train_step(env, model, tx, cfg)
    if mesh is None:
        step = jax.jit(step, donate_argnums=0)
    else:
        from jax.sharding import NamedSharding, PartitionSpec

        runner = shard_runner(runner, mesh)
        # outputs keep the inputs' shardings, so every later call reuses
        # the first call's program instead of compiling another
        step = jax.jit(
            step,
            donate_argnums=0,
            out_shardings=(
                jax.tree.map(lambda x: x.sharding, runner),
                NamedSharding(mesh, PartitionSpec()),
            ),
        )
    return runner, step, cfg.n_envs * cfg.rollout_len


def shard_runner(runner, mesh):
    """Data parallel: the env batch (env states, observations, any GRU
    carry) split over the mesh, everything else replicated.  XLA
    partitions the jitted step from these shardings and all-reduces the
    gradients."""
    from rware_tpu.parallel import replicate, shard_env_batch

    return runner.replace(**{
        f.name: (
            shard_env_batch if f.name in ("env_states", "obs", "carry")
            else replicate
        )(getattr(runner, f.name), mesh)
        for f in dataclasses.fields(runner)
    })


def main(argv=None):
    """Train; returns the final runner and the logged metric history."""
    args = parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.distributed:
        from rware_tpu.distributed import initialize

        pid, nproc = initialize()
        print(f"distributed: process {pid}/{nproc}", flush=True)

    from rware_tpu.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    import rware_tpu
    from rware_tpu.metrics import MetricLogger
    from rware_tpu.parallel import make_mesh

    env = (
        rware_tpu.make(args.env, msg_bits=args.msg_bits)
        if args.msg_bits is not None
        else rware_tpu.make(args.env)
    )
    print(
        f"env={args.env} grid={env.grid_size} agents={env.n_agents} "
        f"devices={len(jax.devices())}",
        flush=True,
    )

    mesh = make_mesh() if args.mesh and len(jax.devices()) > 1 else None
    runner, train_step, env_steps_per_update = build_learner(
        args, env, jax.random.key(args.seed), mesh
    )
    if mesh is not None:
        print(f"sharded {args.n_envs} envs over {mesh.devices.size} devices")

    ckpt = None
    start = 0
    if args.checkpoint_dir:
        from rware_tpu.checkpoint import Checkpointer

        ckpt = Checkpointer(args.checkpoint_dir)
        if args.resume and ckpt.latest_step is not None:
            runner = ckpt.restore(template=runner)
            start = int(runner.update_idx)
            print(f"resumed from update {start}", flush=True)

    logger = MetricLogger(print_every=args.log_every)
    from rware_tpu.profiling import StepTimer, TraceWindow, aggregate_across_hosts

    timer = StepTimer(skip_first=1)
    # automatic trace artifact: a 3-step window after compile/warmup
    tracer = TraceWindow(args.profile_dir, start=start + 3) if args.profile_dir else None

    def run_updates():
        nonlocal runner
        # fetching metrics forces a device->host sync — sync only at log
        # boundaries and let the updates queue on the device between them
        log_int = max(1, args.log_every)
        timer.tick()
        last_sync = start
        for u in range(start, args.updates):
            if tracer:
                tracer.step(u)
            runner, metrics = train_step(runner)
            at_boundary = (u + 1) % log_int == 0 or u + 1 == args.updates
            if ckpt and (u + 1) % args.checkpoint_every == 0:
                ckpt.save(u + 1, runner)
                at_boundary = True  # save materialised the runner
            if not at_boundary:
                continue
            if args.distributed:
                metrics = aggregate_across_hosts(
                    {k: float(v) for k, v in metrics.items()}
                )
            n = u + 1 - last_sync
            logger.log(u + 1, metrics, env_steps=env_steps_per_update * n)
            timer.tick(n_steps=n)
            last_sync = u + 1
        if tracer:
            tracer.close()

    run_updates()
    step_stats = timer.summary()
    if step_stats:
        print(
            f"timing: {step_stats['step_ms_p50']:.1f}ms p50 / "
            f"{step_stats['step_ms_p95']:.1f}ms p95 per update "
            f"({step_stats['steps_per_s'] * env_steps_per_update / 1e6:.2f}M "
            "env-steps/s)",
            flush=True,
        )

    if ckpt:
        ckpt.save(args.updates, runner, wait=True)
        ckpt.close()
    summary = logger.summary()
    print(
        "done:",
        {k: round(v, 4) for k, v in summary.items() if "loss" in k or "reward" in k or "env_steps" in k},
        flush=True,
    )
    return runner, logger.history


if __name__ == "__main__":
    main()
