#!/usr/bin/env python
"""Throughput benchmark: batched env-steps/s of the XLA engine on one GPU.

Protocol: B parallel envs stepped in lockstep with uniform-random actions
and autoreset, T steps per rollout program (one jit: vmap over the envs,
lax.scan over time).  The program is compiled ahead of time (its compile
seconds are set-up, reported apart), run once to warm up, then timed
``--repeats`` times; every timed call ends in ``block_until_ready`` and
feeds its final state to the next.

Prints one JSON line: the median rate, every timed rollout, the compile
seconds and the program's memory, the device as JAX reports it and the
card's name and power limit as nvidia-smi reports them.  ``vs_baseline``
is the speedup over the reference implementation's single-process CPU
throughput on the same config (BASELINE.md).  Without a GPU it exits
non-zero and prints no rate.

  python bench.py --env rware-tiny-2ag-v2 --batch 65536 --steps 256
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

# Reference single-process CPU throughput per config (BASELINE.md);
# vs_baseline uses the matching config or null.
REF_STEPS_PER_SEC = {
    "rware-tiny-2ag-v2": 2330.0,
    "rware-small-4ag-v2": 1680.0,
    "rware-medium-6ag-v2": 1090.0,
    "rware-large-8ag-v2": 780.0,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="rware-tiny-2ag-v2")
    p.add_argument("--batch", type=int, default=65536)
    p.add_argument("--steps", type=int, default=256, help="scan length per call")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument(
        "--unroll", type=int, default=4, help="lax.scan unroll factor"
    )
    return p.parse_args(argv)


def build_rollout(env, n_envs: int, n_steps: int, unroll: int):
    """jit of ``rollout(states, key) -> (final_states, reward_sum)``: random
    actions with autoreset, the env states donated."""
    from rware_tpu.parallel import autoreset_select

    step_fn, reset_fn = env._step_fn, env._reset_fn

    def one_env(state, key):
        def body(carry, k):
            state, rew = carry
            res = step_fn(state, env.sample_actions(k))
            state = autoreset_select(reset_fn, res.state, res.done)
            return (state, rew + res.rewards.sum()), None

        (state, rew), _ = jax.lax.scan(
            body, (state, jnp.float32(0)), jax.random.split(key, n_steps),
            unroll=unroll,
        )
        return state, rew

    def rollout(states, key):
        final, rew = jax.vmap(one_env)(states, jax.random.split(key, n_envs))
        return final, rew.sum()

    return jax.jit(rollout, donate_argnums=0)


def main(argv=None):
    """Run the benchmark; prints and returns the result record."""
    args = parse_args(argv)
    from rware_tpu.profiling import card_info, device_record, require_gpu

    require_gpu("bench.py")
    import rware_tpu
    from rware_tpu.compile_cache import enable_persistent_cache
    from rware_tpu.parallel import batched_reset

    enable_persistent_cache()
    env = rware_tpu.make(args.env)
    B, T = args.batch, args.steps
    states, _ = batched_reset(env, jax.random.key(0), B)
    rollout = build_rollout(env, B, T, args.unroll)

    t0 = time.perf_counter()
    compiled = rollout.lower(states, jax.random.key(1)).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()

    states, acc = compiled(states, jax.random.key(1))  # warm-up
    jax.block_until_ready((states, acc))
    times = []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        states, acc = compiled(states, jax.random.key(2 + i))
        jax.block_until_ready((states, acc))
        times.append(time.perf_counter() - t0)
    rate = B * T / statistics.median(times)
    ref = REF_STEPS_PER_SEC.get(args.env)
    result = {
        "metric": f"env-steps/s ({args.env}, B={B}, T={T}, xla)",
        "value": rate,
        "unit": "env-steps/s",
        "vs_baseline": rate / ref if ref else None,
        "rollout_s": times,
        "compile_s": compile_s,
        "memory_bytes": None if mem is None else {
            "argument": mem.argument_size_in_bytes,
            "output": mem.output_size_in_bytes,
            "temp": mem.temp_size_in_bytes,
            "alias": mem.alias_size_in_bytes,
        },
        "device": device_record(),
        "card": card_info(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
