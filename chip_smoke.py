#!/usr/bin/env python
"""Smoke test of the whole system on the GPU.

  python chip_smoke.py          # phases 0-4 on one card, about 10 minutes
  python chip_smoke.py --four   # train.py --mesh over four cards vs one

Default phases:
  0. device: the card (nvidia-smi), JAX, XLA flags; no GPU -> exit 1.
  1. the tests marked ``gpu``, run in-process: engine parity, the XLA
     batched rollout on the GPU and on the host CPU bit for bit, on
     three configurations.
  2. rollout at full size: bench.main at B=65,536, T=256.
  3. IPPO (MLP 128x128) at full width through train.main; its first
     update on the GPU against the CPU; a full-precision forward check.
  4. every other learner of train.py, two updates at B=4,096, T=128.

Every phase calls the entry points a user calls (train.main, bench.main)
in this one process: a second JAX process could not get the card's
memory.  Any failure raises and the script exits non-zero.  The last line
of standard output is the JSON record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# BASELINE.json configuration #5: a custom layout string, IMAGE
# observations and 16 agents
CUSTOM_LAYOUT = """
.................
.xx.xx.xx.xx.xx..
.xx.xx.xx.xx.xx..
.xx.xx.xx.xx.xx..
.................
.xx.xx.xx.xx.xx..
.xx.xx.xx.xx.xx..
.xx.xx.xx.xx.xx..
.................
.................
......gg.gg......
"""

PARITY_ENVS, PARITY_STEPS = 256, 64
BENCH = ["--env", "rware-tiny-2ag-v2", "--batch", "65536", "--steps", "256",
         "--repeats", "3"]
# one card: the first update at a small batch on the GPU and on the CPU
SMALL_IPPO = [
    "--env", "rware-tiny-2ag-v2", "--n-envs", "256", "--rollout-len", "16",
    "--updates", "1", "--log-every", "1",
]
# IPPO at full width: phase 3 on one card, --four on four against one
FULL_IPPO = [
    "--env", "rware-tiny-2ag-v2", "--n-envs", "16384", "--rollout-len", "128",
    "--updates", "3", "--log-every", "1",
]
LEARNER_BASE = ["--n-envs", "4096", "--rollout-len", "128", "--updates", "2",
                "--log-every", "1"]
LEARNERS = [
    ["--net", "gru"],
    ["--algo", "mappo"],
    ["--algo", "mappo", "--net", "gru"],
    ["--algo", "seac-ppo"],
    ["--algo", "seac-ppo", "--net", "gru"],
    ["--algo", "seac"],
    ["--algo", "mappo", "--net", "gru", "--msg-bits", "2"],
    ["--env", "rware-img-tiny-2ag-v2", "--net", "gru"],
]
# bound on the relative L2 gap between two runs' parameter updates, GPU
# against CPU and four cards against one: about 3x the largest gap read
# on H100 cards (0.0089 GPU vs CPU; 0.0013 and 0.0041 four cards vs one)
MAX_REL_UPDATE = 0.03
METRICS = ("pg_loss", "v_loss", "entropy", "approx_kl", "reward_per_env",
           "episodes_done")


def parity_configs():
    import rware_tpu
    from rware_tpu.types import ObservationType

    return {
        "rware-tiny-2ag-v2": rware_tpu.make("rware-tiny-2ag-v2").config,
        "rware-large-19ag-v2": rware_tpu.make("rware-large-19ag-v2").config,
        "custom-layout-image-16ag": rware_tpu.WarehouseConfig(
            n_agents=16, request_queue_size=16, layout=CUSTOM_LAYOUT,
            observation_type=ObservationType.IMAGE,
        ),
    }


def rollout_on(device, config, n_envs, n_steps, seed=0):
    """Reset and roll ``n_envs`` envs for ``n_steps`` random steps with
    autoreset on ``device``; returns (final state, trajectory) on the
    host, PRNG keys as raw key data."""
    import rware_tpu
    from rware_tpu.parallel import batched_reset, build_batched_rollout_fn

    env = rware_tpu.make(config)
    with jax.default_device(device):
        states, _ = batched_reset(env, jax.random.key(seed), n_envs)
        keys = jax.random.split(jax.random.key(seed + 1), n_envs)
        out = jax.jit(build_batched_rollout_fn(env, n_steps=n_steps))(
            states, keys
        )
    out = jax.tree.map(
        lambda x: jax.random.key_data(x)
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else x,
        out,
    )
    return jax.device_get(out)


def first_mismatch(ref, got, time_major):
    """Where two host pytrees first differ bit for bit: '<field> at step
    t' for time-major leaves, '<field>' otherwise; None when equal."""
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    for (path, a), (_, b) in zip(flat_ref, flat_got):
        name = jax.tree_util.keystr(path)
        a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
        if a.shape != b.shape or a.dtype != b.dtype:
            return f"{name}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}"
        rows_a = np.ascontiguousarray(a).view(np.uint8).reshape(a.shape[0], -1)
        rows_b = np.ascontiguousarray(b).view(np.uint8).reshape(b.shape[0], -1)
        bad = np.flatnonzero((rows_a != rows_b).any(axis=1))
        if bad.size:
            return f"{name} at step {bad[0]}" if time_major else name
    return None


def engine_parity(device_a, device_b, config, n_envs, n_steps):
    """None when the rollout on both devices agrees bit for bit in every
    state leaf, reward, done flag and observation; else where it first
    differs."""
    final_a, traj_a = rollout_on(device_a, config, n_envs, n_steps)
    final_b, traj_b = rollout_on(device_b, config, n_envs, n_steps)
    where = first_mismatch(traj_a, traj_b, time_major=True)
    if where is None:
        where = first_mismatch(final_a, final_b, time_major=False)
        where = where and f"final state {where}"
    return where


def check_finite(history, label):
    assert history, f"{label}: no metrics logged"
    for entry in history:
        for k, v in entry.items():
            assert np.isfinite(v), f"{label}: {k}={v} at update {entry['step']}"


def update_delta(params, params0):
    return np.concatenate([
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(params0))
    ])


def compare_runs(label, hist_ref, hist, params_ref, params, params0,
                 atol, rtol, max_rel_update):
    """Metrics within (atol, rtol) per logged update, and the parameter
    updates from ``params0`` within ``max_rel_update`` in relative L2."""
    for e_ref, e in zip(hist_ref, hist):
        for k in METRICS:
            np.testing.assert_allclose(
                e[k], e_ref[k], atol=atol, rtol=rtol,
                err_msg=f"{label}: {k} at update {e['step']}",
            )
    d_ref = update_delta(params_ref, params0)
    d = update_delta(params, params0)
    rel = float(np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref))
    print(f"{label}: |update - reference update| / |reference update| = "
          f"{rel}", flush=True)
    assert rel < max_rel_update, f"{label}: relative update gap {rel}"


def ippo_init_params(argv, seed=0, device=None):
    """The parameters train.main(argv) starts IPPO from."""
    import rware_tpu
    from rware_tpu.models import IPPOConfig, init_runner

    def arg(flag):
        return int(argv[argv.index(flag) + 1])

    env = rware_tpu.make("rware-tiny-2ag-v2")
    cfg = IPPOConfig(n_envs=arg("--n-envs"), rollout_len=arg("--rollout-len"))
    with jax.default_device(device or jax.devices()[0]):
        runner, model, _ = init_runner(env, cfg, jax.random.key(seed))
    return jax.device_get(runner.params), model, env


def print_update_times(label, history):
    walls = [e["wall_s"] for e in history]
    steps = np.diff(walls).tolist()
    print(f"{label}: first update incl. compile {walls[0]} s, later "
          f"updates {steps} s", flush=True)


# ------------------------------------------------------------------ phases


def phase_device():
    from rware_tpu.profiling import card_info, device_record, require_gpu

    print(card_info() or "nvidia-smi: not found", flush=True)
    print(f"jax {jax.__version__}, devices {device_record()}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    require_gpu("chip_smoke.py")


class _Outcomes:
    """pytest plugin: the node ids that passed, and those that did not."""

    def __init__(self):
        self.passed, self.not_passed = [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed.append(report.nodeid)
        elif report.failed or report.skipped:
            self.not_passed.append(report.nodeid)


def phase_gpu_tests():
    """The tests marked ``gpu`` (tests/test_gpu.py: engine parity, GPU
    against CPU), in this process.  Without the suite's conftest, which
    pins the test run to the CPU."""
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(
        ["-v", "-m", "gpu", "--noconftest", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_gpu.py")],
        plugins=[outcomes],
    )
    assert rc == 0 and outcomes.passed and not outcomes.not_passed, (
        f"gpu tests: exit {rc}, not passed {outcomes.not_passed}"
    )


def phase_rollout():
    import bench

    r = bench.main(BENCH)
    print(f"  [{r['card']}] compile {r['compile_s']} s, memory "
          f"{r['memory_bytes']}, warm rollouts {r['rollout_s']} s, "
          f"{r['value']} env-steps/s", flush=True)


def phase_ippo():
    import train
    from rware_tpu.profiling import card_info

    print(f"  [{card_info()}] IPPO {' '.join(FULL_IPPO)}", flush=True)
    runner, history = train.main(FULL_IPPO)
    check_finite(history, "ippo")
    params0, model, env = ippo_init_params(FULL_IPPO)
    moved = np.abs(update_delta(jax.device_get(runner.params), params0)).max()
    assert moved > 0, "ippo: parameters did not move"
    print_update_times("  ippo", history)

    # first update, GPU against CPU, same seed.  Tolerance: hidden layers
    # run in bf16 and float32 products may run in TF32 on the GPU, so
    # logits differ in the third digit, a near-tie may sample another
    # action, and Adam's first steps are sign-like, so near-zero gradient
    # elements can flip; metrics agree to 1e-2 + 5%, the parameter update
    # to MAX_REL_UPDATE in relative L2 norm.
    cpu = jax.devices("cpu")[0]
    r_gpu, h_gpu = train.main(SMALL_IPPO)
    with jax.default_device(cpu):
        r_cpu, h_cpu = train.main(SMALL_IPPO)
    p0, _, _ = ippo_init_params(SMALL_IPPO, device=cpu)
    compare_runs("  ippo first update GPU vs CPU", h_cpu, h_gpu,
                 jax.device_get(r_cpu.params), jax.device_get(r_gpu.params),
                 p0, atol=1e-2, rtol=5e-2, max_rel_update=MAX_REL_UPDATE)

    # the policy forward in float32 at full matmul precision: no bf16 or
    # TF32 rounding left, so GPU and CPU agree to about 1e-5
    obs = np.asarray(jax.random.normal(
        jax.random.key(3), (4096, env.n_agents, env.config.policy_obs_length)
    ))
    model32 = dataclasses.replace(model, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        outs = [
            jax.device_get(jax.jit(model32.apply)(*jax.device_put((p0, obs), d)))
            for d in (jax.devices()[0], cpu)
        ]
    for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    print("  policy forward, float32 at highest precision: GPU == CPU "
          "within 1e-5", flush=True)


def phase_learners():
    import train

    for extra in LEARNERS:
        label = " ".join(extra)
        t0 = time.perf_counter()
        _, history = train.main(LEARNER_BASE + extra)
        check_finite(history, label)
        print(f"  {label}: {time.perf_counter() - t0} s", flush=True)
        print_update_times(f"  {label}", history)


def phase_four():
    """train.py --mesh over four cards against the same run on one."""
    import train

    n = len(jax.devices())
    assert n == 4, f"--four needs four GPUs, JAX sees {n}"
    r1, h1 = train.main(FULL_IPPO)
    r4, h4 = train.main(FULL_IPPO + ["--mesh"])
    check_finite(h4, "ippo --mesh")
    print_update_times("  one card", h1)
    print_update_times("  four cards", h4)
    # tolerance: the sharded step sums gradients in another order (bf16
    # partial products, then an all-reduce), so parameters differ in the
    # last bits after the first update, and the second rollout may sample
    # a near-tie differently; same bounds as GPU against CPU
    params0, _, _ = ippo_init_params(FULL_IPPO)
    compare_runs("  ippo 4 cards vs 1", h1, h4, jax.device_get(r1.params),
                 jax.device_get(r4.params), params0, atol=1e-2, rtol=5e-2,
                 max_rel_update=MAX_REL_UPDATE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--four", action="store_true",
                   help="run only the four-card data-parallel phase")
    args = p.parse_args(argv)

    phase_device()
    from rware_tpu.compile_cache import enable_persistent_cache
    from rware_tpu.profiling import device_record

    enable_persistent_cache()
    phases = [("four-card data parallel", phase_four)] if args.four else [
        ("engine parity (tests marked gpu)", phase_gpu_tests),
        ("rollout at full size", phase_rollout),
        ("ippo at full width", phase_ippo),
        ("every learner", phase_learners),
    ]
    for i, (name, fn) in enumerate(phases, start=1):
        t0 = time.perf_counter()
        print(f"phase {i}: {name}", flush=True)
        fn()
        print(f"phase {i} passed: {name} ({time.perf_counter() - t0} s)",
              flush=True)
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)


if __name__ == "__main__":
    main()
