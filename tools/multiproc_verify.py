#!/usr/bin/env python
"""Localhost multi-PROCESS distributed verification (CPU only).

The multi-host wiring (jax.distributed init, global mesh, per-process
batch assembly, cross-host metric aggregation) is otherwise exercised only
inside one OS process on a virtual mesh.  This harness drives the REAL
``train.py --distributed --mesh`` path — the command every host of a
multi-host job runs — as W separate OS processes on localhost (W x D virtual CPU devices, coordinator on a
local port), then asserts the training metrics MATCH a single-process
run over the identical 8-device global mesh: the same SPMD program,
partitioned over processes, must produce the same numbers.

Writes a JSON artifact (--out): per-layout metric summaries, the
match verdict, and wall-clock.  Layouts verified: 1x8 (reference),
2x4, 4x2 processes x devices-per-process.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAIN_ARGS = [
    "--algo", "mappo", "--platform", "cpu",
    "--updates", "3", "--n-envs", "1024", "--rollout-len", "8",
    "--log-every", "1", "--mesh", "--seed", "7",
]


def run_layout(n_procs: int, n_dev: int, port: int):
    """Launch train.py as n_procs OS processes x n_dev virtual CPU devices
    each; returns (per-process parsed metric lines, wall_s)."""
    procs = []
    t0 = time.time()
    for pid in range(n_procs):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={n_dev} "
            + env.get("XLA_FLAGS", "")
        )
        env["JAX_PLATFORMS"] = "cpu"
        env["RWARE_TPU_PLATFORM"] = "cpu"
        if n_procs > 1:
            env["RWARE_COORD_ADDR"] = f"localhost:{port}"
            env["RWARE_NUM_PROCS"] = str(n_procs)
            env["RWARE_PROC_ID"] = str(pid)
        cmd = [sys.executable, os.path.join(REPO, "train.py")]
        cmd += TRAIN_ARGS
        if n_procs > 1:
            cmd.append("--distributed")
        # each worker writes to its own temp FILE (not an OS pipe):
        # sequential pipe draining could deadlock the process group if a
        # later worker filled its pipe buffer while blocked inside a
        # collective that an earlier (still-draining) worker is part of
        log = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
        procs.append(
            (
                subprocess.Popen(
                    cmd, env=env, cwd=REPO,
                    stdout=log, stderr=subprocess.STDOUT, text=True,
                ),
                log,
            )
        )
    outs = []
    deadline = time.time() + 1200
    for p, log in procs:
        p.wait(timeout=max(1, deadline - time.time()))
    for p, log in procs:
        log.seek(0)
        out = log.read()
        log.close()
        outs.append(out)
        if p.returncode != 0:
            raise RuntimeError(
                f"worker exited {p.returncode}:\n{out[-3000:]}"
            )
    wall = time.time() - t0
    # parse the per-update "step N  k=v ..." lines the MetricLogger
    # prints, keeping only layout-invariant keys (wall_s /
    # env_steps_per_s are wall-clock)
    keep = ("reward_per_env", "episodes_done", "pg_loss", "v_loss",
            "entropy", "approx_kl")
    parsed = []
    for out in outs:
        rows = {}
        for line in out.splitlines():
            m = re.match(r"step (\d+)\s+(.*)", line.strip())
            if not m:
                continue
            kv = dict(re.findall(r"(\w+)=([-\d.eE+a-z]+)", m.group(2)))
            rows[int(m.group(1))] = {k: kv[k] for k in keep if k in kv}
        parsed.append({"steps": rows, "raw_tail": out[-500:]})
    return parsed, wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="MULTIPROC.json")
    ap.add_argument("--port", type=int, default=45123)
    args = ap.parse_args()

    layouts = [(1, 8), (2, 4), (4, 2)]
    results = {"train_args": " ".join(TRAIN_ARGS), "layouts": {}}
    summaries = {}
    for n_procs, n_dev in layouts:
        name = f"{n_procs}proc_x_{n_dev}dev"
        print(f"=== {name} ===", flush=True)
        try:
            parsed, wall = run_layout(n_procs, n_dev, args.port + n_procs)
            # every process of a layout must agree with its peers
            views = {json.dumps(p["steps"], sort_keys=True) for p in parsed}
            ok = len(views) == 1 and bool(parsed[0]["steps"])
            results["layouts"][name] = {
                "ok": ok,
                "wall_s": round(wall, 1),
                "steps": parsed[0]["steps"],
                "per_process_agree": len(views) == 1,
            }
            summaries[name] = json.dumps(parsed[0]["steps"], sort_keys=True)
            print(name, "ok=", ok, "wall=", round(wall, 1), flush=True)
        except Exception as e:  # noqa: BLE001 — record, keep going
            results["layouts"][name] = {"ok": False, "error": repr(e)[:2000]}
            print(name, "FAILED", repr(e)[:500], flush=True)

    # cross-layout match: the same global mesh program partitioned over
    # 1, 2 or 4 processes must produce the same training metrics (1e-3
    # relative tolerance — cross-process collectives legitimately change
    # float reduction order in the last couple of digits)
    def close(a, b):
        sa = json.loads(a)
        sb = json.loads(b)
        if sa.keys() != sb.keys():
            return False
        for step in sa:
            for k in sa[step]:
                va, vb = float(sa[step][k]), float(sb[step][k])
                if abs(va - vb) > 1e-3 * max(1.0, abs(va)):
                    return False
        return True

    vals = [v for v in summaries.values() if v]
    results["metrics_match_across_layouts"] = len(vals) == len(
        layouts
    ) and all(close(vals[0], v) for v in vals[1:])
    results["ok"] = results["metrics_match_across_layouts"] and all(
        r.get("ok") for r in results["layouts"].values()
    )
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"multiproc_ok": results["ok"]}))


if __name__ == "__main__":
    main()
