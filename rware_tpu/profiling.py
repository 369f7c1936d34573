"""Profiling hooks: jax.profiler traces and named step annotations.

The reference's only perf artifact is an ad-hoc tqdm loop
(rware/warehouse.py:1043-1054).  Here: ``trace(dir)`` captures a perfetto/
tensorboard-compatible device trace around any code block, and
``annotate(name)`` scopes device ops under a label in that trace.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Iterator, Optional

import jax


def require_gpu(program: str) -> jax.Device:
    """The first JAX device, which must be a GPU.  A measurement that finds
    none exits non-zero instead of timing whatever backend is there."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"{program} measures the GPU, and JAX found none "
            f"(platform {dev.platform!r})"
        )
    return dev


def device_record() -> dict:
    """The device as JAX reports it, for every printed result."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def card_info() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them
    (a card set below its maximum power runs slower under load), or ""
    where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0] if out else ""


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (view in tensorboard / perfetto)."""
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Scope device ops under ``name`` in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def stopwatch(label: str, sync: bool = True) -> Iterator[None]:
    """Host-side wall-clock timer; blocks on device completion when sync."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            # effects of the block may still be in flight
            jax.effects_barrier()
        print(f"[{label}] {time.perf_counter() - t0:.4f}s", flush=True)


def throughput(fn, *args, repeats: int = 3, items: Optional[int] = None):
    """Best-of-N wall time of a compiled callable; returns (seconds, items/s)."""
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, (items / best if items else None)


class StepTimer:
    """Rolling per-step wall-time stats for training/bench loops.

    Call ``tick()`` once per completed step; ``summary()`` reports mean /
    p50 / p95 milliseconds and steps/s over the recorded window (compile
    steps can be excluded with ``skip_first``).
    """

    def __init__(self, skip_first: int = 1, window: int = 512):
        self._skip = skip_first
        self._window = window
        self._durations: list = []
        self._last: Optional[float] = None

    def tick(self, n_steps: int = 1) -> None:
        """Record the time since the previous tick as ``n_steps`` equal
        steps (pass n_steps>1 when ticking only at host-sync boundaries
        that cover several train steps)."""
        now = time.perf_counter()
        if self._last is not None:
            if self._skip > 0:
                self._skip -= 1
            else:
                self._durations.append((now - self._last) / max(n_steps, 1))
                if len(self._durations) > self._window:
                    self._durations.pop(0)
        self._last = now

    def summary(self) -> dict:
        if not self._durations:
            return {}
        import numpy as np

        d = np.asarray(self._durations)
        return {
            "step_ms_mean": float(d.mean() * 1e3),
            "step_ms_p50": float(np.percentile(d, 50) * 1e3),
            "step_ms_p95": float(np.percentile(d, 95) * 1e3),
            "steps_per_s": float(1.0 / d.mean()),
        }


def aggregate_across_hosts(metrics: dict, reduce: str = "mean") -> dict:
    """Reduce scalar metrics across all hosts of a multi-host run.

    Single-process runs return the metrics unchanged; under
    ``jax.distributed`` every host contributes its local values and all
    hosts receive the reduced dict (``mean`` or ``sum``).  Use for
    per-host throughput/reward aggregation in multi-host training loops.
    """
    if jax.process_count() == 1:
        return {k: float(v) for k, v in metrics.items()}
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    keys = sorted(metrics)
    vec = jnp.asarray([float(metrics[k]) for k in keys])
    gathered = multihost_utils.process_allgather(vec)  # (n_hosts, K)
    red = gathered.mean(axis=0) if reduce == "mean" else gathered.sum(axis=0)
    return {k: float(v) for k, v in zip(keys, red)}


class TraceWindow:
    """Automatic trace artifact for a window of loop steps.

    Captures a jax.profiler device trace of steps
    ``[start, start + n_steps)`` — after compile/warmup, short enough to
    stay viewable — without wrapping the whole run.  Call ``step(idx)``
    once per loop iteration; ``close()`` is safe to call any time.
    """

    def __init__(self, log_dir: str, start: int = 3, n_steps: int = 3):
        self.log_dir = log_dir
        self.start = start
        self.stop = start + n_steps
        self._active = False
        self._done = False

    def step(self, idx: int) -> None:
        if self._done:
            return
        if not self._active and idx >= self.start:
            jax.profiler.start_trace(self.log_dir)
            self._active = True
        elif self._active and idx >= self.stop:
            jax.effects_barrier()
            jax.profiler.stop_trace()
            self._active = False
            self._done = True

    def close(self) -> None:
        if self._active:
            jax.effects_barrier()
            jax.profiler.stop_trace()
            self._active = False
            self._done = True
