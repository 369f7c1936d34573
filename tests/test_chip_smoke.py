"""chip_smoke.py and bench.py on a machine without a GPU: both refuse to
run and print no result; the helpers chip_smoke compares devices with,
checked between two of the virtual CPU devices."""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke
import rware_tpu
from rware_tpu.parallel import batched_reset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "RWARE_TPU_NO_CACHE": "1"}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_exits_nonzero_without_gpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "measures the GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_exits_nonzero_without_gpu():
    out = _run(["bench.py", "--batch", "8", "--steps", "4"])
    assert out.returncode != 0
    assert "env-steps/s" not in out.stdout


def test_bench_main_refuses_cpu_in_process():
    with pytest.raises(SystemExit):
        bench.main(["--batch", "8", "--steps", "4"])


def test_bench_rollout_runs_past_episode_end():
    """The benchmarked program: random actions with autoreset, so 600
    steps of 500-step episodes end 100 steps into the second episode."""
    env = rware_tpu.make("rware-tiny-2ag-v2")
    states, _ = batched_reset(env, jax.random.key(0), 4)
    final, rew = bench.build_rollout(env, 4, 600, 4)(states, jax.random.key(1))
    np.testing.assert_array_equal(np.asarray(final.cur_steps), 100)
    assert np.isfinite(float(rew)) and float(rew) >= 0


@pytest.mark.parametrize("name", list(chip_smoke.parity_configs()))
def test_engine_parity_between_two_devices(name):
    """chip_smoke phase 1's comparison, between two virtual CPU devices."""
    config = chip_smoke.parity_configs()[name]
    a, b = jax.devices()[:2]
    assert chip_smoke.engine_parity(a, b, config, n_envs=8, n_steps=6) is None


def test_first_mismatch_names_field_and_step():
    config = rware_tpu.make("rware-tiny-2ag-v2").config
    final, traj = chip_smoke.rollout_on(jax.devices()[0], config, 4, 5)
    assert chip_smoke.first_mismatch(traj, traj, time_major=True) is None
    rewards = np.array(traj.rewards)
    rewards[3, 1, 0] += 0.5
    where = chip_smoke.first_mismatch(
        traj, traj._replace(rewards=rewards), time_major=True
    )
    assert where == ".rewards at step 3"
    moved = final.replace(agent_x=np.asarray(final.agent_x) + 1)
    assert chip_smoke.first_mismatch(final, moved, time_major=False) == ".agent_x"


def test_compare_runs_bounds_the_update_gap():
    p0 = {"w": np.zeros(100)}
    p_ref = {"w": np.full(100, 3e-4)}
    hist = [dict.fromkeys(chip_smoke.METRICS, 0.5) | {"step": 1}]
    tol = dict(atol=1e-2, rtol=5e-2, max_rel_update=chip_smoke.MAX_REL_UPDATE)
    chip_smoke.compare_runs("same", hist, hist, p_ref, p_ref, p0, **tol)
    chip_smoke.compare_runs("1% off", hist, hist, p_ref,
                            {"w": 1.01 * p_ref["w"]}, p0, **tol)
    # a 5% error in every update element is caught
    with pytest.raises(AssertionError):
        chip_smoke.compare_runs("5% off", hist, hist, p_ref,
                                {"w": 1.05 * p_ref["w"]}, p0, **tol)
    with pytest.raises(AssertionError):
        chip_smoke.compare_runs("flipped", hist, hist, p_ref,
                                {"w": -p_ref["w"]}, p0, **tol)
    off = [dict(hist[0], pg_loss=0.7)]
    with pytest.raises(AssertionError):
        chip_smoke.compare_runs("metric", hist, off, p_ref, p_ref, p0, **tol)
