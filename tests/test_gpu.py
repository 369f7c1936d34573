"""Checks that need an NVIDIA GPU.

Each test decides in the ``gpu`` fixture, never at import, whether JAX
sees a GPU, and skips otherwise.  This suite's conftest pins JAX to the
CPU, so here they always skip; phase 1 of ``python chip_smoke.py`` runs
them in-process on the card, without the conftest.
"""
import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU; python chip_smoke.py runs this on the card")
    return devices[0]


@pytest.mark.parametrize("name", list(chip_smoke.parity_configs()))
def test_engine_parity_gpu_vs_cpu(gpu, name):
    """The batched rollout on the GPU equals the CPU's bit for bit in
    every state leaf, reward, done flag and observation."""
    where = chip_smoke.engine_parity(
        gpu, jax.devices("cpu")[0], chip_smoke.parity_configs()[name],
        chip_smoke.PARITY_ENVS, chip_smoke.PARITY_STEPS,
    )
    assert where is None, f"{name}: GPU and CPU rollouts differ: {where}"
