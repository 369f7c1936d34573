"""Test configuration: force a deterministic 8-device CPU platform.

Tests run on the CPU with 8 virtual devices so the sharding/mesh suite
exercises multi-device code paths without hardware (SURVEY.md §4:
fake-backend strategy), whatever accelerator the machine has.
``jax.config`` is updated here, before any backend is initialised by test
imports.  Tests that need a GPU are marked ``gpu`` and skip here
(tests/test_gpu.py); ``python chip_smoke.py`` runs them on the card.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_ROOT = "/root/reference"

if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


def has_reference() -> bool:
    """True when the upstream reference checkout is importable (dev machine)."""
    return os.path.isdir(os.path.join(REFERENCE_ROOT, "rware"))


def import_reference():
    """Import the reference ``rware`` package from the read-only checkout."""
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)
    import rware  # noqa: F401
    import rware.warehouse as ref_warehouse

    return ref_warehouse
