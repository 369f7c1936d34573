"""Where the compile cache lives, and what the main path imports.

Each case runs in a fresh interpreter: the cache settings and the import
blocker are process-wide."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CACHE_PROBE = """
import jax
from rware_tpu.compile_cache import REPO_CACHE_DIR, enable_persistent_cache
print(repr(enable_persistent_cache()))
print(repr(jax.config.jax_compilation_cache_dir))
print(repr(REPO_CACHE_DIR))
"""


def _python(code, **env_overrides):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **env_overrides}
    for k, v in env_overrides.items():
        if v is None:
            env.pop(k)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


def test_cache_honours_jax_compilation_cache_dir(tmp_path):
    returned, configured, _ = _python(
        CACHE_PROBE, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
        RWARE_TPU_NO_CACHE=None,
    )
    # JAX reads the variable itself; the program sets no other directory
    assert eval(returned) == str(tmp_path)
    assert eval(configured) == str(tmp_path)


def test_cache_default_is_fixed_inside_checkout():
    returned, configured, repo_dir = _python(
        CACHE_PROBE, JAX_COMPILATION_CACHE_DIR=None, RWARE_TPU_NO_CACHE=None
    )
    assert eval(returned) == eval(configured) == eval(repo_dir)
    assert eval(repo_dir) == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_opt_out():
    returned, configured, _ = _python(
        CACHE_PROBE, JAX_COMPILATION_CACHE_DIR=None, RWARE_TPU_NO_CACHE="1"
    )
    assert eval(returned) is None
    assert eval(configured) is None


BLOCKED_IMPORT = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "gymnasium", "orbax"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import importlib
importlib.import_module({module!r})
assert not {{m for m in sys.modules if m.split(".")[0] in ("flax", "gymnasium", "orbax")}}
print("ok")
"""


@pytest.mark.parametrize(
    "module",
    ["rware_tpu", "rware_tpu.models.mappo", "rware_tpu.models.seac",
     "train", "bench", "chip_smoke"],
)
def test_main_path_imports_without_optional_packages(module):
    """flax is not a dependency; gymnasium and orbax are optional and the
    training, benchmark and smoke entry points import neither."""
    assert _python(BLOCKED_IMPORT.format(module=module)) == ["ok"]
