"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding paths are exercised without accelerators by forcing the
host platform with 8 virtual devices.  Set FRIES_TEST_ON_DEVICE=1 to run on
the machine's default JAX platform instead; the tests marked ``gpu`` need
that (``FRIES_TEST_ON_DEVICE=1 python -m pytest -m gpu tests/``) and skip
otherwise.

The platform is pinned through jax.config before any backend initializes.
"""

import os
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# persistent compilation cache: amortizes XLA compiles across test runs
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(_REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

if not os.environ.get("FRIES_TEST_ON_DEVICE"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run with FRIES_TEST_ON_DEVICE=1 on one)")
    return gpus[0]
