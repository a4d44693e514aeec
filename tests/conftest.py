"""Test configuration: the CPU backend with 8 virtual devices, and fp64.

The analog of the reference's FailParam fixture
(reference tests/testthat/setup.R:1-13): all tests run on a *declared* fake
8-device mesh so sharding-equivalence tests can assert that collectives only
occur on that mesh, and numerics run in float64 for oracle comparisons.

The suite always runs on the CPU, so pytest-xdist workers never open a GPU
(one JAX process per card). Tests marked ``gpu`` need the card and skip
here; ``python chip_smoke.py`` runs them on an H100.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite compiles many shape variants.
from batchelor_tpu.utils.cache import use_compile_cache  # noqa: E402

use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on the CPU suite, "
        "run on the card by chip_smoke.py"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip where JAX has none (the CPU suite)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU; run by chip_smoke.py on the card")
