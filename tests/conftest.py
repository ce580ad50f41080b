"""Test config: run on the CPU backend with 8 virtual devices, so the
device paths and the multi-device sharding tests run without a GPU.

Tests that need the GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when JAX finds no GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when there is none (decided here, at run
    time, never while a test module is imported)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
