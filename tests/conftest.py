"""Test environment: force a virtual 8-device CPU mesh.

Kernels are pure functions, so `jax.jit` on CPU is the reference-accurate
fake backend (SURVEY.md §4); multi-device sharding tests run on 8 virtual
CPU devices via XLA's host platform device count. Tests of code that runs
only on a GPU carry the `gpu` marker and skip here (see `gpu_device`).
"""

import os

# CPU unless the caller names platforms (the GPU-marked tests run on the
# card with JAX_PLATFORMS=cuda,cpu)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402

from gpu_raytracer.device import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled kernels); skipped on "
        "the CPU")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, never while test modules are imported."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the compiled kernel runs only on the card")


@pytest.fixture(scope="session")
def default_scene():
    from gpu_raytracer import build_default_scene

    return build_default_scene()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
