"""The platform decision (gpu_raytracer/device.py)."""

import os

import jax
import pytest

from gpu_raytracer import device


def test_cpu_runs_the_xla_traversal():
    assert device.platform() == "cpu"
    assert device.traversal() == "xla"


@pytest.mark.parametrize("backend,expect", [("gpu", "kernel"),
                                            ("cpu", "xla")])
def test_traversal_follows_the_backend(monkeypatch, backend, expect):
    monkeypatch.setattr(device.jax, "default_backend", lambda: backend)
    assert device.platform() == backend
    assert device.traversal() == expect


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_unknown_platform_is_an_error(monkeypatch, backend):
    monkeypatch.setattr(device.jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match=backend):
        device.platform()
    with pytest.raises(RuntimeError):
        device.traversal()


def test_default_device_decides(monkeypatch):
    """A program on a GPU host that pins a CPU device runs the XLA path."""
    monkeypatch.setattr(device.jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert device.traversal() == "xla"
    with jax.default_device("cpu"):
        assert device.platform() == "cpu"
    assert device.traversal() == "kernel"


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def test_compile_cache_follows_the_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(device.CHECKOUT, ".jax_cache")
    assert device.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert device.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.path.isfile(os.path.join(device.CHECKOUT, "gpu_raytracer",
                                       "device.py"))
