"""The one platform decision: which backend runs, which triangle traversal
it uses, and where compiled programs are cached.

Two platforms are supported and nothing else:

* ``gpu`` — an NVIDIA GPU. Triangle traversal runs in the Pallas (Triton)
  kernel of ops/traverse_kernel.py.
* ``cpu`` — the plain XLA path (ops/packet_trace.py, ops/bvh_traverse.py).
  This is how the tests run.

Any other platform is an error. The platform is the one computations are
placed on: the default device when ``jax.default_device`` names one (a
program on a GPU host can run the XLA reference path on its CPU device
inside ``with jax.default_device(jax.devices("cpu")[0])``), the default
backend otherwise. ``jax_default_device`` is part of jit's cache key, so a
jitted function traced under each setting keeps its own choice.
"""

from __future__ import annotations

import os

import jax

SUPPORTED_PLATFORMS = ("gpu", "cpu")
TRAVERSAL = {"gpu": "kernel", "cpu": "xla"}

# The checkout root (the directory holding the package).
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def platform() -> str:
    """'gpu' or 'cpu'; raises for any other platform."""
    dev = jax.config.jax_default_device
    if dev is None:
        name = jax.default_backend()
    elif isinstance(dev, str):
        name = dev
    else:
        name = dev.platform
    if name not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: this renderer runs on an "
            f"NVIDIA GPU ('gpu') or, for tests, on the CPU ('cpu')")
    return name


def traversal() -> str:
    """'kernel' on the GPU, 'xla' on the CPU (see the module docstring)."""
    return TRAVERSAL[platform()]


def require_gpu() -> None:
    """Fail unless JAX's default backend is a GPU — measurement and smoke
    scripts call this so that they never report CPU numbers."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU found: JAX's default backend is "
                         f"{backend!r} ({jax.devices()})")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.
    When JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing
    is set here."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    return compile_cache_dir()
