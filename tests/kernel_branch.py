"""Run ops/trace.py's GPU branch on the CPU: the traversal kernel in the
Pallas interpreter, everything around it as on the card."""

import contextlib
from functools import partial

import jax


@contextlib.contextmanager
def kernel_branch():
    import gpu_raytracer.ops.trace as T
    from gpu_raytracer.ops.traverse_kernel import kernel_traverse

    saved = T.traversal, T.kernel_traverse
    T.traversal = lambda: "kernel"
    T.kernel_traverse = partial(kernel_traverse, interpret=True)
    jax.clear_caches()        # jitted callers must retrace the branch
    try:
        yield
    finally:
        T.traversal, T.kernel_traverse = saved
        jax.clear_caches()
