"""ctypes binding for the native C++ BVH builder (csrc/bvh_builder.cpp).

The reference's performance-critical host component is its multicore BVH
build (src/bvh.rs:142, `BVHf::build_par`). Our equivalent is a
C++ binned-SAH builder compiled to a shared library at first use
(utils/native.py); this module loads it and adapts it to
:class:`~gpu_raytracer.models.bvh.BvhBuildResult`.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native import load

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load("libbvh_builder.so")
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,   # vertices, V
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,  # indices, T
        ctypes.c_int32,                                    # leaf_size
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),  # node_min/max out
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),  # left/right out
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),  # start/count out
        ctypes.POINTER(ctypes.c_int64),                    # tri_order out
        ctypes.POINTER(ctypes.c_int32),                    # max_depth out
    ]
    lib.bvh_build.restype = ctypes.c_int64  # number of nodes, <0 on error
    _LIB = lib
    return _LIB


def build_bvh_native(vertices: np.ndarray, indices: np.ndarray, leaf_size: int):
    lib = _load()
    from .bvh import BvhBuildResult

    vertices = np.ascontiguousarray(vertices, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32)
    T = indices.shape[0]
    cap = max(2 * T + 2, 16)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left = np.zeros(cap, np.int32)
    right = np.zeros(cap, np.int32)
    start = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    order = np.zeros(T, np.int64)
    depth = np.zeros(1, np.int32)

    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    n = lib.bvh_build(
        p(vertices, ctypes.c_float), vertices.shape[0],
        p(indices, ctypes.c_uint32), T, leaf_size,
        p(node_min, ctypes.c_float), p(node_max, ctypes.c_float),
        p(left, ctypes.c_int32), p(right, ctypes.c_int32),
        p(start, ctypes.c_int32), p(count, ctypes.c_int32),
        p(order, ctypes.c_int64), p(depth, ctypes.c_int32),
    )
    if n < 0:
        raise RuntimeError(f"native BVH build failed (code {int(n)})")
    n = int(n)
    return BvhBuildResult(
        node_min[:n].copy(), node_max[:n].copy(), left[:n].copy(),
        right[:n].copy(), start[:n].copy(), count[:n].copy(),
        order, int(depth[0]),
    )
