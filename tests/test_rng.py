"""LCG parity (ops/rng.py) — bit-exact against the reference's SimpleRng
semantics (shader/src/wavefront.rs:44-72): Numerical Recipes
constants, wrapping u32, (u >> 8) / 2^24 float mapping."""

import numpy as np
import jax.numpy as jnp

from gpu_raytracer.ops.rng import (
    lcg_next, lcg_next_f32, lcg_next_f32_signed, lcg_pixel_seed)


def _py_lcg(state):
    return (state * 1664525 + 1013904223) & 0xFFFFFFFF


def test_lcg_state_sequence_bit_exact():
    seeds = np.asarray([0, 1, 12345, 0xFFFFFFFF], np.uint32)
    state = jnp.asarray(seeds)
    py_state = seeds.astype(np.uint64)
    for _ in range(8):
        state, u = lcg_next(state)
        py_state = np.asarray([_py_lcg(int(s)) for s in py_state], np.uint64)
        np.testing.assert_array_equal(np.asarray(u).astype(np.uint64),
                                      py_state)


def test_lcg_f32_mapping():
    state = jnp.asarray([7], dtype=jnp.uint32)
    _, f = lcg_next_f32(state)
    want = (_py_lcg(7) >> 8) / 16777216.0
    assert abs(float(f[0]) - want) < 1e-9
    _, fs = lcg_next_f32_signed(state)
    assert abs(float(fs[0]) - (want * 2.0 - 1.0)) < 1e-7
    # range invariants
    s = jnp.arange(1000, dtype=jnp.uint32)
    _, f = lcg_next_f32(s)
    assert (np.asarray(f) >= 0).all() and (np.asarray(f) < 1.0).all()


def test_lcg_pixel_seed_wraps():
    px = jnp.asarray([3], dtype=jnp.uint32)
    py = jnp.asarray([2], dtype=jnp.uint32)
    s = lcg_pixel_seed(0xFFFFFFFF, px, py, 1920)
    want = (0xFFFFFFFF + 3 + 2 * 1920) & 0xFFFFFFFF
    assert int(np.asarray(s)[0]) == want
