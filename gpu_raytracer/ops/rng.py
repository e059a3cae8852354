"""Random number generation.

Two generators:

* `lcg_*` — bit-exact vectorised port of the reference's `SimpleRng`
  (shader/src/wavefront.rs:44-72): Numerical Recipes LCG,
  `next_f32 = (u >> 8) / 2^24`, per-pixel seed
  `frame_seed + x + y*width` (shader/src/lib.rs:103-105). Used for parity
  tests against the reference wavefront semantics.

* threefry via `jax.random` — the default for real path tracing (the
  counter-based, order-independent RNG a batched pipeline wants; replaces
  the LCG per
  SURVEY.md §7 P4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LCG_A = jnp.uint32(1664525)
_LCG_C = jnp.uint32(1013904223)


def lcg_pixel_seed(frame_seed, px, py, width):
    """pixel_seed = frame_seed + x + y*width, wrapping u32 arithmetic
    (shader/src/lib.rs:103-105)."""
    return (jnp.uint32(frame_seed)
            + px.astype(jnp.uint32)
            + py.astype(jnp.uint32) * jnp.uint32(width))


def lcg_next(state: jnp.ndarray):
    """One LCG step → (new_state, u32 value). state: u32 array."""
    state = state * _LCG_A + _LCG_C
    return state, state


def lcg_next_f32(state: jnp.ndarray):
    """Random f32 in [0,1): (next_u32 >> 8) / 2^24 (wavefront.rs:63-66)."""
    state, u = lcg_next(state)
    return state, (u >> jnp.uint32(8)).astype(jnp.float32) / jnp.float32(16777216.0)


def lcg_next_f32_signed(state: jnp.ndarray):
    """Random f32 in [-1,1) (wavefront.rs:68-71)."""
    state, f = lcg_next_f32(state)
    return state, f * 2.0 - 1.0


def sample_uniform(key: jax.Array, shape, n: int) -> jnp.ndarray:
    """n independent U[0,1) variates per element → [*shape, n]."""
    return jax.random.uniform(key, tuple(shape) + (n,), jnp.float32)


def bounce_key(base: jax.Array, sample_idx, depth: int) -> jax.Array:
    """Derive a per-(sample, bounce) key; counter-based so replay-stable."""
    return jax.random.fold_in(jax.random.fold_in(base, sample_idx), depth)
