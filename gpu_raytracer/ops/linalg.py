"""Small-vector helpers over [..., 3] arrays.

Replaces glam's Vec3 ops used throughout the reference shader with batched
jnp equivalents. `max0` reproduces Rust's NaN-ignoring `f32::max(0.0)`
semantics (NaN → 0), which the reference's branchless lighting relies on
(shader/src/lighting.rs:104,129,132 — e.g. normalising a
zero light direction yields NaN that `.max(0.0)` silences).
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """glam-style normalize: divides by the length, 0-vectors produce NaN
    (matching the reference's behaviour; callers mask via max0)."""
    return a / length(a)[..., None]


def max0(x: jnp.ndarray) -> jnp.ndarray:
    """Rust `x.max(0.0)`: returns 0.0 when x is NaN or x <= 0."""
    return jnp.where(x > 0.0, x, 0.0)
