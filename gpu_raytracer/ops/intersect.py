"""Intersection math: ray-sphere, ray-triangle (Möller-Trumbore), ray-AABB.

Formula-for-formula port of shader/src/intersection.rs,
re-shaped from one-ray-one-thread SIMT into batched masked vector ops: every
function takes [N,...] ray arrays against [K,...] primitive arrays and returns
dense t/valid arrays, letting XLA keep vector lanes full with zero divergence.

MISS_T is the miss sentinel (reference: t = f32::MAX, intersection.rs:28).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import DEFAULT_CONFIG
from .linalg import cross, dot

MIN_T = jnp.float32(DEFAULT_CONFIG.min_ray_distance)  # MIN_RAY_DISTANCE = 1e-5
MISS_T = jnp.float32(3.4028235e38)                    # f32::MAX


def sphere_intersect(orig, dirn, center, radius, max_t):
    """Analytic quadratic — intersection.rs:52-87.

    orig/dirn: [N,3]; center: [S,3]; radius: [S]; max_t: [N] or scalar.
    Returns (t [N,S], hit [N,S]).
    """
    oc = orig[:, None, :] - center[None, :, :]          # [N,S,3]
    a = dot(dirn, dirn)[:, None]                        # [N,1]
    b = 2.0 * jnp.sum(oc * dirn[:, None, :], axis=-1)   # [N,S]
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = jnp.where(t1 > MIN_T, t1, t2)                   # near root preferred
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (orig.shape[0],))
    hit = (disc >= 0.0) & (t > MIN_T) & (t < max_t[:, None])
    return jnp.where(hit, t, MISS_T), hit


def triangle_intersect(orig, dirn, v0, e1, e2, max_t):
    """Möller-Trumbore — intersection.rs:91-138, with edges precomputed at
    scene-prep time (the reference recomputes them per thread per test).

    orig/dirn: [N,3]; v0/e1/e2: [K,3]; max_t: [N] or scalar.
    Returns (t [N,K], hit [N,K]).
    """
    d = dirn[:, None, :]                                # [N,1,3]
    h = cross(d, e2[None, :, :])                        # [N,K,3]
    a = jnp.sum(e1[None, :, :] * h, axis=-1)            # [N,K]
    near_zero = jnp.abs(a) < MIN_T
    f = 1.0 / a
    s = orig[:, None, :] - v0[None, :, :]               # [N,K,3]
    u = f * jnp.sum(s * h, axis=-1)
    q = cross(s, e1[None, :, :])
    v = f * jnp.sum(d * q, axis=-1)
    t = f * jnp.sum(e2[None, :, :] * q, axis=-1)
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (orig.shape[0],))
    hit = (
        ~near_zero
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > MIN_T) & (t < max_t[:, None])
    )
    return jnp.where(hit, t, MISS_T), hit


def aabb_intersect(orig, dirn, bmin, bmax):
    """Slab test — intersection.rs:151-164. Entry distance is also returned
    for best-t pruning (a strict refinement: any triangle inside sits at
    t >= entry, so culling entry > best_t can never change the closest hit).

    orig/dirn: [N,3]; bmin/bmax: [N,3] (already gathered per ray).
    Returns (hit [N], entry_t [N]).
    """
    inv = 1.0 / dirn
    t1 = (bmin - orig) * inv
    t2 = (bmax - orig) * inv
    tmin = jnp.minimum(t1, t2)
    tmax = jnp.maximum(t1, t2)
    tmin_max = jnp.max(tmin, axis=-1)
    tmax_min = jnp.min(tmax, axis=-1)
    hit = (tmax_min >= 0.0) & (tmin_max <= tmax_min)
    return hit, tmin_max


def closest_select(t: jnp.ndarray, hit: jnp.ndarray):
    """Reduce a [N,K] candidate matrix to the first-occurring minimum,
    matching the reference's sequential strict-< loops (ties go to the lower
    index, e.g. shader/src/lib.rs:260-268). Returns (t_best [N], idx [N], any [N])."""
    t = jnp.where(hit, t, MISS_T)
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
    t_best = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
    return t_best, idx, jnp.any(hit, axis=-1)
