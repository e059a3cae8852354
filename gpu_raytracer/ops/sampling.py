"""BSDF direction sampling for the wavefront path tracer.

This implements the continuation-ray generation the reference designed but
left as an explicit stub returning 0 rays
(shader/src/wavefront.rs:340-355 — "1. Evaluate the
BRDF/BTDF, 2. Sample new ray directions, 3. Russian roulette, 4. Create new
WavefrontRay instances"). Material interpretation follows the reference's
model: metallic>0.5 → mirror-ish lobe widened by roughness, transmission>0 →
refraction with the wavelength-dependent IOR table (shader/src/material.rs:
42-58), otherwise cosine-weighted Lambertian. Ray-type codes (1=reflection,
2=transmission) match WavefrontRay (shared/src/lib.rs:169).
"""

from __future__ import annotations

import jax.numpy as jnp

from .linalg import cross, dot, normalize
from .shading import DISPERSION

RAY_CAMERA, RAY_REFLECT, RAY_TRANSMIT, RAY_SHADOW = 0, 1, 2, 3


def orthonormal_basis(n: jnp.ndarray):
    """Branchless ONB (Duff et al.) around unit normals [N,3] → (t, b)."""
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    u = jnp.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, u


def cosine_hemisphere(n: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray):
    """Cosine-weighted directions about normals n [N,3]; u1,u2 ∈ [0,1)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    t, b = orthonormal_basis(n)
    return normalize(t * x[..., None] + b * y[..., None] + n * z[..., None])


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Snell refraction. d, n unit; eta = n1/n2 per ray [N].
    Returns (dir [N,3], total_internal_reflection [N])."""
    cos_i = -dot(d, n)
    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return normalize(jnp.where(tir[..., None], reflect(d, n), refr)), tir


def schlick_fresnel(cos_i: jnp.ndarray, n1: jnp.ndarray, n2: jnp.ndarray):
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def ior_for_channel(base_ior: jnp.ndarray, channel: jnp.ndarray) -> jnp.ndarray:
    """Wavelength-dependent IOR lookup (material.rs:42-58); channel ≥ 3 → +0."""
    offs = jnp.where(channel < 3, DISPERSION[jnp.clip(channel, 0, 2)], 0.0)
    return base_ior + offs
