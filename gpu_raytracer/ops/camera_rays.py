"""Camera ray generation.

Exact math of Ray::from_screen_coordinates
(shader/src/ray.rs:22-53): pixel-centre UVs, aspect × tan(fov/2)
scaling, camera basis right = forward × up, true_up = right × forward (note:
neither is normalised — kept for parity), direction normalised at the end.
Vectorised over whole pixel batches instead of one thread per pixel.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.camera import Camera
from .linalg import cross, normalize


def generate_rays(
    camera: Camera,
    width: int,
    height: int,
    px: jnp.ndarray,
    py: jnp.ndarray,
    jitter: jnp.ndarray | None = None,
):
    """Rays through pixel centres (or jittered positions for AA sampling).

    px, py: integer pixel coordinates, any broadcastable shape [...].
    jitter: optional [..., 2] offsets in [0,1) replacing the +0.5 centre.
    Returns (origins [...,3], directions [...,3] unit).
    """
    w = jnp.float32(width)
    h = jnp.float32(height)
    if jitter is None:
        ox = oy = jnp.float32(0.5)
    else:
        ox, oy = jitter[..., 0], jitter[..., 1]
    u = (px.astype(jnp.float32) + ox) / w
    v = (py.astype(jnp.float32) + oy) / h

    aspect = w / h
    fov_scale = jnp.tan(camera.fov * jnp.float32(0.5) * jnp.pi / jnp.float32(180.0))
    cx = (u * 2.0 - 1.0) * aspect * fov_scale
    cy = (1.0 - v * 2.0) * fov_scale

    forward = camera.direction
    up = camera.up
    right = cross(forward, up)        # not normalised (ray.rs:43)
    true_up = cross(right, forward)   # not normalised (ray.rs:44)

    d = forward + right * cx[..., None] + true_up * cy[..., None]
    d = normalize(d)
    o = jnp.broadcast_to(camera.position, d.shape)
    return o, d


def pixel_grid(width: int, height: int):
    """Full-frame pixel coordinate grid, flattened to [H*W]."""
    py, px = jnp.mgrid[0:height, 0:width]
    return px.reshape(-1), py.reshape(-1)
