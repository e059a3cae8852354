"""Camera model + interactive controller.

Field semantics follow the reference `Camera` struct
(shared/src/lib.rs:37-45, defaults lib.rs:229-239) and the
mouse/keyboard controller (src/input.rs:49-97).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..config import RaytracerConfig, DEFAULT_CONFIG
from ..utils.pytree import pytree_dataclass, replace


@pytree_dataclass
class Camera:
    """Pinhole camera. All fields are arrays so camera motion never recompiles."""

    position: jnp.ndarray   # [3] f32
    direction: jnp.ndarray  # [3] f32 (unit)
    up: jnp.ndarray         # [3] f32 (unit)
    fov: jnp.ndarray        # [] f32, vertical FOV in degrees

    @staticmethod
    def default() -> "Camera":
        # Camera::new() defaults: pos (0,0,5), dir -Z, up +Y, fov 45°
        # (shared/src/lib.rs:231-238)
        return Camera(
            position=jnp.asarray([0.0, 0.0, 5.0], jnp.float32),
            direction=jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
            up=jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
            fov=jnp.asarray(45.0, jnp.float32),
        )

    @staticmethod
    def create(position, direction, up=(0.0, 1.0, 0.0), fov=45.0) -> "Camera":
        # idempotent f64 normalisation (same rule as prepare_scene /
        # gltf._normalize): an already-unit direction passes through
        # bit-unchanged, so a scene and its GLB round trip build the
        # identical camera
        d64 = np.asarray(direction, np.float64)
        n = float(np.linalg.norm(d64))
        if n == 0.0 or abs(n - 1.0) <= 1e-6:
            d = np.asarray(direction, np.float32)
        else:
            d = (d64 / n).astype(np.float32)
        return Camera(
            position=jnp.asarray(position, jnp.float32),
            direction=jnp.asarray(d, jnp.float32),
            up=jnp.asarray(up, jnp.float32),
            fov=jnp.asarray(fov, jnp.float32),
        )


class CameraController:
    """Host-side interactive camera: WASD movement + mouse-drag look.

    Reproduces CameraController semantics (src/input.rs:49-97):
    yaw = rotation about +Y applied on the XZ components, pitch = clamped
    adjustment of the Y component followed by renormalisation; movement along
    ``direction`` and ``right = direction × up``.
    """

    def __init__(self, camera: Camera, config: RaytracerConfig = DEFAULT_CONFIG):
        self.position = np.asarray(camera.position, np.float32).copy()
        self.direction = np.asarray(camera.direction, np.float32).copy()
        self.up = np.asarray(camera.up, np.float32).copy()
        self.fov = float(camera.fov)
        self.config = config

    def rotate(self, dx: float, dy: float) -> None:
        """Mouse-drag rotation (input.rs:49-76)."""
        sens = self.config.camera_rotate_sensitivity
        yaw = -dx * sens
        pitch = -dy * sens

        # Yaw: rotate direction around the +Y axis on XZ.
        cos_y, sin_y = math.cos(yaw), math.sin(yaw)
        x, y, z = self.direction
        self.direction = np.asarray(
            [x * cos_y - z * sin_y, y, x * sin_y + z * cos_y], np.float32
        )

        # Pitch: adjust Y, clamp, renormalise.
        clamp = self.config.camera_pitch_clamp
        new_y = float(np.clip(self.direction[1] + pitch, -clamp, clamp))
        self.direction[1] = new_y
        self.direction /= np.linalg.norm(self.direction)

    def move(self, forward: float = 0.0, strafe: float = 0.0) -> None:
        """WASD movement (input.rs:79-97): W/S = ±direction, A/D = ∓right."""
        speed = self.config.camera_move_speed
        right = np.cross(self.direction, self.up)
        n = np.linalg.norm(right)
        if n > 0:
            right = right / n
        self.position = (
            self.position + self.direction * (forward * speed) + right * (strafe * speed)
        ).astype(np.float32)

    def camera(self) -> Camera:
        return Camera(
            position=jnp.asarray(self.position),
            direction=jnp.asarray(self.direction),
            up=jnp.asarray(self.up),
            fov=jnp.asarray(self.fov, jnp.float32),
        )
