"""Punctual light model (struct-of-arrays).

Mirrors the reference `Light` struct (shared/src/lib.rs:70-82)
and its constructors (lib.rs:480-624): light_type 0=directional 1=point 2=spot,
f16-packed range (low 16 bits) and cone angles (inner|outer<<16).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.f16 import pack_f16_pair
from ..utils.pytree import pytree_dataclass

DIRECTIONAL, POINT, SPOT = 0, 1, 2


@pytree_dataclass
class Lights:
    position: jnp.ndarray            # [L,3] f32
    light_type: jnp.ndarray          # [L] u32
    color: jnp.ndarray               # [L,3] f32
    intensity: jnp.ndarray           # [L] f32
    direction: jnp.ndarray           # [L,3] f32
    range_packed: jnp.ndarray        # [L] u32: range f16 in low 16 bits
    cone_angles_packed: jnp.ndarray  # [L] u32: inner | outer<<16 as f16

    @property
    def count(self) -> int:
        return self.position.shape[0]


class LightBuilder:
    def __init__(self):
        self._rows: list[dict] = []

    def __len__(self) -> int:
        return len(self._rows)

    def _push(self, position, light_type, color, intensity, direction,
              range_, inner, outer) -> int:
        self._rows.append(dict(
            position=np.asarray(position, np.float32),
            light_type=np.uint32(light_type),
            color=np.asarray(color, np.float32),
            intensity=np.float32(intensity),
            direction=np.asarray(direction, np.float32),
            range_packed=pack_f16_pair(range_, 0.0),
            cone_angles_packed=pack_f16_pair(inner, outer),
        ))
        return len(self._rows) - 1

    def add_directional(self, direction, color, intensity) -> int:
        # Light::directional (shared/src/lib.rs:497-522)
        return self._push((0, 0, 0), DIRECTIONAL, color, intensity, direction,
                          float("inf"), 0.0, 0.0)

    def add_point(self, position, color, intensity, range_=float("inf")) -> int:
        # Light::point (lib.rs:525-550)
        return self._push(position, POINT, color, intensity, (0, 0, 0),
                          range_, 0.0, 0.0)

    def add_spot(self, position, direction, color, intensity,
                 range_=float("inf"), inner_cone_angle=0.0, outer_cone_angle=0.0) -> int:
        # Light::spot (lib.rs:553-586)
        return self._push(position, SPOT, color, intensity, direction,
                          range_, inner_cone_angle, outer_cone_angle)

    def build(self) -> Lights:
        if not self._rows:
            # Zero-light scene: keep one zero-intensity placeholder so shapes
            # stay non-empty; intensity 0 contributes nothing (the shading
            # contribution gate in lighting.rs:92 maps to a multiply by 0).
            self.add_point((0, 0, 0), (0, 0, 0), 0.0)
        cols = {k: np.stack([r[k] for r in self._rows]) for k in self._rows[0]}
        return Lights(**{k: jnp.asarray(v) for k, v in cols.items()})
