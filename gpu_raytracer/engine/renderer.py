"""Frame renderer: ray-batch pipeline over the whole image.

The replacement for the reference's dispatch machinery
(src/compute.rs:12-251): instead of per-tile × per-channel
compute dispatches writing 3 storage textures recombined by a fragment shader
(src/renderer.rs:778-818), one jitted function traces a ray batch and shades
all three wavelength channels at once (see ops/shading.py for why that is
exactly equivalent). The image is processed in ray chunks of at most
`config.ray_batch_size` rays; chunks reuse one compiled executable.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.camera_rays import generate_rays
from ..ops.linalg import normalize
from ..ops.shading import shade
from ..ops.trace import trace, occluded


def _shadow_mask(scene: Scene, hit, leaf_size: int, use_bvh: bool):
    """[N,L] visibility: 1 where the light is reachable from the hit point.

    Shadow-ray semantics per WavefrontRay::shadow_ray
    (shared/src/lib.rs:934-956): origin offset by t_min=0.001
    along the surface normal, t_max = distance to the light. The reference
    declared but never traced these (SURVEY.md gap); here they are real.
    """
    L = scene.lights
    N = hit.point.shape[0]
    nl = L.count
    origin = hit.point + hit.normal * 1e-3                     # [N,3]

    to_light = L.position[None, :, :] - hit.point[:, None, :]  # [N,L,3]
    dist = jnp.sqrt(jnp.sum(to_light * to_light, axis=-1))     # [N,L]
    pl_dir = to_light / dist[..., None]
    ldir = normalize(L.direction)[None, :, :]
    is_directional = (L.light_type[None, :] == 0)
    sdir = jnp.where(is_directional[..., None], -jnp.broadcast_to(ldir, to_light.shape), pl_dir)
    smax = jnp.where(is_directional, jnp.float32(3.0e38), dist - 1e-3)

    # light-major layout: each traversal packet serves ONE light over
    # consecutive (coherent) rays, keeping the shared cursor tight
    o = jnp.broadcast_to(origin[None, :, :], (nl, N, 3)).reshape(-1, 3)
    d = jnp.swapaxes(sdir, 0, 1).reshape(-1, 3)
    m = jnp.swapaxes(smax, 0, 1).reshape(-1)
    blocked = occluded(scene, o, d, m, leaf_size=leaf_size, use_bvh=use_bvh)
    mask = 1.0 - jnp.swapaxes(blocked.reshape(nl, N), 0, 1).astype(jnp.float32)
    # Only meaningful for actual hits; misses shade as sky anyway.
    return jnp.where(hit.hit[:, None], mask, 1.0)


@partial(jax.jit, static_argnames=("width", "height", "shadows", "use_bvh",
                                   "leaf_size", "sky", "trilinear"))
def render_chunk(scene: Scene, px: jnp.ndarray, py: jnp.ndarray,
                 width: int, height: int, shadows: bool = False,
                 use_bvh: bool = True, leaf_size: int = 4,
                 sky: tuple = (0.0, 0.0, 0.0),
                 trilinear: bool = False) -> jnp.ndarray:
    """Trace + shade one ray chunk → RGB [n,3]."""
    from ..ops.shading import hit_footprint

    orig, dirn = generate_rays(scene.camera, width, height, px, py)
    hit = trace(scene, orig, dirn, leaf_size=leaf_size, use_bvh=use_bvh)
    mask = _shadow_mask(scene, hit, leaf_size, use_bvh) if shadows else None
    # mip footprint (pyramid atlases only): per-lane nearest level
    lam = (hit_footprint(scene, hit, height)
           if scene.textures.n_levels > 1 else None)
    return shade(scene, hit, shadow_mask=mask, sky_color=sky, lam=lam,
                 trilinear=trilinear)


class Renderer:
    """Whole-frame renderer with chunked execution.

    The equivalent of ComputeRenderer's legacy path
    (src/compute.rs:10-251) minus the wgpu plumbing; the
    progressive tile scheduler lives in engine/progressive.py.
    """

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RaytracerConfig = DEFAULT_CONFIG,
                 shadows: bool = False, sky=(0.0, 0.0, 0.0)):
        self.scene = scene
        self.width = width
        self.height = height
        self.config = config
        self.shadows = shadows
        self.sky = tuple(float(x) for x in sky)
        self.use_bvh = scene.bvh.num_nodes > 1
        self._chunks = None  # cached device px/py chunks

    def set_camera(self, camera: Camera) -> None:
        self.scene = self.scene.with_camera(camera)

    def _chunk_size(self, n: int) -> int:
        """Rays per dispatch: the whole (tile-padded) frame up to
        config.ray_batch_size, never below one 1024-ray packet."""
        return min(self.config.ray_batch_size, max(n, 1024))

    def _pixel_order(self):
        """Tile-major pixel order (host arrays), padded to the chunk size."""
        from ..ops.packet_trace import tiled_pixel_order

        W, H = self.width, self.height
        # 64x64 tiles: consecutive rays share a tile (coherent traversal)
        px, py = tiled_pixel_order(W, H, tile=64)
        n = px.shape[0]
        chunk = self._chunk_size(n)
        pad = (-n) % chunk
        if pad:
            px = np.concatenate([px, np.full(pad, W - 1, np.int32)])
            py = np.concatenate([py, np.full(pad, H - 1, np.int32)])
        return px, py, chunk

    def _device_chunks(self):
        """Per-chunk device px/py arrays, uploaded once (the coordinates
        never change per resolution)."""
        if self._chunks is None:
            px, py, chunk = self._pixel_order()
            self._chunks = [
                (jnp.asarray(px[s:s + chunk]), jnp.asarray(py[s:s + chunk]))
                for s in range(0, px.shape[0], chunk)]
        return self._chunks

    def render_rays(self, px: jnp.ndarray, py: jnp.ndarray) -> jnp.ndarray:
        """Trace + shade one pixel batch → device RGB [n,3].

        The batch entry point for interactive schedulers (the Viewer feeds
        128x128-tile batches here — the reference redraws the same way, one
        dispatch per progressive tile, src/compute.rs:169-191).
        """
        return render_chunk(self.scene, px, py, self.width, self.height,
                            shadows=self.shadows, use_bvh=self.use_bvh,
                            leaf_size=self.config.bvh_leaf_size, sky=self.sky,
                            trilinear=self.config.texture_trilinear)

    def render_device(self) -> jnp.ndarray:
        """Render the full frame, leaving it on the device → f32 [Npad,3] in
        tile-major ray order (see `_pixel_order`); the pixel-order shuffle
        happens host-side after readback. Display readback is a separate
        step, as in the reference where compute writes storage textures and
        present samples them (src/renderer.rs:778-818)."""
        out = [self.render_rays(pxs, pys)
               for pxs, pys in self._device_chunks()]
        return jnp.concatenate(out) if len(out) > 1 else out[0]

    def _to_image(self, flat: np.ndarray) -> np.ndarray:
        px, py, _ = self._pixel_order()
        fb = np.zeros((self.height, self.width) + flat.shape[1:], flat.dtype)
        fb[py, px] = flat
        return fb

    def render(self) -> np.ndarray:
        """Full frame → host float32 [H,W,3] (single device→host readback,
        host-side pixel reorder)."""
        return self._to_image(np.asarray(self.render_device()))

    def render_u8(self, srgb: bool = True) -> np.ndarray:
        """Full frame quantised to display u8 ON DEVICE before readback —
        the present path. sRGB-encoded by default (the reference presents
        through an sRGB swapchain, src/renderer.rs:128-133; srgb=False is
        the raw linear rgba8 storage-texture write, shader/src/lib.rs:86-88)
        and a quarter of the f32 readback bytes."""
        from ..utils.image import linear_to_srgb
        fb = self.render_device()
        if srgb:
            fb = linear_to_srgb(fb, xp=jnp)
        u8 = (jnp.clip(fb, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
        return self._to_image(np.asarray(u8))


def render_image(scene: Scene, width: int, height: int, *,
                 shadows: bool = False, sky=(0.0, 0.0, 0.0),
                 config: RaytracerConfig = DEFAULT_CONFIG) -> np.ndarray:
    """One-shot convenience wrapper."""
    return Renderer(scene, width, height, config=config,
                    shadows=shadows, sky=sky).render()
