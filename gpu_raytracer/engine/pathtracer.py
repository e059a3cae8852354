"""Progressive multi-bounce path tracing with an accumulation buffer.

The full realisation of the reference's wavefront dispatcher
(src/compute.rs:365-553): per frame, one sample per pixel is
traced through the wavefront pool (ops/wavefront.py) and accumulated into a
persistent HBM framebuffer; successive frames converge the image (BASELINE
config 3: progressive 64 spp). Spectral mode keeps the reference's
3-wavelength dispersion semantics (compute.rs:432-441) via split-on-glass
rays (ops/wavefront.py RGB_CHANNEL): one pool per step, full RGB throughput
until a ray meets dispersive glass, then an unbiased 3x one-hot collapse to
a single wavelength — 3x fewer traversals than the reference's 3-dispatch
scheme for everything the glass doesn't touch. RGB mode never splits.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.scene import Scene
from ..ops.wavefront import camera_wavefront_rays, path_trace_pool
from .perf import PerformanceState, ProgressiveTiming, Timer


from functools import partial


def _sample_chunk(scene: Scene, px, py, width, height, key, channel,
                  max_depth, rr_start, shadows, leaf_size, use_bvh, jitter,
                  live=None, spp=1, qmc=False, sample_base=0, qmc_seed=0,
                  qmc_antialias=False, qmc_pid_base=0, tex_lod_bias=0.0):
    """Trace `spp` independent samples of every pixel in ONE wavefront pool.

    The samples are laid out chunk-major (sample s of pixel i at lane
    s*C + i) and summed back to [C, 3]. One big pool amortises launch and
    sort overhead over spp, and because same-pixel samples bounce into
    similar hemispheres, the coherence sort packs them into the same
    traversal packets — bounce packets get spp-times denser in direction
    space than spp separate 1-sample pools."""
    if spp > 1:
        px = jnp.tile(px, spp)
        py = jnp.tile(py, spp)
        jitter = (None if jitter is None
                  else jax.random.uniform(jax.random.fold_in(key, 0x5a),
                                          (px.shape[0], 2)))
        live = None if live is None else jnp.tile(live, spp)
    if qmc and qmc_antialias:
        # Pixel identity for the QMC stream: chunk base + in-chunk lane
        # (stable across steps; arithmetic from the lane index — no
        # gather; see ops/wavefront._pool_uniforms, which derives the
        # SAME identity from orig_lane inside the pool).
        from ..ops.sampler import qmc_jitter
        n = px.shape[0]
        lane = jnp.arange(n, dtype=jnp.int32)
        pid = (jnp.asarray(qmc_pid_base).astype(jnp.uint32)
               + (lane % (n // spp)).astype(jnp.uint32))
        s_idx = (jnp.asarray(sample_base).astype(jnp.uint32)
                 + (lane // (n // spp)).astype(jnp.uint32))
        jitter = qmc_jitter(pid, s_idx, qmc_seed)
    rays = camera_wavefront_rays(scene.camera, width, height, px, py, channel,
                                 jitter=jitter)
    if live is not None:  # tail-chunk padding lanes: excluded from counts
        from ..utils.pytree import replace
        rays = replace(rays, active=rays.active & live)
    contrib, counts = path_trace_pool(scene, rays, key, max_depth=max_depth,
                                      rr_start=rr_start, shadows=shadows,
                                      leaf_size=leaf_size, use_bvh=use_bvh,
                                      qmc=qmc, qmc_pid_base=qmc_pid_base,
                                      sample_base=sample_base,
                                      qmc_seed=qmc_seed, qmc_spp=spp,
                                      tex_lod_bias=tex_lod_bias)
    if spp > 1:
        contrib = contrib.reshape(spp, -1, 3).sum(axis=0)
    return contrib, counts


@partial(jax.jit,
         static_argnames=("width", "height", "channel", "max_depth",
                          "rr_start", "shadows", "leaf_size", "use_bvh",
                          "antialias", "spp", "qmc", "tex_lod_bias"),
         donate_argnums=(1,))
def _step_whole_frame(scene: Scene, accum, key, step_idx, px, py, *,
                      width: int, height: int, channel: int, max_depth: int,
                      rr_start: int, shadows: bool, leaf_size: int,
                      use_bvh: bool, antialias: bool, spp: int,
                      qmc: bool = False, qmc_seed=0,
                      tex_lod_bias: float = 0.0):
    """The ENTIRE progressive step as ONE compiled program: fold_in →
    jitter → camera raygen → pool trace → accumulate in a single dispatch,
    with the accumulator donated and updated in place. `step_idx` is a
    traced scalar so successive samples share the compiled executable."""
    skey = jax.random.fold_in(key, step_idx)
    jit_key = jax.random.fold_in(skey, 0)  # chunk offset 0 (whole frame)
    jitter = (jax.random.uniform(jit_key, (px.shape[0], 2))
              if antialias and not qmc else None)
    contrib, counts = _sample_chunk(scene, px, py, width, height, jit_key,
                                    channel, max_depth, rr_start, shadows,
                                    leaf_size, use_bvh, jitter, None, spp=spp,
                                    qmc=qmc, sample_base=step_idx,
                                    qmc_seed=qmc_seed,
                                    qmc_antialias=antialias,
                                    tex_lod_bias=tex_lod_bias)
    return accum + contrib, counts


@partial(jax.jit,
         static_argnames=("width", "height", "channel", "max_depth",
                          "rr_start", "shadows", "leaf_size", "use_bvh",
                          "antialias", "spp", "qmc", "tex_lod_bias",
                          "stride"),
         donate_argnums=(1, 2))
def _step_subset(scene: Scene, accum, counts, key, step_idx, px_s, py_s,
                 idx, pid_base, *, width: int, height: int, channel: int,
                 max_depth: int, rr_start: int, shadows: bool,
                 leaf_size: int, use_bvh: bool, antialias: bool, spp: int,
                 qmc: bool = False, qmc_seed=0, tex_lod_bias: float = 0.0,
                 stride=None):
    """One progressive step over a pixel SUBSET (interleaved fly-through
    sampling): trace the coset's rays as one pool and accumulate the
    contribution + per-pixel sample counts into the full-frame
    accumulator. The temporal warp + denoiser reconstruct the untouched
    pixels from history, so a moving frame pays 1/m of the wavefront
    cost.

    `stride` = (a, b, ka, kb): when the frame is whole 64-px tiles, coset
    (x % a == ka, y % b == kb) is the REGULAR pattern
    accum[tile, kb::b, ka::a] of the [tiles, 64, 64] view, so the update
    is a static strided-slice add — no scatter. `idx` stays the fallback
    for frames with partial tiles."""
    skey = jax.random.fold_in(key, step_idx)
    jit_key = jax.random.fold_in(skey, pid_base)
    jitter = (jax.random.uniform(jit_key, (px_s.shape[0], 2))
              if antialias and not qmc else None)
    contrib, tallies = _sample_chunk(
        scene, px_s, py_s, width, height, jit_key, channel, max_depth,
        rr_start, shadows, leaf_size, use_bvh, jitter, None, spp=spp,
        qmc=qmc, sample_base=step_idx, qmc_seed=qmc_seed,
        qmc_antialias=antialias, qmc_pid_base=pid_base,
        tex_lod_bias=tex_lod_bias)
    if stride is not None:
        a, b, ka, kb = stride
        acc4 = accum.reshape(-1, 64, 64, 3)
        sub = (acc4[:, kb::b, ka::a, :]
               + contrib.reshape(acc4.shape[0], 64 // b, 64 // a, 3))
        accum = acc4.at[:, kb::b, ka::a, :].set(sub).reshape(-1, 3)
        cnt3 = counts.reshape(-1, 64, 64)
        counts = cnt3.at[:, kb::b, ka::a].add(
            jnp.float32(spp)).reshape(-1)
    else:
        accum = accum.at[idx].add(contrib, indices_are_sorted=True,
                                  unique_indices=True)
        counts = counts.at[idx].add(jnp.float32(spp),
                                    indices_are_sorted=True,
                                    unique_indices=True)
    return accum, counts, tallies


@partial(jax.jit,
         static_argnames=("width", "height", "channel", "max_depth",
                          "rr_start", "shadows", "leaf_size", "use_bvh",
                          "antialias", "spp", "qmc", "tex_lod_bias",
                          "stride", "iterations", "to_u8"),
         donate_argnums=(2,))
def _fly_frame(scene_new: Scene, old_cam, accum, n_tot, inv_perm, px, py,
               clamp, wkey, old_depth_tile, key, step_idx, px_s, py_s,
               pid_base, *, width: int, height: int, channel: int,
               max_depth: int, rr_start: int, shadows: bool,
               leaf_size: int, use_bvh: bool, antialias: bool, spp: int,
               qmc: bool, qmc_seed=0, tex_lod_bias: float = 0.0,
               stride=None, iterations: int = 4, to_u8: bool = False):
    """One MOVING path-trace frame as a single compiled program: temporal
    warp (reproject history into the new camera) + interleaved-coset
    sample step + G-buffer reorder + à-trous denoise + display encode.
    One dispatch lets XLA overlap the independent warp and pool traces.
    Returns (accum', counts',
    gbuf_tile, frame [H,W,3] f32-or-u8, per-depth tallies)."""
    from ..ops.denoise import atrous_denoise

    accum0, n0, gbuf_tile = _warp_history(
        scene_new, old_cam, accum, n_tot, inv_perm, px, py, clamp, wkey,
        None, old_depth_tile, width=width, height=height,
        leaf_size=leaf_size, use_bvh=use_bvh)

    skey = jax.random.fold_in(key, step_idx)
    jit_key = jax.random.fold_in(skey, pid_base)
    jitter = (jax.random.uniform(jit_key, (px_s.shape[0], 2))
              if antialias and not qmc else None)
    contrib, tallies = _sample_chunk(
        scene_new, px_s, py_s, width, height, jit_key, channel, max_depth,
        rr_start, shadows, leaf_size, use_bvh, jitter, None, spp=spp,
        qmc=qmc, sample_base=step_idx, qmc_seed=qmc_seed,
        qmc_antialias=antialias, qmc_pid_base=pid_base,
        tex_lod_bias=tex_lod_bias)
    a, b, ka, kb = stride
    acc4 = accum0.reshape(-1, 64, 64, 3)
    sub = (acc4[:, kb::b, ka::a, :]
           + contrib.reshape(acc4.shape[0], 64 // b, 64 // a, 3))
    accum1 = acc4.at[:, kb::b, ka::a, :].set(sub).reshape(-1, 3)
    counts = n0.reshape(-1, 64, 64).at[:, kb::b, ka::a].add(
        jnp.float32(spp)).reshape(-1)

    normal, depth, albedo = _gbuf_rowmajor(gbuf_tile, inv_perm,
                                           width=width, height=height)
    inv_n = (1.0 / jnp.maximum(counts, 1.0))[:, None]
    img = (accum1 * inv_n)[inv_perm].reshape(height, width, 3)
    out = atrous_denoise(img, normal, depth, albedo, iterations=iterations)
    if to_u8:
        from ..utils.image import linear_to_srgb
        out = (jnp.clip(linear_to_srgb(out, xp=jnp), 0.0, 1.0) * 255.0
               + 0.5).astype(jnp.uint8)
    return accum1, counts, gbuf_tile, out, tallies


@partial(jax.jit, static_argnames=("width", "height", "leaf_size",
                                   "use_bvh"))
def _gbuffer(scene: Scene, *, width: int, height: int, leaf_size: int,
             use_bvh: bool):
    """Primary-hit G-buffer for the denoiser (see PathTracer.gbuffer)."""
    from ..ops.camera_rays import generate_rays, pixel_grid
    from ..ops.shading import material_textures
    from ..ops.trace import trace

    px, py = pixel_grid(width, height)
    o, d = generate_rays(scene.camera, width, height, px, py)
    hit = trace(scene, o, d, leaf_size=leaf_size, use_bvh=use_bvh)
    mid = jnp.clip(hit.material_id, 0, None)
    albedo, _, _, _ = material_textures(scene, mid, hit.uv)
    albedo = jnp.where(hit.hit[:, None], albedo, 1.0)
    return (hit.normal.reshape(height, width, 3),
            hit.t.reshape(height, width),
            albedo.reshape(height, width, 3))


@partial(jax.jit, static_argnames=("width", "height", "leaf_size",
                                   "use_bvh"))
def _warp_history(scene_new: Scene, old_cam, accum, n_tot, inv_perm, px, py,
                  clamp, jitter_key, old_depth, old_depth_tile, *,
                  width: int, height: int, leaf_size: int, use_bvh: bool):
    """Temporal reprojection: seed a NEW camera's accumulator with the OLD
    accumulation, as ONE compiled program → (accum0 [C,3], count0 [C],
    gbuf_tile) where gbuf_tile = (normal [C,3], depth [C], albedo [C,3])
    is the NEW camera's primary G-buffer in ACCUMULATOR (tile) order —
    the warp already traced those rays, so the caller caches it for the
    denoiser (whose single packed reorder gather absorbs the tile→row-
    major permute). Feeding the depth
    plane back as `old_depth_tile` on the NEXT warp makes every
    steady-state fly-frame a single primary trace AND lets the history
    fetch pack the old depth into its one [C,5] row gather.

    old_depth_tile: the OLD camera's primary depth [C] in tile order from
    the previous warp (preferred — zero extra gathers). old_depth: the
    same depth as the row-major [H,W] G-buffer plane (used when only the
    cached G-buffer exists; costs one extra [C] gather to reorder). Pass
    both as None on the first warp after a restart and the program traces
    the old depth itself (two traces instead of one).

    For every new pixel: trace its primary hit, reproject the hit point
    into the old camera (the basis forward/right/true_up of
    ops/camera_rays.generate_rays is mutually orthogonal even
    unnormalised, so the inverse projection is three dot products),
    fetch the old mean + old primary depth at the nearest old pixel, and
    accept the history only where the old depth agrees with the point's
    distance to the old camera (2% tolerance) — sky pixels reproject by
    DIRECTION and require the old pixel to be a miss too. Accepted
    history enters the accumulator as `mean * n0` with
    n0 = min(old sample count, clamp): the clamp bounds the bias that
    view-dependent shading (specular moved with the camera) can carry
    into the new accumulation; disocclusions start from zero cleanly.

    The reference restarts its progressive accumulation from scratch on
    every camera move (trigger_recompute, src/
    renderer.rs); reprojection is an extension that keeps the
    fly-through converged.
    """
    from ..ops.camera_rays import generate_rays
    from ..ops.linalg import cross, dot
    from ..ops.shading import material_textures
    from ..ops.trace import trace

    H, W = height, width

    if old_depth_tile is not None:
        depth_tile = old_depth_tile
    elif old_depth is not None:
        # only the row-major G-buffer plane exists (e.g. gbuffer() filled
        # the cache outside a warp) — reorder it to tile order once
        depth_tile = old_depth.reshape(-1)[py * W + px]
    else:
        # old primary depth (camera rays under the OLD camera, same
        # geometry) — only needed when the previous frame left no G-buffer.
        # Traced directly in TILE order: these rays share traversal packets
        # with the accumulator layout anyway, and tile order is what the
        # history fetch needs.
        o0, d0 = generate_rays(old_cam, W, H, px, py)
        hit0 = trace(scene_new, o0, d0, leaf_size=leaf_size, use_bvh=use_bvh)
        depth_tile = hit0.t                       # MISS_T on miss

    # new primary hits (tile order, matching the accumulator rows)
    o, d = generate_rays(scene_new.camera, W, H, px, py)
    hit = trace(scene_new, o, d, leaf_size=leaf_size, use_bvh=use_bvh)
    # the NEW camera's G-buffer falls out of this trace for free — kept
    # in TILE order (no permute here at all; the denoiser's packed
    # reorder or PathTracer.gbuffer() materialises row-major on demand)
    g_mid = jnp.clip(hit.material_id, 0, None)
    g_alb, _, _, _ = material_textures(scene_new, g_mid, hit.uv)
    g_alb = jnp.where(hit.hit[:, None], g_alb, 1.0)
    gbuf_tile = (hit.normal, hit.t, g_alb)
    point = o + d * hit.t[:, None]
    V = jnp.where(hit.hit[:, None], point - old_cam.position[None, :], d)

    fwd = old_cam.direction
    right = cross(fwd, old_cam.up)
    true_up = cross(right, fwd)
    af = dot(V, fwd[None, :]) / jnp.sum(fwd * fwd)
    ar = dot(V, right[None, :]) / jnp.sum(right * right)
    au = dot(V, true_up[None, :]) / jnp.sum(true_up * true_up)
    front = af > 1e-6
    af_s = jnp.where(front, af, 1.0)
    aspect = jnp.float32(W) / jnp.float32(H)
    fs = jnp.tan(old_cam.fov * jnp.float32(0.5) * jnp.pi / 180.0)
    u = ((ar / af_s) / (aspect * fs) + 1.0) * 0.5
    v = (1.0 - (au / af_s) / fs) * 0.5
    # stochastic-bilinear history fetch: jitter the projected position by
    # ±0.5 px before rounding — ONE gather whose expectation over warps
    # is the bilinear interpolation (sub-pixel pans stop snapping to the
    # nearest old pixel), and the depth test validates the ACTUAL
    # neighbour fetched, so edges reject exactly as in the nearest case
    jxy = jax.random.uniform(jitter_key, (u.shape[0], 2)) - 0.5
    ix = jnp.round(u * W - 0.5 + jxy[:, 0]).astype(jnp.int32)
    iy = jnp.round(v * H - 0.5 + jxy[:, 1]).astype(jnp.int32)
    inb = front & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = (jnp.clip(iy, 0, H - 1) * W + jnp.clip(ix, 0, W - 1))

    # history fetch: the accumulator lives in TILE order, the projected
    # position is a ROW-MAJOR index — compose the two permutations
    # (accum_rm[flat] == accum[inv_perm[flat]]) so the whole fetch is one
    # cheap int gather + one packed [C,5] row gather (mean, count AND old
    # depth — the same relation holds per column), instead of reordering
    # the full accumulation to row-major first or paying a separate
    # depth gather
    src = inv_perm[flat]
    hist = jnp.concatenate([accum, n_tot[:, None], depth_tile[:, None]],
                           axis=1)[src]
    n_f = hist[:, 3]
    mean_f = hist[:, 0:3] / jnp.maximum(n_f, 1.0)[:, None]
    depth_f = hist[:, 4]
    dist = jnp.sqrt(jnp.sum(V * V, axis=-1))
    ok_hit = hit.hit & (jnp.abs(depth_f - dist) <= 0.02 * dist + 1e-3)
    ok_miss = (~hit.hit) & (depth_f > 1e30)
    valid = inb & (ok_hit | ok_miss)
    n0 = jnp.where(valid, jnp.minimum(n_f, clamp), 0.0)
    return mean_f * n0[:, None], n0, gbuf_tile


@partial(jax.jit, static_argnames=("width", "height", "iterations",
                                   "to_u8"))
def _denoise_whole(accum, inv_perm, inv_samples, gbuf, *,
                   width: int, height: int, iterations: int,
                   to_u8: bool = False, **kw):
    """Accumulator reorder + à-trous filter as ONE compiled program.
    gbuf = (normal, depth, albedo) from PathTracer.gbuffer() — a
    device-cached trace, so repeated denoises of a converging frame pay
    zero primary traces. to_u8=True emits the display-ready [H,W,3] u8
    frame (a quarter of the f32 readback bytes)."""
    from ..ops.denoise import atrous_denoise

    img = (accum * inv_samples)[inv_perm].reshape(height, width, 3)
    normal, depth, albedo = gbuf
    out = atrous_denoise(img, normal, depth, albedo,
                         iterations=iterations, **kw)
    if to_u8:
        from ..utils.image import linear_to_srgb
        out = (jnp.clip(linear_to_srgb(out, xp=jnp), 0.0, 1.0) * 255.0
               + 0.5).astype(jnp.uint8)
    return out


@partial(jax.jit, static_argnames=("width", "height"))
def _gbuf_rowmajor(gbuf_tile, inv_perm, *, width: int, height: int):
    """Materialise the row-major (normal [H,W,3], depth [H,W],
    albedo [H,W,3]) planes from a tile-ordered G-buffer — one packed
    [C,7] gather, paid lazily on the first gbuffer() consumer (and then
    cached), so warp-only frames — e.g. the temporal Viewer with the
    denoiser toggled off — never pay it at all."""
    normal, depth, albedo = gbuf_tile
    pack = jnp.concatenate([normal, depth[:, None], albedo],
                           axis=1)[inv_perm]
    return (pack[:, 0:3].reshape(height, width, 3),
            pack[:, 3].reshape(height, width),
            pack[:, 4:7].reshape(height, width, 3))


@partial(jax.jit, static_argnames=("srgb",))
def _to_u8(img, srgb: bool = True):
    """Device-side display quantisation ([H,W,3] f32 linear 0..1 → u8),
    sRGB-encoded by default — the swapchain boundary (utils/image.py
    header). srgb=False gives the raw linear quantise (data paths)."""
    if srgb:
        from ..utils.image import linear_to_srgb
        img = linear_to_srgb(img, xp=jnp)
    return (jnp.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("width", "height", "to_u8"))
def _image_whole(accum, inv_perm, inv_samples, *, width: int, height: int,
                 to_u8: bool = False):
    """Accumulator → device [H,W,3] frame (mean, row-major), optionally u8."""
    out = (accum * inv_samples)[inv_perm].reshape(height, width, 3)
    if to_u8:
        from ..utils.image import linear_to_srgb
        out = (jnp.clip(linear_to_srgb(out, xp=jnp), 0.0, 1.0) * 255.0
               + 0.5).astype(jnp.uint8)
    return out


class PathTracer:
    """Progressive accumulator: call step() per frame, image() for the mean."""

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RaytracerConfig = DEFAULT_CONFIG,
                 spectral: bool = True, shadows: bool = True,
                 antialias: bool = True, seed: int = 0,
                 samples_per_step: int = 1, sampler: str = "qmc"):
        self.scene = scene
        self.width = width
        self.height = height
        self.config = config
        self.spectral = spectral
        self.shadows = shadows
        self.antialias = antialias
        # Samples traced per step() in ONE pooled wavefront (spp-times
        # larger pool; see _sample_chunk). >1 amortises sort/launch overhead
        # and tightens bounce-packet coherence.
        self.samples_per_step = max(int(samples_per_step), 1)
        # "qmc" (default): Cranley-Patterson-rotated lattice sampling
        # (ops/sampler.py) — lower MSE per spp than independent sampling,
        # same cost, unbiased. "rng": the independent threefry stream
        # (the reference's per-pixel LCG model, wavefront.rs:44-72).
        if sampler not in ("qmc", "rng"):
            raise ValueError(f"sampler must be 'qmc' or 'rng', got {sampler!r}")
        self.sampler = sampler
        self.qmc = sampler == "qmc"
        self._qmc_seed = jnp.uint32(seed & 0xFFFFFFFF)
        self.key = jax.random.PRNGKey(seed)
        self.use_bvh = scene.bvh.num_nodes > 1
        self.accum = jnp.zeros((height * width, 3), jnp.float32)
        self.samples = 0
        # temporal reprojection (set_camera(temporal=True)): per-pixel
        # history weights seeded by _warp_history, None when uniform
        self._count_base = None
        self.temporal_clamp = 8.0
        self.perf = PerformanceState(config.performance_stats_interval,
                                     verbose=False)
        # Tile-major pixel order: rays in a traversal packet share a 64x64
        # tile, keeping primary-bounce packets coherent (same trick as
        # engine/renderer.py) — unlike the renderer, WITHOUT clamped padding
        # (each accumulator row must be a distinct pixel's running sum).
        # `render` reorders on the host when assembling the image.
        T = 64
        pxs, pys = [], []
        for ty in range(0, height, T):
            for tx in range(0, width, T):
                gy, gx = np.mgrid[ty:min(ty + T, height),
                                  tx:min(tx + T, width)]
                pxs.append(gx.reshape(-1))
                pys.append(gy.reshape(-1))
        px = np.concatenate(pxs).astype(np.int32)
        py = np.concatenate(pys).astype(np.int32)
        self._px_host = px
        self._py_host = py
        self._px = jnp.asarray(px)
        self._py = jnp.asarray(py)
        self._last_counts = None
        # primary-hit G-buffer cache — valid for the CURRENT scene+camera;
        # reset()/set_camera refresh it. _gbuf_tile: accumulator (tile)
        # order (normal [C,3], depth [C], albedo [C,3]), the warp's native
        # output — its depth feeds the next warp's packed history gather
        # and the denoiser reorders it inside its own single gather.
        # _gbuf: row-major planes, materialised lazily by gbuffer().
        self._gbuf = None
        self._gbuf_tile = None

    def set_camera(self, camera, temporal: bool = False) -> None:
        """Move the camera. temporal=False restarts accumulation (the
        reference's trigger_recompute); temporal=True reprojects the
        current accumulation into the new view (_warp_history) so the
        fly-through keeps its converged history — depth-validated, with
        per-pixel history clamped to `temporal_clamp` samples."""
        if temporal and self._total_samples() > 0:
            old_cam = self.scene.camera
            self.scene = self.scene.with_camera(camera)
            self._ensure_inv_perm()
            self._warp_no = getattr(self, "_warp_no", 0) + 1
            jkey = jax.random.fold_in(jax.random.fold_in(self.key, 0x3A97),
                                      self._warp_no)
            # the previous frame's G-buffer depth IS the old-camera primary
            # depth the warp validates against — feeding it back makes the
            # steady-state warp a single primary trace
            old_depth = self._gbuf[1] if self._gbuf is not None else None
            old_depth_tile = (self._gbuf_tile[1]
                              if self._gbuf_tile is not None else None)
            (self.accum, self._count_base,
             self._gbuf_tile) = _warp_history(
                self.scene, old_cam, self.accum, self._n_total(),
                self._inv_perm, self._px, self._py,
                jnp.float32(self.temporal_clamp), jkey, old_depth,
                old_depth_tile,
                width=self.width, height=self.height,
                leaf_size=self.config.bvh_leaf_size, use_bvh=self.use_bvh)
            self._gbuf = None   # row-major planes now stale (old camera)
            self.samples = 0
            return
        self.scene = self.scene.with_camera(camera)
        self.reset()

    def _total_samples(self) -> int:
        return self.samples + (0 if self._count_base is None else 1)

    def _n_total(self) -> jnp.ndarray:
        """Per-pixel total sample weight [C] f32 (history + new)."""
        n = jnp.full((self.accum.shape[0],), jnp.float32(self.samples))
        if self._count_base is not None:
            n = n + self._count_base
        return n

    def _ensure_inv_perm(self) -> None:
        if not hasattr(self, "_inv_perm"):
            # tile-ray accumulator order -> row-major
            order = (self._py_host.astype(np.int64) * self.width
                     + self._px_host)
            inv = np.empty(order.size, np.int32)
            inv[order] = np.arange(order.size, dtype=np.int32)
            self._inv_perm = jnp.asarray(inv)

    def reset(self) -> None:
        """Restart accumulation (the reference's trigger_recompute)."""
        self.accum = jnp.zeros_like(self.accum)
        self.samples = 0
        self._count_base = None
        self._gbuf = None    # camera and/or scene changed
        self._gbuf_tile = None

    def _whole_frame_ok(self) -> bool:
        """True when the frame goes through in ONE pool (it fits
        config.ray_batch_size): _chunks then yields a single whole-frame
        chunk, and step() and fly_frame() use their single-dispatch
        programs."""
        return self.width * self.height <= self.config.ray_batch_size

    def _chunks(self):
        n = self.width * self.height
        c = min(self.config.ray_batch_size, n)
        for s in range(0, n, c):
            e = min(s + c, n)
            if e - s < c:  # pad tail chunk to the compiled shape
                idx = jnp.concatenate([jnp.arange(s, e),
                                       jnp.zeros(c - (e - s), jnp.int32)])
            else:
                idx = jnp.arange(s, e)
            yield s, e, idx

    def step(self) -> None:
        """Trace one sample per pixel and accumulate."""
        self._last_counts = None  # per-step device tallies (lazy fetch)
        self._last_seed = self.samples  # the fold used for THIS step
        md = self.config.max_bounce_depth
        rr = self.config.russian_roulette_start
        ls = self.config.bvh_leaf_size
        from ..ops.wavefront import RGB_CHANNEL

        chan = RGB_CHANNEL if self.spectral else 1
        if self._whole_frame_ok():
            # single compiled dispatch per sample; accum donated in place
            self.accum, self._last_counts = _step_whole_frame(
                self.scene, self.accum, self.key,
                jnp.int32(self.samples), self._px, self._py,
                width=self.width, height=self.height, channel=chan,
                max_depth=md, rr_start=rr, shadows=self.shadows,
                leaf_size=ls, use_bvh=self.use_bvh,
                antialias=self.antialias, spp=self.samples_per_step,
                qmc=self.qmc, qmc_seed=self._qmc_seed,
                tex_lod_bias=self.config.bounce_lod_bias)
            self.samples += self.samples_per_step
            self.perf.update_frame_count()
            return
        skey = jax.random.fold_in(self.key, self.samples)
        updates = []
        for s, e, idx in self._chunks():
            px = self._px[idx]
            py = self._py[idx]
            live = (jnp.arange(idx.shape[0]) < (e - s)
                    if e - s < idx.shape[0] else None)
            jit_key = jax.random.fold_in(skey, s)
            jitter = (jax.random.uniform(jit_key, (idx.shape[0], 2))
                      if self.antialias and not self.qmc else None)
            # Spectral mode: ONE pool of RGB_CHANNEL rays that split to a
            # single wavelength only at dispersive glass (ops/wavefront.py
            # RGB_CHANNEL) — same dispersion as the reference's 3-dispatch
            # scheme (src/compute.rs:432-441) at a third of the traversals.
            # Non-spectral: channel 1 (green = zero dispersion offset) and
            # glass refracts without splitting.
            from ..ops.wavefront import RGB_CHANNEL

            chan = RGB_CHANNEL if self.spectral else 1
            contrib, counts = _sample_chunk(self.scene, px, py, self.width,
                                            self.height, jit_key, chan, md,
                                            rr, self.shadows, ls,
                                            self.use_bvh, jitter, live,
                                            spp=self.samples_per_step,
                                            qmc=self.qmc,
                                            sample_base=jnp.int32(
                                                self.samples),
                                            qmc_seed=self._qmc_seed,
                                            qmc_antialias=self.antialias,
                                            qmc_pid_base=jnp.int32(s),
                                            tex_lod_bias=(
                                                self.config.bounce_lod_bias))
            updates.append((s, e, contrib))
            self._last_counts = (counts if self._last_counts is None
                                 else self._last_counts + counts)
        for s, e, contrib in updates:
            self.accum = jax.lax.dynamic_update_slice(
                self.accum, self.accum[s:e] + contrib[: e - s], (s, 0))
        self.samples += self.samples_per_step
        self.perf.update_frame_count()

    def _cosets(self, m: int):
        """Interleave cosets for step_interleaved: per phase k, the
        accumulator rows + pixel coords of pixels with
        (x mod a, y mod b) == coset k, where (a, b) = (2,1)/(2,2)/(4,2)
        for m = 2/4/8. Rows are sorted (a filter of increasing indices)."""
        cache = getattr(self, "_coset_cache", None)
        if cache is None:
            cache = self._coset_cache = {}
        if m not in cache:
            a, b = {2: (2, 1), 4: (2, 2), 8: (4, 2)}[m]
            px, py = self._px_host, self._py_host
            sets = []
            for k in range(m):
                ka, kb = k % a, k // a
                idx = np.where((px % a == ka) & (py % b == kb))[0]
                sets.append((jnp.asarray(idx.astype(np.int32)),
                             jnp.asarray(px[idx]), jnp.asarray(py[idx])))
            cache[m] = sets
        return cache[m]

    def interleave_ok(self, m: int) -> bool:
        """step_interleaved(m) runs iff the frame divides the interleave
        grid and the coset fits one pool dispatch."""
        a, b = {2: (2, 1), 4: (2, 2), 8: (4, 2)}.get(m, (0, 0))
        n = self.width * self.height
        if a == 0 or self.width % a or self.height % b:
            return False
        return (n // m) <= self.config.ray_batch_size

    def step_interleaved(self, m: int = 4) -> None:
        """Trace one sample for 1/m of the pixels (rotating interleaved
        coset) and accumulate — the moving-frame fly-through step: the
        temporal warp carries history into every pixel and the à-trous
        reconstruction fills the cosets not sampled this frame, so the
        wavefront cost drops ~m-fold while the image keeps full-resolution
        geometry edges (the G-buffer stays full-res). Falls back to the
        full step when the frame doesn't divide the interleave. Per-pixel
        sample bookkeeping moves into the _count_base vector."""
        if m <= 1 or not self.interleave_ok(m):
            self.step()
            return
        self._last_counts = None
        # fold the scalar sample count into the per-pixel vector once
        n_vec = self._n_total()
        if self._count_base is None or self.samples:
            self._count_base = n_vec
            self.samples = 0
        # monotone per-call stream index for QMC/rng (self.samples no
        # longer advances: it is scalar bookkeeping, a coset step is not a
        # full frame sample)
        self._il_step = getattr(self, "_il_step", 0) + 1
        phase = getattr(self, "_il_phase", -1)
        phase = (phase + 1) % m
        self._il_phase = phase
        idx, px_s, py_s = self._cosets(m)[phase]
        from ..ops.wavefront import RGB_CHANNEL

        chan = RGB_CHANNEL if self.spectral else 1
        a, b = {2: (2, 1), 4: (2, 2), 8: (4, 2)}[m]
        stride = ((a, b, phase % a, phase // a)
                  if self.width % 64 == 0 and self.height % 64 == 0
                  else None)
        self._last_seed = 0x7000 + self._il_step
        self.accum, self._count_base, self._last_counts = _step_subset(
            self.scene, self.accum, self._count_base, self.key,
            jnp.int32(self._last_seed), px_s, py_s, idx,
            jnp.int32(phase * idx.shape[0]),
            stride=stride,
            width=self.width, height=self.height, channel=chan,
            max_depth=self.config.max_bounce_depth,
            rr_start=self.config.russian_roulette_start,
            shadows=self.shadows, leaf_size=self.config.bvh_leaf_size,
            use_bvh=self.use_bvh, antialias=self.antialias,
            spp=self.samples_per_step, qmc=self.qmc,
            qmc_seed=self._qmc_seed,
            tex_lod_bias=self.config.bounce_lod_bias)
        self.perf.update_frame_count()

    def fly_frame(self, camera, m: int = 4, iterations: int = 4,
                  u8: bool = False, **kw):
        """One moving frame — temporal warp to `camera` + one interleaved
        1/m sample step + à-trous reconstruction — as a SINGLE compiled
        dispatch (_fly_frame), the interactive fly-through's hot path.
        Returns the denoised row-major [H,W,3] device frame (f32, or
        display-encoded u8). Falls back to the composed
        set_camera/step_interleaved/denoised_frame pipeline when the
        frame is not whole 64-px tiles or does not fit one pool."""
        one_dispatch = (self._total_samples() > 0 and self.width % 64 == 0
                    and self.height % 64 == 0 and m in (1, 2, 4, 8)
                    and self.interleave_ok(max(m, 2))
                    and self._whole_frame_ok() and not kw)
        if not one_dispatch:
            self.set_camera(camera, temporal=True)
            if m > 1:
                self.step_interleaved(m)
            else:
                self.step()
            return self.denoised_frame(iterations=iterations, u8=u8, **kw)

        old_cam = self.scene.camera
        scene_new = self.scene.with_camera(camera)
        self._ensure_inv_perm()
        self._warp_no = getattr(self, "_warp_no", 0) + 1
        wkey = jax.random.fold_in(jax.random.fold_in(self.key, 0x3A97),
                                  self._warp_no)
        old_depth_tile = (self._gbuf_tile[1]
                          if self._gbuf_tile is not None else None)
        self._il_step = getattr(self, "_il_step", 0) + 1
        phase = (getattr(self, "_il_phase", -1) + 1) % m
        self._il_phase = phase
        idx, px_s, py_s = self._cosets(m)[phase] if m > 1 else (
            None, self._px, self._py)
        a, b = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}[m]
        from ..ops.wavefront import RGB_CHANNEL

        chan = RGB_CHANNEL if self.spectral else 1
        self._last_seed = 0x7000 + self._il_step
        (self.accum, self._count_base, self._gbuf_tile, fb,
         self._last_counts) = _fly_frame(
            scene_new, old_cam, self.accum, self._n_total(),
            self._inv_perm, self._px, self._py,
            jnp.float32(self.temporal_clamp), wkey, old_depth_tile,
            self.key, jnp.int32(self._last_seed), px_s, py_s,
            jnp.int32(phase * px_s.shape[0]),
            width=self.width, height=self.height, channel=chan,
            max_depth=self.config.max_bounce_depth,
            rr_start=self.config.russian_roulette_start,
            shadows=self.shadows, leaf_size=self.config.bvh_leaf_size,
            use_bvh=self.use_bvh, antialias=self.antialias,
            spp=self.samples_per_step, qmc=self.qmc,
            qmc_seed=self._qmc_seed,
            tex_lod_bias=self.config.bounce_lod_bias,
            stride=(a, b, phase % a, phase // a), iterations=iterations,
            to_u8=u8)
        self.scene = scene_new
        self.samples = 0
        self._gbuf = None
        self.perf.update_frame_count()
        return fb

    def render(self, spp: int, progress: bool = False) -> np.ndarray:
        timing = ProgressiveTiming()
        timing.rays_per_tile = self.width * self.height
        for i in range(spp):
            with Timer() as t:
                self.step()
                jax.block_until_ready(self.accum)
            timing.record_tile(t.ms)
            if progress and (i + 1) % 8 == 0:
                print(f"  {i + 1}/{spp} spp")
        if progress:
            timing.print_summary()
        return self.image()

    def counters(self):
        """Per-bounce-depth ray accounting for the LAST step as a
        WavefrontCounters — the reference's struct fed with REAL device
        counts instead of its simulated 0.7^depth decay
        (src/compute.rs:467-474). Fetches from the device;
        call after step()."""
        from ..ops.wavefront import WavefrontCounters

        wc = WavefrontCounters(self.config.max_bounce_depth,
                               frame_seed=getattr(self, "_last_seed", 0))
        if self._last_counts is not None:
            for depth, cnt in enumerate(np.asarray(self._last_counts)):
                if cnt > 0:  # zero-count depths are NOT active
                    wc.add_rays(depth, int(cnt))
        return wc

    def image(self) -> np.ndarray:
        if self._count_base is None:
            n = max(self.samples, 1)
        else:   # reprojected history: per-pixel weights
            n = np.maximum(np.asarray(self._count_base) + self.samples,
                           1.0)[:, None]
        flat = np.asarray(self.accum) / n            # rows in tile-ray order
        fb = np.zeros((self.height, self.width, 3), np.float32)
        fb[self._py_host, self._px_host] = flat
        return fb

    # ---- denoised reconstruction (an addition: the reference ships no
    # filter at all — its wavefront dispatcher is a stub,
    # src/compute.rs:365-553). ops/denoise.py has the
    # filter design notes.

    def gbuffer(self):
        """Primary-hit G-buffer: (normal [H,W,3] — exactly 0 on miss,
        depth [H,W] ray t, albedo [H,W,3] — 1 on miss). Traced row-major
        through the SAME trace stack as the samples (pixel centres, no
        jitter) so edges line up with the accumulated image;
        deterministic, so one pass serves any number of spp — cached on
        device until the camera or scene changes (and produced as a
        byproduct of the temporal warp, which traces these rays anyway)."""
        if self._gbuf is None:
            if self._gbuf_tile is not None:
                # the warp left the same trace's planes in tile order —
                # one packed permute instead of a fresh primary trace
                self._ensure_inv_perm()
                self._gbuf = _gbuf_rowmajor(self._gbuf_tile, self._inv_perm,
                                            width=self.width,
                                            height=self.height)
            else:
                self._gbuf = _gbuffer(self.scene, width=self.width,
                                      height=self.height,
                                      leaf_size=self.config.bvh_leaf_size,
                                      use_bvh=self.use_bvh)
        return self._gbuf

    def _inv_n(self):
        if self._count_base is None:
            return jnp.float32(1.0 / max(self.samples, 1))
        # reprojected history: per-pixel weights, broadcast [C,1]
        return (1.0 / jnp.maximum(self._count_base + self.samples,
                                  1.0))[:, None]

    def denoised_frame(self, iterations: int = 4, u8: bool = False, **kw):
        """image() filtered by the edge-avoiding à-trous pass
        (ops/denoise.py): albedo-demodulated illumination smoothed along
        G-buffer edges — a DEVICE [H,W,3] array (f32, or display-ready u8
        with u8=True: a quarter of the readback bytes). One compiled
        dispatch over the cached G-buffer. kw forwards the sigma_* knobs.
        After a temporal warp the first denoise materialises the warp's
        tile-ordered G-buffer row-major (one [C,7] gather, then cached —
        see _gbuf_rowmajor for why it does NOT ride the denoiser's own
        gather)."""
        self._ensure_inv_perm()
        return _denoise_whole(self.accum, self._inv_perm, self._inv_n(),
                              self.gbuffer(),
                              width=self.width, height=self.height,
                              iterations=iterations, to_u8=u8, **kw)

    def denoised_image(self, iterations: int = 4, **kw) -> np.ndarray:
        """denoised_frame() fetched to the host (f32 [H,W,3])."""
        return np.asarray(self.denoised_frame(iterations=iterations, **kw))

    def image_device(self, u8: bool = False):
        """image() staying on device: accumulator mean, row-major [H,W,3]
        (f32, or display-ready u8 with u8=True)."""
        self._ensure_inv_perm()
        return _image_whole(self.accum, self._inv_perm, self._inv_n(),
                            width=self.width, height=self.height, to_u8=u8)

    # ---- checkpoint / resume (an addition: the reference has none —
    # SURVEY.md §5 "Checkpoint/resume: none"; a recompute restarts from
    # tile 0. Here a progressive accumulation survives process restarts.)

    def save_checkpoint(self, path: str) -> None:
        np.savez_compressed(
            path,
            accum=np.asarray(self.accum),
            samples=self.samples,
            width=self.width,
            height=self.height,
            camera_position=np.asarray(self.scene.camera.position),
            camera_direction=np.asarray(self.scene.camera.direction),
            camera_up=np.asarray(self.scene.camera.up),
            camera_fov=np.asarray(self.scene.camera.fov),
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        assert int(data["width"]) == self.width and int(data["height"]) == self.height, \
            "checkpoint resolution mismatch"
        self.accum = jnp.asarray(data["accum"])
        self.samples = int(data["samples"])


def render_pathtraced(scene: Scene, width: int, height: int, spp: int = 16,
                      **kw) -> np.ndarray:
    return PathTracer(scene, width, height, **kw).render(spp)
