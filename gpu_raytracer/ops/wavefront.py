"""Wavefront path tracing.

The reference designed a wavefront architecture — per-ray records
(`WavefrontRay`, shared/src/lib.rs:163-181), per-depth
counters, breadth-first dispatch (src/compute.rs:365-553) —
but shipped it unfinished: continuation rays are a stub returning 0
(shader/src/wavefront.rs:340-355), next-depth counts are simulated host-side
with a 0.7^depth decay (compute.rs:467-474), and the kernel terminates every
ray after its first hit (shader/src/lib.rs:142-146).

This module implements the design for real:

* the ray pool is a fixed-capacity SoA pytree (XLA static shapes); every
  bounce re-sorts it by (direction octant | origin Morton) for traversal
  coherence, carrying the original lane index so radiance unscrambles once
  at the end;
* the breadth-first per-depth scheduler is a `lax.while_loop` over bounces
  (trace, shade, shadow rays, BSDF sampling and Russian roulette per
  depth), with terminated lanes masked to max_t=0 so they retire at once;
* spectral mode traces one ray per wavelength channel (the reference's
  3-channel tile dispatch, compute.rs:432-441) so refraction can use the
  per-channel IOR dispersion table;
* Russian roulette follows WavefrontRay::apply_russian_roulette
  (shared/src/lib.rs:969-978): survive → throughput /= p, else deactivate.

Sky color (0.1, 0.2, 0.3) × throughput on miss and shading × throughput on
hit match process_wavefront_ray (shader/src/wavefront.rs:146-164).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from ..utils.pytree import pytree_dataclass
from .camera_rays import generate_rays
from .f16 import unpack_f16_high, unpack_f16_low
from .linalg import dot, normalize
from .sampling import (
    RAY_CAMERA, RAY_REFLECT, RAY_TRANSMIT,
    cosine_hemisphere, ior_for_channel, reflect, refract, schlick_fresnel,
)
from .shading import direct_lighting, apply_dispersion, MAGENTA
from .trace import trace, occluded

SKY_WAVEFRONT = jnp.asarray([0.1, 0.2, 0.3], jnp.float32)  # wavefront.rs:148

# Wavelength-channel sentinel: the ray carries full RGB throughput and only
# collapses to a single reference channel (0/1/2) at its first dispersive
# (transmissive) interaction, with a 3x one-hot throughput so the estimator
# stays unbiased. The reference's spectral scheme dispatches 3 single-channel
# rays per pixel up front (src/compute.rs:432-441), which triples every
# traversal even for paths that never see glass; split-on-demand pays
# the spectral price only where dispersion actually happens.
RGB_CHANNEL = 3


class WavefrontCounters:
    """Host-side per-bounce-depth ray accounting — field-for-field port of
    the reference struct (shared/src/lib.rs:183-194, impl
    lib.rs:981-1043). The reference dispatches from these counters but fills
    them with a simulated 0.7^depth decay (src/compute.rs:467-474); here they
    are populated with REAL per-depth active counts from the device pool
    (path_trace_pool's termination masks)."""

    MAX_DEPTHS = 8

    def __init__(self, max_bounce_depth: int, frame_seed: int = 0):
        self.total_rays_generated = 0
        self.rays_per_bounce = [0] * self.MAX_DEPTHS
        self.active_bounce_depths = 0
        self.max_bounce_depth = max_bounce_depth
        self.frame_seed = frame_seed

    def reset(self, frame_seed: int) -> None:
        self.total_rays_generated = 0
        self.rays_per_bounce = [0] * self.MAX_DEPTHS
        self.active_bounce_depths = 0
        self.frame_seed = frame_seed

    def add_rays(self, bounce_depth: int, count: int) -> None:
        if bounce_depth < self.MAX_DEPTHS:
            self.rays_per_bounce[bounce_depth] += count
            self.total_rays_generated += count
            self.active_bounce_depths |= 1 << bounce_depth

    def get_ray_count(self, bounce_depth: int) -> int:
        if bounce_depth < self.MAX_DEPTHS:
            return self.rays_per_bounce[bounce_depth]
        return 0

    def has_active_rays(self, bounce_depth: int) -> bool:
        if bounce_depth < self.MAX_DEPTHS:
            return bool(self.active_bounce_depths & (1 << bounce_depth))
        return False

    def next_active_bounce_depth(self, current_depth: int):
        for depth in range(current_depth + 1,
                           min(self.max_bounce_depth, 7) + 1):
            if self.has_active_rays(depth):
                return depth
        return None

    def has_any_active_rays(self) -> bool:
        return self.active_bounce_depths != 0 and self.total_rays_generated > 0


@pytree_dataclass
class WavefrontRays:
    """Fixed-capacity ray pool — WavefrontRay fields
    (shared/src/lib.rs:163-181) as SoA arrays."""

    origin: jnp.ndarray              # [N,3] f32
    direction: jnp.ndarray           # [N,3] f32
    ray_type: jnp.ndarray            # [N] i32 (0=camera 1=reflect 2=transmit 3=shadow)
    bounce_depth: jnp.ndarray        # [N] i32
    throughput: jnp.ndarray          # [N,3] f32
    medium_ior: jnp.ndarray          # [N] f32
    pixel: jnp.ndarray               # [N] i32 flat pixel index
    inv_pdf: jnp.ndarray             # [N] f32
    t_min: jnp.ndarray               # [N] f32
    t_max: jnp.ndarray               # [N] f32
    wavelength_channel: jnp.ndarray  # [N] i32
    active: jnp.ndarray              # [N] bool

    @property
    def count(self) -> int:
        return self.origin.shape[0]


def camera_wavefront_rays(camera, width, height, px, py, channel,
                          jitter=None) -> WavefrontRays:
    """WavefrontRay::camera_ray semantics (shared/src/lib.rs:861-878):
    throughput 1, medium air IOR 1, t_min 1e-3, active."""
    o, d = generate_rays(camera, width, height, px, py, jitter=jitter)
    n = o.shape[0]
    f = lambda v: jnp.full((n,), v)
    return WavefrontRays(
        origin=o, direction=d,
        ray_type=jnp.full((n,), RAY_CAMERA, jnp.int32),
        bounce_depth=jnp.zeros((n,), jnp.int32),
        throughput=jnp.ones((n, 3), jnp.float32),
        medium_ior=f(jnp.float32(1.0)),
        pixel=(py.astype(jnp.int32) * width + px.astype(jnp.int32)),
        inv_pdf=f(jnp.float32(1.0)),
        t_min=f(jnp.float32(1e-3)),
        t_max=f(jnp.float32(3.0e38)),
        wavelength_channel=jnp.broadcast_to(jnp.asarray(channel, jnp.int32), (n,)),
        active=jnp.ones((n,), bool),
    )


def _shadow_mask_points(scene, point, normal, hit_mask, leaf_size, use_bvh):
    """[N,L] light visibility from hit points (shared with engine.renderer)."""
    L = scene.lights
    N = point.shape[0]
    to_light = L.position[None, :, :] - point[:, None, :]
    dist = jnp.sqrt(jnp.sum(to_light * to_light, axis=-1))
    pl_dir = to_light / dist[..., None]
    ldir = normalize(L.direction)[None, :, :]
    is_dir = L.light_type[None, :] == 0
    sdir = jnp.where(is_dir[..., None],
                     -jnp.broadcast_to(ldir, to_light.shape), pl_dir)
    smax = jnp.where(is_dir, jnp.float32(3.0e38), dist - 1e-3)
    # Lanes without a live hit get max_t=0 shadow rays: rejected at the BVH
    # root, so they cost one traversal step instead of a full occlusion query.
    smax = jnp.where(hit_mask[:, None], smax, 0.0)
    # light-major layout (see engine.renderer._shadow_mask): one light per
    # coherent packet
    o = jnp.broadcast_to((point + normal * 1e-3)[None, :, :],
                         (L.count, N, 3)).reshape(-1, 3)
    blocked = occluded(scene, o, jnp.swapaxes(sdir, 0, 1).reshape(-1, 3),
                       jnp.swapaxes(smax, 0, 1).reshape(-1),
                       leaf_size=leaf_size, use_bvh=use_bvh)
    mask = 1.0 - jnp.swapaxes(blocked.reshape(L.count, N), 0, 1).astype(jnp.float32)
    return jnp.where(hit_mask[:, None], mask, 1.0)


def _sort_perm(scene: Scene, o, d, active):
    """Stream compaction + ray sorting permutation (SURVEY.md §7 P4):
    (direction octant | dominant axis | coarse origin Morton) keeps
    traversal blocks coherent after a bounce scrambles them (the
    dominant-axis refinement makes neighbouring rays agree on which axis
    their direction mostly points along). Dead lanes key to the maximum so
    they compact into whole blocks that the max_t=0 prune retires at once."""
    N = o.shape[0]
    octant = (((d[:, 0] >= 0).astype(jnp.int32) << 2)
              | ((d[:, 1] >= 0).astype(jnp.int32) << 1)
              | (d[:, 2] >= 0).astype(jnp.int32))
    axis = jnp.argmax(jnp.abs(d), axis=1).astype(jnp.int32)
    dirkey = (octant << 2) | axis
    lo = scene.bvh.node_min[0]
    hi = scene.bvh.node_max[0]
    q = jnp.clip(((o - lo) / (hi - lo + 1e-6) * 16.0).astype(jnp.int32),
                 0, 15)
    morton = jnp.zeros((N,), jnp.int32)
    for b in range(4):
        morton = (morton
                  | (((q[:, 0] >> b) & 1) << (3 * b + 2))
                  | (((q[:, 1] >> b) & 1) << (3 * b + 1))
                  | (((q[:, 2] >> b) & 1) << (3 * b)))
    sort_key = jnp.where(active, (dirkey << 12) | morton, jnp.int32(2**30))
    return jnp.argsort(sort_key)


def _direct_lighting_sampled(scene: Scene, hit, live, u6, leaf_size,
                             use_bvh, tex_lod=None):
    """Single-light NEE: each lane samples ONE punctual light (u6) and
    weights its post-occlusion contribution by the light count — unbiased
    for the sum over lights (lighting.rs:20-139 formulas) at ONE any-hit
    occlusion query per bounce instead of one per light."""
    from .shading import material_textures
    from .f16 import f16_roundtrip
    from .linalg import max0

    m = scene.materials
    L = scene.lights
    mid = jnp.clip(hit.material_id, 0, m.count - 1)
    albedo, emission, metallic, ambient_occ = material_textures(
        scene, mid, hit.uv, lod=tex_lod)

    nL = L.count
    li = jnp.minimum((u6 * nL).astype(jnp.int32), nL - 1)
    lpos = L.position[li]                       # [N,3]
    ltype = L.light_type[li]                    # [N]
    lcol = L.color[li]
    lint = L.intensity[li]
    ldir = normalize(L.direction)[li]

    n = hit.normal
    p = hit.point
    dir_I = max0(dot(n, -ldir)) * lint
    to_light = lpos - p
    dist = jnp.sqrt(dot(to_light, to_light))
    pl_dir = to_light / dist[:, None]
    atten = f16_roundtrip(1.0 / (1.0 + dist * dist * 0.01))
    point_I = max0(dot(n, pl_dir)) * lint * atten
    spot_I = point_I * max0(dot(-ldir, pl_dir))
    I = (dir_I * (ltype == 0) + point_I * (ltype == 1)
         + spot_I * (ltype == 2))

    sdir = jnp.where((ltype == 0)[:, None], -ldir, pl_dir)
    smax = jnp.where(ltype == 0, jnp.float32(3.0e38), dist - 1e-3)
    smax = jnp.where(live & (I > 0.0), smax, 0.0)
    o = p + n * 1e-3
    blocked = occluded(scene, o, sdir, smax, leaf_size=leaf_size,
                       use_bvh=use_bvh)
    I = I * (1.0 - blocked.astype(jnp.float32))

    is_metal = (metallic > 0.5).astype(jnp.float32)
    brdf = is_metal * 0.5 + (1.0 - is_metal) / jnp.pi
    gate = (I > 0.0).astype(jnp.float32)
    per = albedo * (brdf * I * gate * nL)[:, None] * lcol
    ambient = albedo * 0.1
    if ambient_occ is not None:
        ambient = ambient * ambient_occ[:, None]
    return ambient + per + emission


def xla_bounce(scene: Scene, r: WavefrontRays, u: jnp.ndarray, *,
               shadows: bool, rr_enabled: bool, rr_now,
               leaf_size: int = 4, use_bvh: bool = True,
               light_sample: bool = False,
               tex_lod_bias: float = 0.0):
    """One wavefront bounce in XLA → (pool', radiance_delta [N,3]).

    Trace, sky/shade, spectral split-on-glass, continuation sampling and
    Russian roulette (jax.random layout: u is [N,7]) as a standalone
    function, so the lax.while_loop body below and the field-for-field
    pool tests drive one implementation.
    `rr_enabled` is the static roulette gate; `rr_now` the (traced) flag for
    whether this depth has reached russian_roulette_start.
    """
    mats = scene.materials
    live = r.active
    limit = jnp.where(live, jnp.float32(3.4028235e38 - 2.0), 0.0)
    hit = trace(scene, r.origin, r.direction, max_t=limit,
                leaf_size=leaf_size, use_bvh=use_bvh)
    hit_live = live & hit.hit
    miss_live = live & ~hit.hit

    # bounce-LOD bias (ray-cone style): per-lane mip level = bias × depth,
    # clamped per texture inside tap_base. None = level 0.
    textured = scene.textures.data_u32.shape[0] > 1
    tex_lod = (r.bounce_depth.astype(jnp.float32) * tex_lod_bias
               if (tex_lod_bias > 0.0 and textured
                   and scene.textures.n_levels > 1) else None)

    # --- miss: sky × throughput (wavefront.rs:146-151) ---
    radiance = jnp.where(
        miss_live[:, None], SKY_WAVEFRONT[None, :] * r.throughput, 0.0)

    # --- hit: direct shading × throughput (wavefront.rs:153-164) ---
    if shadows and light_sample and scene.lights.count > 1:
        lighting = _direct_lighting_sampled(scene, hit, hit_live, u[:, 6],
                                            leaf_size, use_bvh,
                                            tex_lod=tex_lod)
    else:
        smask = (_shadow_mask_points(scene, hit.point, hit.normal, hit_live,
                                     leaf_size, use_bvh) if shadows else None)
        lighting = direct_lighting(scene, hit, smask, lod=tex_lod)
    shaded = apply_dispersion(scene, hit, lighting)
    invalid = hit.hit & (hit.material_id >= mats.count)
    shaded = jnp.where(invalid[:, None], MAGENTA[None, :], shaded)
    radiance = radiance + jnp.where(
        hit_live[:, None], shaded * r.throughput, 0.0)

    # --- continuation sampling (the reference stub, implemented) ---
    mid = jnp.clip(hit.material_id, 0, mats.count - 1)
    albedo = mats.albedo[mid]
    metallic = unpack_f16_low(mats.metallic_roughness_f16[mid])
    roughness = unpack_f16_high(mats.metallic_roughness_f16[mid])
    if scene.textures.data_u32.shape[0] > 1:  # textured scene (static)
        from ..models.material import TEX_BASE_COLOR, TEX_METALLIC_ROUGHNESS
        from .texture import sample_texture
        ti = mats.texture_indices[mid]
        albedo = albedo * sample_texture(
            scene.textures, ti[:, TEX_BASE_COLOR], hit.uv,
            lod=tex_lod)[:, :3]
        mr = sample_texture(
            scene.textures, ti[:, TEX_METALLIC_ROUGHNESS], hit.uv,
            lod=tex_lod)
        metallic = metallic * mr[:, 2]
        roughness = roughness * mr[:, 1]
    base_ior = unpack_f16_low(mats.ior_transmission_f16[mid])
    transmission = unpack_f16_high(mats.ior_transmission_f16[mid])

    n = hit.normal
    d = r.direction
    entering = dot(d, n) < 0.0
    n_face = jnp.where(entering[:, None], n, -n)

    # diffuse lobe
    dir_diffuse = cosine_hemisphere(n_face, u[:, 0], u[:, 1])
    # metal lobe: mirror + roughness fuzz
    fuzz = jnp.stack([u[:, 0] * 2 - 1, u[:, 1] * 2 - 1, u[:, 2] * 2 - 1], -1)
    dir_metal = normalize(reflect(d, n_face) + roughness[:, None] * fuzz)
    metal_absorbed = dot(dir_metal, n_face) <= 0.0
    # spectral split-on-glass: RGB_CHANNEL rays pick one wavelength (u5)
    is_glass = transmission > 0.0
    split = is_glass & (r.wavelength_channel >= RGB_CHANNEL)
    c_new = jnp.minimum((u[:, 5] * 3.0).astype(jnp.int32), 2)
    eff_chan = jnp.where(split, c_new, r.wavelength_channel)
    # glass lobe: Fresnel-weighted reflect/refract with per-channel IOR
    mat_ior = ior_for_channel(base_ior, eff_chan)
    n1 = jnp.where(entering, r.medium_ior, mat_ior)
    n2 = jnp.where(entering, mat_ior, jnp.float32(1.0))
    eta = n1 / n2
    cos_i = jnp.abs(dot(d, n_face))
    dir_refr, tir = refract(d, n_face, eta)
    fres = jnp.clip(schlick_fresnel(cos_i, n1, n2), 0.0, 1.0)
    do_reflect = tir | (u[:, 3] < fres)
    dir_glass = jnp.where(do_reflect[:, None], reflect(d, n_face), dir_refr)
    new_medium = jnp.where(do_reflect, r.medium_ior,
                           jnp.where(entering, mat_ior, jnp.float32(1.0)))

    is_metal = ~is_glass & (metallic > 0.5)
    new_dir = jnp.where(is_glass[:, None], dir_glass,
                        jnp.where(is_metal[:, None], dir_metal, dir_diffuse))
    ray_type = jnp.where(is_glass & ~do_reflect, RAY_TRANSMIT, RAY_REFLECT)
    # offset along the travel side of the surface
    offset_sign = jnp.where(dot(new_dir, n_face) >= 0.0, 1.0, -1.0)
    new_origin = hit.point + n_face * (offset_sign * 1e-3)[:, None]

    throughput = r.throughput * albedo
    # 3x one-hot collapse on split lanes (unbiased spectral estimator)
    onehot = (eff_chan[:, None] == jnp.arange(3)[None, :]).astype(jnp.float32)
    throughput = jnp.where(split[:, None], throughput * 3.0 * onehot,
                           throughput)
    alive = hit_live & ~(is_metal & metal_absorbed)

    # --- Russian roulette (shared/src/lib.rs:969-978) ---
    if rr_enabled:
        p = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 0.95)
        do_rr = alive & rr_now
        survive = u[:, 4] <= p
        throughput = jnp.where((do_rr & survive)[:, None],
                               throughput / p[:, None], throughput)
        alive = alive & (~do_rr | survive)

    r2 = WavefrontRays(
        origin=jnp.where(alive[:, None], new_origin, r.origin),
        direction=jnp.where(alive[:, None], new_dir, r.direction),
        ray_type=jnp.where(alive, ray_type, r.ray_type).astype(jnp.int32),
        bounce_depth=r.bounce_depth + alive.astype(jnp.int32),
        throughput=jnp.where(alive[:, None], throughput, r.throughput),
        medium_ior=jnp.where(alive & is_glass, new_medium, r.medium_ior),
        pixel=r.pixel,
        inv_pdf=r.inv_pdf,
        t_min=r.t_min,
        t_max=r.t_max,
        wavelength_channel=jnp.where(alive, eff_chan,
                                     r.wavelength_channel).astype(jnp.int32),
        active=alive,
    )
    return r2, radiance


def _permute_pool(r: WavefrontRays, radiance, orig_lane, perm):
    """Apply a pool permutation as ONE packed [N,16] row gather (the four
    small-int fields share one exact-f32 column; pixel and orig_lane ride
    as plain f32, exact below 2^24 — pools are <= a few M lanes).

    inv_pdf / t_min / t_max are NOT permuted: they are pool-constant by
    construction (camera_wavefront_rays sets them uniformly and no bounce
    ever writes them — WavefrontRay parity fields only), so reordering
    lanes cannot change their values; they pass through as-is.
    """
    # a pool at or beyond 2^24 lanes would silently round lane ids and
    # scramble the final radiance unscramble.
    assert r.origin.shape[0] < 2 ** 24, \
        "wavefront pool too large for the packed f32 permute (>= 2^24 lanes)"
    # channel(2b) | ray_type(2b) | bounce_depth(6b) | active(1b) -> < 2^11,
    # exact in f32. Depth is capped at 63 by path_trace_pool's signature
    # (max_depth is a static int; reference depths are <= 8).
    small = (r.wavelength_channel.astype(jnp.float32)
             + 4.0 * r.ray_type.astype(jnp.float32)
             + 16.0 * r.bounce_depth.astype(jnp.float32)
             + 1024.0 * r.active.astype(jnp.float32))
    cols = jnp.concatenate([
        r.origin, r.direction, r.throughput, radiance,
        r.medium_ior[:, None],
        small[:, None],
        r.pixel.astype(jnp.float32)[:, None],
        orig_lane.astype(jnp.float32)[:, None],
    ], axis=1)[perm]
    sm = cols[:, 13]
    act = sm >= 1024.0
    sm = sm - jnp.where(act, 1024.0, 0.0)
    bd = jnp.floor(sm * (1.0 / 16.0))
    sm = sm - 16.0 * bd
    rt = jnp.floor(sm * 0.25)
    chan = sm - 4.0 * rt
    r2 = WavefrontRays(
        origin=cols[:, 0:3], direction=cols[:, 3:6], throughput=cols[:, 6:9],
        medium_ior=cols[:, 12], inv_pdf=r.inv_pdf,
        t_min=r.t_min, t_max=r.t_max,
        ray_type=rt.astype(jnp.int32),
        bounce_depth=bd.astype(jnp.int32),
        wavelength_channel=chan.astype(jnp.int32),
        pixel=cols[:, 14].astype(jnp.int32),
        active=act,
    )
    return r2, cols[:, 9:12], cols[:, 15].astype(jnp.int32)


def _unscramble(radiance, orig_lane):
    """Undo the composed coherence sorts: row i belongs to original lane
    orig_lane[i] (an inverse-permutation gather via argsort)."""
    return radiance[jnp.argsort(orig_lane)]


def _pool_uniforms(key, depth, N, orig_lane, qmc, qmc_pid_base, sample_base,
                   qmc_seed, qmc_spp):
    """The per-depth [N, 7] uniform block, at the pool's CURRENT lane
    order. Independent stream (default): threefry on (key, depth), drawn
    by lane position — the coherence sort has already decorrelated lanes
    from pixels. QMC stream: ops/sampler.py lattice uniforms addressed by
    the ray's IDENTITY (pixel id + global sample index), derived
    ARITHMETICALLY from orig_lane (which rides through every permute):
    pid = qmc_pid_base + orig_lane % C, s = sample_base + orig_lane // C
    for the chunk-major [spp, C] pool layout of
    engine/pathtracer._sample_chunk (the mod/div are a shift when C is a
    power of two)."""
    if qmc:
        from .sampler import qmc_uniforms
        C = N // qmc_spp
        pid = (jnp.asarray(qmc_pid_base).astype(jnp.uint32)
               + (orig_lane % C).astype(jnp.uint32))
        s = (jnp.asarray(sample_base).astype(jnp.uint32)
             + (orig_lane // C).astype(jnp.uint32))
        return qmc_uniforms(pid, s, depth, qmc_seed)
    return jax.random.uniform(jax.random.fold_in(key, depth), (N, 7),
                              jnp.float32)


@partial(jax.jit, static_argnames=("max_depth", "rr_start", "shadows",
                                   "leaf_size", "use_bvh", "qmc", "qmc_spp",
                                   "tex_lod_bias"))
def path_trace_pool(scene: Scene, rays: WavefrontRays, key: jax.Array,
                    max_depth: int = 4, rr_start: int = 2,
                    shadows: bool = True, leaf_size: int = 4,
                    use_bvh: bool = True, qmc: bool = False,
                    qmc_pid_base=0, sample_base=0, qmc_seed=0,
                    qmc_spp: int = 1, tex_lod_bias: float = 0.0):
    """Trace a ray pool to termination → radiance [N,3] aligned with the pool.

    Per bounce (the reference's per-depth dispatch, compute.rs:443-466):
    trace → miss adds sky×throughput; hit adds shading×throughput and spawns
    a continuation ray in place (the wavefront.rs:340 stub, implemented).

    Also returns per-depth active-ray counts [max_depth+1] — the device-real
    numbers for WavefrontCounters (the reference simulated these host-side
    with a 0.7^depth decay, compute.rs:467-474).
    """
    # bounce_depth rides a 6-bit field in _permute_pool's packed column
    assert max_depth < 62, "max_depth >= 62 overflows the packed permute"
    N = rays.count

    def cond(state):
        depth, r, radiance, counts, orig_lane = state
        return (depth <= max_depth) & jnp.any(r.active)

    def _coherence_sort(r, radiance, orig_lane):
        """Pool reorder by _sort_perm (single packed-row gather); the
        original lane index rides along and radiance is unscrambled once at
        the end of the loop."""
        perm = _sort_perm(scene, r.origin, r.direction, r.active)
        return _permute_pool(r, radiance, orig_lane, perm)

    def body(state):
        depth, r, radiance, counts, orig_lane = state
        counts = counts.at[jnp.minimum(depth, max_depth)].set(
            jnp.sum(r.active.astype(jnp.int32)))
        # Sort EVERY depth (camera rays arrive pre-sorted; a lax.cond on
        # depth > 0 would copy the whole pool through both branches).
        r, radiance, orig_lane = _coherence_sort(r, radiance, orig_lane)
        u = _pool_uniforms(key, depth, N, orig_lane, qmc, qmc_pid_base,
                           sample_base, qmc_seed, qmc_spp)
        r, rad = xla_bounce(scene, r, u, shadows=shadows,
                            rr_enabled=max_depth >= rr_start,
                            rr_now=depth + 1 >= rr_start,
                            leaf_size=leaf_size, use_bvh=use_bvh,
                            light_sample=shadows and scene.lights.count > 1,
                            tex_lod_bias=tex_lod_bias)
        return depth + 1, r, radiance + rad, counts, orig_lane

    radiance = jnp.zeros((N, 3), jnp.float32)
    counts = jnp.zeros((max_depth + 1,), jnp.int32)
    orig_lane = jnp.arange(N, dtype=jnp.int32)
    _, _, radiance, counts, orig_lane = jax.lax.while_loop(
        cond, body, (jnp.int32(0), rays, radiance, counts, orig_lane))
    return _unscramble(radiance, orig_lane), counts


@partial(jax.jit, static_argnames=("width", "height", "leaf_size", "use_bvh",
                                   "channel"))
def wavefront_single_bounce(scene: Scene, px, py, width: int, height: int,
                            channel: int = 0, leaf_size: int = 4,
                            use_bvh: bool = True):
    """Bit-parity port of the reference's *shipped* wavefront behaviour
    (run_wavefront_raytracing, shader/src/lib.rs:92-149): one camera ray per
    pixel/channel, a single processed bounce, forced termination. Returns the
    full RGB before channel filtering. Used by parity tests."""
    rays = camera_wavefront_rays(scene.camera, width, height, px, py, channel)
    hit = trace(scene, rays.origin, rays.direction, leaf_size=leaf_size,
                use_bvh=use_bvh)
    lighting = direct_lighting(scene, hit)
    # calculate_wavefront_shading uses the push-constant channel for
    # dispersion (wavefront.rs:200), same table as the legacy path.
    shaded = apply_dispersion(scene, hit, lighting)
    color = jnp.where(hit.hit[:, None], shaded * rays.throughput,
                      SKY_WAVEFRONT[None, :] * rays.throughput)
    return color
