"""Shading: Whitted-style direct lighting + PBR material evaluation.

Formula-for-formula port of the reference's lighting/material/dispersion
pipeline, vectorised over rays × lights:

  * ambient 0.1 × albedo, per-light N·L, branchless light-type blend
    (shader/src/lighting.rs:20-139);
  * distance attenuation 1/(1 + 0.01·d²) round-tripped through f16
    (lighting.rs:125-127);
  * BRDF: metallic>0.5 → 0.5·albedo·I, else (albedo/π)·I
    (shader/src/material.rs:66-83);
  * wavelength-dependent IOR dispersion table (-0.018, 0, +0.035) and the
    transmission blend with vec3(0.2,0.2,0.3) (material.rs:42-58,
    shader/src/lib.rs:299-338);
  * per-channel filtering (lib.rs:342-349) folded into one pass: the final
    image channel c equals shade(channel=c)[c], and only the dispersion term
    depends on the channel, so all three channels are produced in one sweep
    instead of the reference's 3 dispatches per tile.

Optional `shadow_mask` adds the shadow-ray occlusion the reference never
wired in (SURVEY.md §2.2: "no shadow rays are traced").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.material import (
    TEX_BASE_COLOR, TEX_EMISSIVE, TEX_METALLIC_ROUGHNESS, TEX_OCCLUSION)
from ..models.scene import Scene
from .f16 import f16_roundtrip, unpack_f16_high, unpack_f16_low
from .linalg import dot, max0, normalize
from .texture import sample_texture
from .trace import Hit, TRIANGLE

MAGENTA = jnp.asarray([1.0, 0.0, 1.0], jnp.float32)
# Cauchy-motivated dispersion offsets for R/G/B (material.rs:48-53).
DISPERSION = jnp.asarray([-0.018, 0.0, 0.035], jnp.float32)
TRANSMITTED_BASE = jnp.asarray([0.2, 0.2, 0.3], jnp.float32)


def material_textures(scene: Scene, mid: jnp.ndarray, uv: jnp.ndarray,
                      lam: jnp.ndarray | None = None,
                      trilinear: bool = False,
                      lod: jnp.ndarray | None = None):
    """Gather material rows and apply texture factors (glTF: factors multiply
    texture samples) → (albedo [N,3], emission [N,3], metallic [N],
    ambient_occlusion [N] or None). Static-gated on texture data being
    present so untextured scenes pay nothing; the reference bound this data
    but never sampled it (shader lib.rs:34-35)."""
    m = scene.materials
    albedo = m.albedo[mid]                                 # [N,3]
    emission = m.emission[mid]
    metallic = unpack_f16_low(m.metallic_roughness_f16[mid])  # [N]
    ambient_occ = None
    if scene.textures.data_u32.shape[0] > 1:
        tex = scene.textures
        ti = m.texture_indices[mid]                        # [N,8]
        # Static slot gating: skip whole maps no material references
        # (Materials.present_slots — a jit-static tuple), so e.g. a
        # base-color-only scene pays ONE sampling pass, not four.
        slots = m.present_slots
        if slots is None:
            slots = (TEX_BASE_COLOR, TEX_METALLIC_ROUGHNESS,
                     TEX_OCCLUSION, TEX_EMISSIVE)
        if TEX_BASE_COLOR in slots:
            albedo = albedo * sample_texture(
                tex, ti[:, TEX_BASE_COLOR], uv, lam=lam,
                trilinear=trilinear, lod=lod)[:, :3]
        if TEX_EMISSIVE in slots:
            emission = emission * sample_texture(
                tex, ti[:, TEX_EMISSIVE], uv, lam=lam,
                trilinear=trilinear, lod=lod)[:, :3]
        if TEX_METALLIC_ROUGHNESS in slots:
            mr = sample_texture(tex, ti[:, TEX_METALLIC_ROUGHNESS], uv,
                                lam=lam, trilinear=trilinear, lod=lod)
            metallic = metallic * mr[:, 2]                 # B channel
        if TEX_OCCLUSION in slots:
            ambient_occ = sample_texture(
                tex, ti[:, TEX_OCCLUSION], uv, lam=lam,
                trilinear=trilinear, lod=lod)[:, 0]  # R channel
    return albedo, emission, metallic, ambient_occ


def uv_density_code(tri_e1, tri_e2, tri_uv) -> jnp.ndarray:
    """Per-triangle mip uv density -> 14-bit float code [T] i32.

    density = sqrt(|uv cross| / |e1 x e2|) (texels per world unit at unit
    texture size); code = top 14 bits of the f32 (sign dropped — density is
    non-negative), round-to-nearest, clipped below the inf/nan boundary.
    Quantising pins the value every backend decodes (integer ops and a
    bitcast), so the GPU and CPU pick the same nearest mip even where their
    sqrt differs in the last bits. Degenerate uv or geometry -> code 0 ->
    decodes to exactly 0.0."""
    cn = jnp.cross(tri_e1, tri_e2)
    n2 = jnp.maximum(jnp.sum(cn * cn, axis=1), 1e-30)
    cruv = ((tri_uv[:, 1, 0] - tri_uv[:, 0, 0])
            * (tri_uv[:, 2, 1] - tri_uv[:, 0, 1])
            - (tri_uv[:, 2, 0] - tri_uv[:, 0, 0])
            * (tri_uv[:, 1, 1] - tri_uv[:, 0, 1]))
    den = jnp.sqrt(jnp.abs(cruv) * jax.lax.rsqrt(n2)).astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(den, jnp.int32)
    return jnp.clip((bits + 0x10000) >> 17, 0, (254 << 6) | 63)


def den_decode(code):
    """code (f32 exact-int or i32) -> density f32: bits = code << 17."""
    ci = code.astype(jnp.int32) if code.dtype != jnp.int32 else code
    return jax.lax.bitcast_convert_type(ci << 17, jnp.float32)


def hit_footprint(scene: Scene, hit: Hit, height: int) -> jnp.ndarray:
    """Mip footprint [N] for primary hits: hit distance x pixel angular
    size x the winner triangle's uv density (through its 14-bit code, see
    uv_density_code). Zero for misses and sphere hits (-> level 0)."""
    fov_scale = jnp.tan(scene.camera.fov * jnp.float32(0.5)
                        * jnp.pi / 180.0)
    pix_scale = 2.0 * fov_scale * (1.0 / height)
    i = jnp.clip(hit.prim_id, 0, scene.tri_v0.shape[0] - 1)
    code = uv_density_code(scene.tri_e1, scene.tri_e2, scene.tri_uv)
    den = den_decode(code[i])
    lam = hit.t * pix_scale * den
    return jnp.where(hit.hit & (hit.prim_kind == TRIANGLE), lam, 0.0)


def direct_lighting(scene: Scene, hit: Hit, shadow_mask: jnp.ndarray | None = None,
                    lam: jnp.ndarray | None = None,
                    trilinear: bool = False,
                    lod: jnp.ndarray | None = None):
    """Per-ray RGB from ambient + punctual lights + emission
    (LightingCalculator::calculate_lighting, lighting.rs:20-47).

    shadow_mask: optional [N,L] float (1 = lit, 0 = occluded), multiplied into
    the per-light intensity before the >0 contribution gate.
    Returns lighting [N,3].
    """
    m = scene.materials
    L = scene.lights
    mid = jnp.clip(hit.material_id, 0, m.count - 1)
    albedo, emission, metallic, ambient_occ = material_textures(
        scene, mid, hit.uv, lam=lam, trilinear=trilinear, lod=lod)

    n = hit.normal                                          # [N,3]
    p = hit.point

    # Directional term (lighting.rs:97-110). normalize() of a zero direction
    # yields NaN which max0 silences, matching Rust's NaN-ignoring f32::max.
    ldir = normalize(L.direction)[None, :, :]               # [1,L,3]
    dir_I = max0(dot(n[:, None, :], -ldir)) * L.intensity[None, :]  # [N,L]

    # Point/spot term (lighting.rs:113-139).
    to_light = L.position[None, :, :] - p[:, None, :]       # [N,L,3]
    dist = jnp.sqrt(dot(to_light, to_light))                # [N,L]
    pl_dir = to_light / dist[..., None]
    atten = f16_roundtrip(1.0 / (1.0 + dist * dist * 0.01))
    point_I = max0(dot(n[:, None, :], pl_dir)) * L.intensity[None, :] * atten
    spot_factor = max0(dot(-ldir, pl_dir))
    spot_I = point_I * spot_factor

    # Branchless light-type blend (lighting.rs:80-86).
    lt = L.light_type[None, :]
    I = (dir_I * (lt == 0) + point_I * (lt == 1) + spot_I * (lt == 2))  # [N,L]
    if shadow_mask is not None:
        I = I * shadow_mask

    # BRDF (material.rs:76-83) × light colour × validity gate (lighting.rs:89-93).
    is_metal = (metallic > 0.5).astype(jnp.float32)[:, None]            # [N,1]
    brdf_scale = is_metal * 0.5 + (1.0 - is_metal) / jnp.pi             # [N,1]
    gate = (I > 0.0).astype(jnp.float32)                                # [N,L]
    per_light = (albedo[:, None, :] * brdf_scale[..., None]
                 * (I * gate)[..., None] * L.color[None, :, :])         # [N,L,3]

    ambient = albedo * 0.1
    if ambient_occ is not None:
        ambient = ambient * ambient_occ[:, None]
    return ambient + jnp.sum(per_light, axis=1) + emission


def dispersion_blend(scene: Scene, mid: jnp.ndarray,
                     lighting: jnp.ndarray) -> jnp.ndarray:
    """Transmission blend with wavelength-dependent IOR for clipped material
    ids `mid`, all 3 channels at once (calculate_shading,
    shader/src/lib.rs:322-337)."""
    m = scene.materials
    ior = unpack_f16_low(m.ior_transmission_f16[mid])       # [N]
    trans = unpack_f16_high(m.ior_transmission_f16[mid])
    trans = jnp.clip(trans, 0.0, 1.0)[:, None]              # [N,1]

    wavelength_ior = ior[:, None] + DISPERSION[None, :]     # [N,3]
    dispersion = (wavelength_ior - 1.0) / (ior[:, None] - 1.0)
    transmitted = TRANSMITTED_BASE[None, :] * dispersion    # [N,3]

    blended = lighting * (1.0 - trans) + transmitted * trans
    return jnp.where(trans > 0.0, blended, lighting)


def apply_dispersion(scene: Scene, hit: Hit, lighting: jnp.ndarray) -> jnp.ndarray:
    mid = jnp.clip(hit.material_id, 0, scene.materials.count - 1)
    return dispersion_blend(scene, mid, lighting)


def shade(scene: Scene, hit: Hit, shadow_mask: jnp.ndarray | None = None,
          sky_color=(0.0, 0.0, 0.0),
          lam: jnp.ndarray | None = None,
          trilinear: bool = False) -> jnp.ndarray:
    """Full legacy-path shading for a traced batch → RGB [N,3].

    Misses get `sky_color` (black in the legacy kernel, lib.rs:77). An
    out-of-range material id shades magenta (lib.rs:307-309).
    """
    lighting = direct_lighting(scene, hit, shadow_mask, lam=lam,
                               trilinear=trilinear)
    color = apply_dispersion(scene, hit, lighting)

    invalid = hit.hit & ((hit.material_id < 0)
                         | (hit.material_id >= scene.materials.count))
    color = jnp.where(invalid[:, None], MAGENTA[None, :], color)

    sky = jnp.asarray(sky_color, jnp.float32)
    return jnp.where(hit.hit[:, None], color, sky[None, :])
