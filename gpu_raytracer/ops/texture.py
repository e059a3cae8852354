"""Texture atlas sampling.

The reference uploads decoded RGBA8 texture bytes and per-texture metadata to
the GPU (src/buffers.rs:339-470, byte-packing u8→u32 at
buffers.rs:423-431) and binds them to the kernel — but the kernel never reads
them (the bindings are underscore-named, shader/src/lib.rs:34-35),
because the 12-byte position-only vertex format carries no UVs
(shared/src/lib.rs:108-127). This module completes that unfinished design:

* the atlas uses the GUARD-BAND layout (models/geometry.py::Textures): 128-
  texel rows of 127 payload + 1 duplicated wrap texel, plus one duplicated
  wrap row per texture, so the four bilinear taps are always the address
  quad (a, a+1, a+srows*128, a+srows*128+1) — wrap logic applies only to
  the base coordinate, never per tap;
* a bilinear fetch therefore row-gathers exactly TWO atlas rows and lane-
  selects with a one-hot reduce;
* UVs come from glTF `TEXCOORD_0` (models/gltf.py) interpolated with the
  Möller-Trumbore barycentrics the traversal already computes;
* wrap modes REPEAT / CLAMP_TO_EDGE / MIRRORED_REPEAT, filtering nearest or
  bilinear.

All functions are batched over rays: `idx` may be any shape S, uv [*S, 2],
returns [*S, 4] f32 in [0, 1].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.geometry import Textures, TEX_CHUNK

NO_TEXTURE = jnp.uint32(0xFFFFFFFF)


def _unpack_rgba(texel: jnp.ndarray) -> jnp.ndarray:
    r = (texel & 0xFF).astype(jnp.float32)
    g = ((texel >> 8) & 0xFF).astype(jnp.float32)
    b = ((texel >> 16) & 0xFF).astype(jnp.float32)
    a = ((texel >> 24) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, b, a], axis=-1) * (1.0 / 255.0)


def _wrap(coord: jnp.ndarray, size: jnp.ndarray,
          mode: jnp.ndarray) -> jnp.ndarray:
    """Sampler wrap of integer texel coords to [0, size):
    mode 0 = REPEAT, 1 = CLAMP_TO_EDGE, 2 = MIRRORED_REPEAT."""
    size = jnp.maximum(size.astype(jnp.int32), 1)
    repeat = jnp.mod(jnp.mod(coord, size) + size, size)
    clamp = jnp.clip(coord, 0, size - 1)
    per = jnp.mod(jnp.mod(coord, 2 * size) + 2 * size, 2 * size)
    mirror = jnp.where(per < size, per, 2 * size - 1 - per)
    return jnp.where(mode == 1, clamp, jnp.where(mode == 2, mirror, repeat))


def _mirror_flip(coord: jnp.ndarray, size: jnp.ndarray,
                 mode: jnp.ndarray) -> jnp.ndarray:
    """True where MIRRORED_REPEAT reflected this period — the +1 bilinear
    neighbour then lies at wrapped-1, so the tap pair direction flips."""
    size = jnp.maximum(size.astype(jnp.int32), 1)
    per = jnp.mod(jnp.mod(coord, 2 * size) + 2 * size, 2 * size)
    return (mode == 2) & (per >= size)


def _level_walk(tex: Textures, safe: jnp.ndarray, lod: jnp.ndarray):
    """Walk the contiguous mip chain to per-lane level `lod` →
    (w, h, srows, off_row) i32. Level addresses are DERIVED
    (off_{l+1} = off_l + (h_l+1)*ceil(w_l/127), sizes halving — the
    models/geometry.py::Textures layout), no per-level tables."""
    w = tex.width[safe].astype(jnp.float32)
    h = tex.height[safe].astype(jnp.float32)
    sr = tex.srows[safe].astype(jnp.float32)
    off = tex.offset_row[safe].astype(jnp.float32)
    sw, sh, soff, ssr = w, h, off, sr
    wl, hl, offl, srl = w, h, off, sr
    for l in range(1, tex.n_levels):
        offl = offl + (hl + 1.0) * srl
        wl = jnp.maximum(jnp.floor(wl * 0.5), 1.0)
        hl = jnp.maximum(jnp.floor(hl * 0.5), 1.0)
        srl = jnp.floor((wl + 126.0) * (1.0 / 127.0))
        m = lod >= float(l)
        sw = jnp.where(m, wl, sw)
        sh = jnp.where(m, hl, sh)
        soff = jnp.where(m, offl, soff)
        ssr = jnp.where(m, srl, ssr)
    return (sw.astype(jnp.int32), sh.astype(jnp.int32),
            ssr.astype(jnp.int32), soff.astype(jnp.int32))


def mip_lod_frac(tex: Textures, safe: jnp.ndarray, lam: jnp.ndarray):
    """Continuous LOD split for trilinear: (floor level l0, blend frac).

    lodf = log2(foot) approximated as exponent + mantissa (the classic
    piecewise-linear log2, max error 0.086 — monotone and exactly 0 at
    level boundaries, so the blend is continuous across them). frac is
    zeroed when magnifying (l0 would be < 0) or when l0+1 runs past the
    texture's resident chain."""
    lv = tex.levels[safe].astype(jnp.float32)
    w = tex.width[safe].astype(jnp.float32)
    foot = jnp.maximum(lam * w, 1e-20)
    bits = jax.lax.bitcast_convert_type(foot, jnp.int32)
    e = ((bits >> 23) - 127).astype(jnp.float32)
    mant = (bits & 0x7FFFFF).astype(jnp.float32) * jnp.float32(2.0 ** -23)
    l0 = jnp.clip(e, 0.0, lv - 1.0)
    frac = jnp.where((e >= 0.0) & (e < lv - 1.0), mant, 0.0)
    return l0, frac


def mip_level_params(tex: Textures, safe: jnp.ndarray,
                     lam: jnp.ndarray):
    """Per-lane nearest-mip level parameters → (w, h, srows, off_row) i32.

    lod = round(log2(lam * w0)) clamped to the texture's resident chain,
    computed exactly as floor(log2(x*sqrt2)) via f32 exponent extraction
    (integer ops, so every backend picks the same level)."""
    lv = tex.levels[safe].astype(jnp.float32)
    w = tex.width[safe].astype(jnp.float32)
    foot = jnp.maximum(lam * w, 1e-20)
    bits = jax.lax.bitcast_convert_type(foot * jnp.float32(1.4142135),
                                        jnp.int32)
    lod = jnp.clip(((bits >> 23) - 127).astype(jnp.float32), 0.0, lv - 1.0)
    return _level_walk(tex, safe, lod)


def tap_base(tex: Textures, idx: jnp.ndarray, uv: jnp.ndarray,
             lam: jnp.ndarray | None = None,
             lod: jnp.ndarray | None = None):
    """Bilinear tap setup in the guard-band atlas → (row [..], lane [..],
    srows [..], fx, fy) with every tap of the quad at
    (row + {0,1}*srows)*128 + lane + {0,1}.

    `idx` must already be valid (callers clamp/mask). The MIRRORED_REPEAT
    reflected-period tap direction flip is folded into (lane, fx).
    `lam` (mip footprint) + a pyramid atlas select a per-lane mip level;
    an explicit per-lane `lod` overrides the nearest-mip pick (trilinear)."""
    safe = jnp.minimum(idx.astype(jnp.uint32),
                       jnp.uint32(max(tex.count - 1, 0)))
    if lod is not None and tex.n_levels > 1:
        # clamp to each texture's resident chain (callers may pass a global
        # bounce-LOD bias larger than a small texture's level count) and to
        # >= 0 (a negative lod would walk level 0's metadata but callers
        # should never rely on that)
        lod = jnp.clip(lod, 0.0, tex.levels[safe].astype(jnp.float32) - 1.0)
        w, h, srows, off_row = _level_walk(tex, safe, lod)
        mode = tex.wrap[safe].astype(jnp.int32)
    elif lam is not None and tex.n_levels > 1:
        w, h, srows, off_row = mip_level_params(tex, safe, lam)
        mode = tex.wrap[safe].astype(jnp.int32)
    else:
        w = tex.width[safe].astype(jnp.int32)
        h = tex.height[safe].astype(jnp.int32)
        mode = tex.wrap[safe].astype(jnp.int32)
        srows = tex.srows[safe].astype(jnp.int32)
        off_row = tex.offset_row[safe].astype(jnp.int32)

    uf = uv[..., 0] * w.astype(jnp.float32) - 0.5
    vf = uv[..., 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(uf).astype(jnp.int32)
    y0 = jnp.floor(vf).astype(jnp.int32)
    fx = uf - x0.astype(jnp.float32)
    fy = vf - y0.astype(jnp.float32)

    xw = _wrap(x0, w, mode)
    yw = _wrap(y0, h, mode)
    # CLAMP below the low edge collapses both taps to texel 0 → weight 0.
    # (Above the high edge the guard texel is the clamped duplicate.)
    fx = jnp.where((mode == 1) & (x0 < 0), 0.0, fx)
    fy = jnp.where((mode == 1) & (y0 < 0), 0.0, fy)
    # Mirrored reflection: neighbour sits at xw-1, so shift the base and
    # flip the weight (exact; the xw==0 seam degenerates to weight 0).
    xflip = _mirror_flip(x0, w, mode)
    fx = jnp.where(xflip, jnp.where(xw == 0, 0.0, 1.0 - fx), fx)
    xw = jnp.where(xflip, jnp.maximum(xw - 1, 0), xw)
    yflip = _mirror_flip(y0, h, mode)
    fy = jnp.where(yflip, jnp.where(yw == 0, 0.0, 1.0 - fy), fy)
    yw = jnp.where(yflip, jnp.maximum(yw - 1, 0), yw)

    k = xw // TEX_CHUNK
    lane = xw - k * TEX_CHUNK
    row = off_row + yw * srows + k
    return row, lane, srows, fx, fy


def _bilinear_fetch(tex: Textures, safe: jnp.ndarray, uv: jnp.ndarray,
                    lam: jnp.ndarray | None = None,
                    lod: jnp.ndarray | None = None) -> jnp.ndarray:
    """One bilinear fetch (at the nearest mip from `lam`, or at explicit
    per-lane `lod`): two whole-row gathers (XLA's fast row-gather path) +
    weighted one-hot lane select — both x taps live in the fetched rows."""
    row, lane, srows, fx, fy = tap_base(tex, safe, uv, lam=lam, lod=lod)
    rows2d = tex.data_u32.reshape(-1, 128)
    flat = row.reshape(-1)
    top = rows2d[flat]                                   # [N,128]
    bot = rows2d[(row + srows).reshape(-1)]
    lanes = jax.lax.broadcasted_iota(jnp.int32, top.shape, 1)
    l0 = lane.reshape(-1, 1)
    wl = (jnp.where(lanes == l0, (1.0 - fx).reshape(-1, 1), 0.0)
          + jnp.where(lanes == l0 + 1, fx.reshape(-1, 1), 0.0))
    mix = lambda rowtex: jnp.stack(
        [jnp.sum(((rowtex >> (8 * c)) & 0xFF).astype(jnp.float32) * wl,
                 axis=1) for c in range(4)], axis=-1)
    rgba = (mix(top) * (1.0 - fy).reshape(-1, 1)
            + mix(bot) * fy.reshape(-1, 1)) * (1.0 / 255.0)
    return rgba.reshape(uv.shape[:-1] + (4,))


@partial(jax.jit, static_argnames=("bilinear", "trilinear"))
def sample_texture(tex: Textures, idx: jnp.ndarray, uv: jnp.ndarray,
                   bilinear: bool = True,
                   lam: jnp.ndarray | None = None,
                   trilinear: bool = False,
                   lod: jnp.ndarray | None = None) -> jnp.ndarray:
    """Sample texture `idx` (u32, NO_TEXTURE = miss) at `uv` → RGBA f32.

    Lanes with idx == NO_TEXTURE (or out of range) return opaque white
    (1,1,1,1) so the caller can multiply unconditionally — the standard
    "no texture = identity factor" convention. `lam` (per-lane mip
    footprint) enables nearest-mip selection on pyramid atlases;
    `trilinear=True` lerps the two straddling levels instead (kills
    level-boundary banding at the cost of a second fetch). `lod` (explicit
    per-lane level) and `trilinear` are mutually exclusive: the trilinear
    branch keys on `lam` and ignores `lod`, so callers pass one or the
    other (the bounce paths pass lod, primary shading passes lam).
    """
    valid = idx != NO_TEXTURE
    safe = jnp.where(valid, idx, 0).astype(jnp.uint32)

    if bilinear and trilinear and lam is not None and tex.n_levels > 1:
        sidx = jnp.minimum(safe, jnp.uint32(max(tex.count - 1, 0)))
        lv = tex.levels[sidx].astype(jnp.float32)
        l0, frac = mip_lod_frac(tex, sidx, lam)
        r0 = _bilinear_fetch(tex, safe, uv, lod=l0)
        r1 = _bilinear_fetch(tex, safe, uv, lod=jnp.minimum(l0 + 1.0,
                                                            lv - 1.0))
        rgba = r0 * (1.0 - frac)[..., None] + r1 * frac[..., None]
    elif bilinear:
        rgba = _bilinear_fetch(tex, safe, uv, lam=lam, lod=lod)
    else:
        w = tex.width[safe].astype(jnp.int32)
        h = tex.height[safe].astype(jnp.int32)
        mode = tex.wrap[safe].astype(jnp.int32)
        srows = tex.srows[safe].astype(jnp.int32)
        off_row = tex.offset_row[safe].astype(jnp.int32)
        x = _wrap(jnp.floor(uv[..., 0] * w).astype(jnp.int32), w, mode)
        y = _wrap(jnp.floor(uv[..., 1] * h).astype(jnp.int32), h, mode)
        k = x // TEX_CHUNK
        addr = (off_row + y * srows + k) * 128 + (x - k * TEX_CHUNK)
        addr = jnp.minimum(addr.astype(jnp.uint32),
                           jnp.uint32(tex.data_u32.shape[0] - 1))
        rgba = _unpack_rgba(tex.data_u32[addr])

    return jnp.where(valid[..., None], rgba, 1.0)


def interpolate_uv(tri_uv: jnp.ndarray, tri_idx: jnp.ndarray,
                   bu: jnp.ndarray, bv: jnp.ndarray) -> jnp.ndarray:
    """Barycentric UV interpolation: tri_uv [Tp,3,2] (leaf order), tri_idx
    [N] winner ids (clipped by caller), bu/bv [N] the Möller-Trumbore
    barycentrics (weights of v1 and v2)."""
    uvs = tri_uv[tri_idx]                     # [N,3,2]
    w0 = (1.0 - bu - bv)[:, None]
    return uvs[:, 0] * w0 + uvs[:, 1] * bu[:, None] + uvs[:, 2] * bv[:, None]


def sphere_uv(normal: jnp.ndarray) -> jnp.ndarray:
    """Spherical (equirectangular) UV from the unit outward normal — the
    conventional mapping; the reference defines none (spheres carry no UVs)."""
    u = 0.5 + jnp.arctan2(normal[..., 2], normal[..., 0]) / (2.0 * jnp.pi)
    v = 0.5 - jnp.arcsin(jnp.clip(normal[..., 1], -1.0, 1.0)) / jnp.pi
    return jnp.stack([u, v], axis=-1)
