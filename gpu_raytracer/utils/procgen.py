"""Procedural benchmark scenes.

The environment has no glTF assets (zero egress), so benchmark configs that
call for "Sponza-scale" geometry (BASELINE.md configs 4-5) use a procedural
stand-in: an architectural courtyard — tiled floor, a grid of columns, arched
boxes and a rippled heightfield roof — tuned to a target triangle count, with
a camera inside and several punctual lights. Deterministic per seed.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.camera import Camera
from ..models.geometry import Mesh, Spheres
from ..models.light import LightBuilder
from ..models.material import MaterialBuilder
from ..models.scene import Scene, prepare_scene

_BOX_FACES = np.asarray([
    [0, 1, 2], [0, 2, 3],  # bottom
    [4, 6, 5], [4, 7, 6],  # top
    [0, 4, 5], [0, 5, 1],  # -z
    [3, 2, 6], [3, 6, 7],  # +z
    [0, 3, 7], [0, 7, 4],  # -x
    [1, 5, 6], [1, 6, 2],  # +x
], np.uint32)

_BOX_CORNERS = np.asarray([
    [0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1],
    [0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1],
], np.float32)


def _boxes(centers, sizes):
    """Vectorised box meshes: centers [B,3], sizes [B,3] → (verts, faces)."""
    B = centers.shape[0]
    verts = (_BOX_CORNERS[None] - 0.5) * sizes[:, None, :] + centers[:, None, :]
    faces = _BOX_FACES[None] + (np.arange(B, dtype=np.uint32) * 8)[:, None, None]
    return verts.reshape(-1, 3).astype(np.float32), faces.reshape(-1, 3)


def _heightfield(nx, nz, x0, x1, z0, z1, fn):
    xs = np.linspace(x0, x1, nx, dtype=np.float32)
    zs = np.linspace(z0, z1, nz, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = fn(X, Z).astype(np.float32)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(nz - 1), indexing="ij")
    a = (i * nz + j).reshape(-1)
    b = ((i + 1) * nz + j).reshape(-1)
    c = ((i + 1) * nz + j + 1).reshape(-1)
    d = (i * nz + j + 1).reshape(-1)
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    return verts, faces.astype(np.uint32)


def make_checker_texture(size: int = 128, tiles: int = 8,
                         c0=(230, 228, 220), c1=(60, 58, 54)) -> np.ndarray:
    """Procedural checkerboard RGBA8 atlas (zero-egress stand-in for the
    Sponza floor textures)."""
    # per-axis uint8 parity + palette take: full-size int64 grids (np.mgrid)
    # measured ~18 s at 4096^2 on this host's memory bandwidth
    ax = ((np.arange(size, dtype=np.int32) * tiles // size) & 1).astype(
        np.uint8)
    cell = ax[:, None] ^ ax[None, :]
    palette = np.asarray([(*c0, 255), (*c1, 255)], np.uint8)
    return palette[cell]


def make_brick_texture(size: int = 128, rows: int = 8,
                       brick=(180, 96, 70), mortar=(200, 196, 188),
                       seed: int = 0) -> np.ndarray:
    """Procedural running-bond brick RGBA8 atlas with per-brick tint noise."""
    rng = np.random.default_rng(seed)
    y = np.arange(size)[:, None]
    x = np.arange(size)[None, :]
    bh = size // rows
    bw = bh * 2
    row = y // bh
    xs = x + (row % 2) * (bw // 2)              # running bond offset
    col = xs // bw
    row, xs = np.broadcast_to(row, (size, size)), \
        np.broadcast_to(xs, (size, size))
    col = np.broadcast_to(col, (size, size))
    in_mortar = ((y % bh) < max(bh // 8, 1)) | ((xs % bw) < max(bw // 8, 1))
    tint = rng.uniform(0.8, 1.15, (rows + 1, size // bw + 2, 1))
    base = np.clip(np.asarray(brick, np.float32)
                   * tint[row.reshape(-1), col.reshape(-1)].reshape(
                       size, size, 1), 0, 255).astype(np.uint8)
    img = np.where(in_mortar[..., None], np.asarray(mortar, np.uint8), base)
    return np.concatenate(
        [img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def make_noise_texture(size: int = 128, base=(200, 60, 45),
                       seed: int = 1) -> np.ndarray:
    """Procedural smooth value-noise RGBA8 atlas (painted-plaster look)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.6, 1.3, (size // 16 + 1, size // 16 + 1))
    y = (np.arange(size, dtype=np.float32) / 16.0)[:, None]
    x = (np.arange(size, dtype=np.float32) / 16.0)[None, :]
    x0, y0 = x.astype(int), y.astype(int)
    fx, fy = x - x0, y - y0
    v = (coarse[y0, x0] * (1 - fx) * (1 - fy)
         + coarse[y0, x0 + 1] * fx * (1 - fy)
         + coarse[y0 + 1, x0] * (1 - fx) * fy
         + coarse[y0 + 1, x0 + 1] * fx * fy)
    img = np.clip(np.asarray(base, np.float32) * v[..., None],
                  0, 255).astype(np.uint8)
    return np.concatenate(
        [img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def courtyard_source_images(seed: int = 0,
                            texture_size: int = 128) -> list[np.ndarray]:
    """The textured courtyard's source texture table (level-0 RGBA8 images,
    texture-index order) — the arrays `make_courtyard_scene(textured=True)`
    feeds `Textures.from_images`, exposed for the GLB exporter (the derived
    guard-band atlas is not an interchange format).

    `texture_size` sets the floor map's edge; the box maps use half that
    (floor ≥ the default 128). texture_size=4096 is the reference-class
    asset volume (4096² + 2·2048² = 25.2 MTexel — the scale the reference's
    image crate ingests for Sponza, gltf_loader.rs:128-184)."""
    half = max(texture_size // 2, 128)
    return [make_checker_texture(texture_size),        # 0: floor
            make_brick_texture(half, seed=seed),       # 1: stone boxes
            make_noise_texture(half, seed=seed)]       # 2: plaster boxes


def make_courtyard_scene(target_triangles: int = 100_000, seed: int = 0,
                         config: RaytracerConfig = DEFAULT_CONFIG,
                         lights: int = 2, textured: bool = False,
                         texture_size: int = 128) -> Scene:
    """Sponza-scale procedural stand-in.

    `textured=True` is BASELINE config 4's content class: the same geometry
    with procedural RGBA8 atlases (checker floor, brick stone, noise plaster)
    bound through the glTF texture-slot machinery
    (src/buffers.rs:423-431 packing, gltf_loader.rs:128-184
    decode — which the reference's kernel never read) and world-space UVs."""
    from ..models.geometry import Textures
    from ..models.material import NO_TEXTURE

    rng = np.random.default_rng(seed)
    mats = MaterialBuilder()

    def tex_slots(base_idx):
        ti = np.full(8, NO_TEXTURE, np.uint32)
        ti[0] = base_idx  # TEX_BASE_COLOR
        return ti

    if textured:
        m_stone = mats.add(albedo=(0.9, 0.85, 0.8), metallic=0.0,
                           roughness=1.0, texture_indices=tex_slots(1))
        m_floor = mats.add(albedo=(0.95, 0.95, 0.95), metallic=0.0,
                           roughness=1.0, texture_indices=tex_slots(0))
        m_metal = mats.add(albedo=(0.7, 0.6, 0.3), metallic=1.0,
                           roughness=0.2)
        m_glass = mats.add_glass((0.4, 0.5, 0.8), 1.5, 0.9)
        m_red = mats.add(albedo=(1.0, 1.0, 1.0), metallic=0.0,
                         roughness=1.0, texture_indices=tex_slots(2))
    else:
        m_stone = mats.add_diffuse((0.6, 0.55, 0.5))
        m_floor = mats.add_diffuse((0.45, 0.42, 0.4))
        m_metal = mats.add_metallic((0.7, 0.6, 0.3), 0.2)
        m_glass = mats.add_glass((0.4, 0.5, 0.8), 1.5, 0.9)
        m_red = mats.add_diffuse((0.7, 0.15, 0.1))

    all_verts, all_faces, all_mats = [], [], []
    voffset = 0

    def add(verts, faces, mat_ids):
        nonlocal voffset
        all_verts.append(verts)
        all_faces.append(faces + voffset)
        all_mats.append(mat_ids)
        voffset += verts.shape[0]

    # columns + crates on a CONSTANT-SPACING grid (12 tris per box): the
    # scene extent grows with the triangle budget, so boxes never merge into
    # a solid mass and the camera always has sight lines through the field —
    # a constant-extent grid packs solid at ~100k tris, which makes every
    # camera ray terminate on the nearest wall and the benchmark trivially
    # easy (and the image a flat ambient wall).
    n_boxes = max(target_triangles // 24, 1)
    grid = int(np.ceil(np.sqrt(n_boxes)))
    spacing = 1.75
    extent = grid * spacing / 2.0
    # centers at half-spacing offsets regardless of grid parity, so the
    # lines x = k*spacing (in particular x = 0) are always clear lanes
    gx, gz = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    pos = np.stack([
        (gx.reshape(-1) - grid // 2 + 0.5) * spacing,
        np.zeros(grid * grid),
        (gz.reshape(-1) - grid // 2 + 0.5) * spacing,
    ], axis=1)[:n_boxes].astype(np.float32)
    heights = rng.uniform(0.5, 4.0, n_boxes).astype(np.float32)
    widths = rng.uniform(0.3, 1.2, (n_boxes, 2)).astype(np.float32)
    sizes = np.stack([widths[:, 0], heights, widths[:, 1]], axis=1)
    centers = pos + np.stack([np.zeros(n_boxes), heights / 2 + 0.2,
                              np.zeros(n_boxes)], axis=1)
    bv, bf = _boxes(centers, sizes)
    box_mats = rng.choice(np.asarray([m_stone, m_stone, m_stone, m_metal,
                                      m_glass, m_red], np.uint32),
                          size=n_boxes)
    add(bv, bf, np.repeat(box_mats, 12))

    # floor heightfield (gentle ripple) sized to the box field, consuming
    # the rest of the budget
    hf_tris = max(target_triangles - n_boxes * 12, 2)
    n = int(np.sqrt(hf_tris / 2)) + 1
    hv, hfc = _heightfield(n, n, -extent, extent, -extent, extent,
                           lambda x, z: 0.15 * np.sin(x * 0.8) * np.cos(z * 0.7))
    add(hv, hfc, np.full(hfc.shape[0], m_floor, np.uint32))

    verts = np.concatenate(all_verts)
    uv = None
    if textured:
        # World-space planar projection (the per-vertex analog of Sponza's
        # unwrapped UVs): walls map (x+z, y), REPEAT wrap tiles the atlases.
        uv = np.stack([(verts[:, 0] + verts[:, 2]) * 0.5,
                       verts[:, 1] * 0.5], axis=1).astype(np.float32)
    mesh = Mesh.from_arrays(verts,
                            np.concatenate(all_faces),
                            np.concatenate(all_mats), uv=uv)

    lb = LightBuilder()
    lb.add_directional((0.3, -1.0, 0.2), (1.0, 0.98, 0.9), 1.5)
    if lights > 1:
        lb.add_point((0.0, 8.0, 0.0), (1.0, 0.9, 0.7), 4.0)
    for i in range(max(lights - 2, 0)):
        p = rng.uniform(-20, 20, 3)
        p[1] = rng.uniform(2, 6)
        lb.add_point(tuple(p), tuple(rng.uniform(0.5, 1.0, 3)), 2.0)

    # camera on the x = 0 lane (always clear, see the half-offset centres),
    # at a z-lane crossing just inside the field edge, looking down the lane
    cam_z = float(np.floor(extent * 0.9 / spacing) * spacing)
    camera = Camera.create(position=(0.0, 2.5, cam_z),
                           direction=(0.0, -0.12, -1.0), fov=55.0)
    textures = None
    if textured:
        textures = courtyard_textures(seed, texture_size,
                                      mips=config.texture_mips)
    return prepare_scene(camera, Spheres.from_rows([]), mesh, mats.build(),
                         lb.build(), textures=textures, config=config)


def zoo_source_images(n_texs: int = 24, seed: int = 0,
                      size: int = 128) -> list[np.ndarray]:
    """n_texs distinct procedural RGBA8 textures (checker/brick/noise
    rotation with per-index palettes) — the texture-COUNT scale set for
    make_zoo_scene (reference-class assets carry dozens of maps,
    src/gltf_loader.rs:397-489)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_texs):
        c0 = tuple(int(v) for v in rng.integers(120, 255, 3))
        c1 = tuple(int(v) for v in rng.integers(20, 120, 3))
        s = size if i % 3 else size // 2    # mixed sizes exercise budgets
        kind = i % 3
        if kind == 0:
            out.append(make_checker_texture(s, tiles=4 + i % 8,
                                            c0=c0, c1=c1))
        elif kind == 1:
            out.append(make_brick_texture(s, rows=4 + i % 6, brick=c0,
                                          mortar=c1, seed=seed + i))
        else:
            out.append(make_noise_texture(s, base=c0, seed=seed + i))
    return out


def make_zoo_scene(target_triangles: int = 60_000, n_mats: int = 48,
                   n_texs: int = 24, seed: int = 0,
                   config: RaytracerConfig = DEFAULT_CONFIG,
                   multi_slot: bool = False) -> Scene:
    """Texture/material-COUNT scale scene: the courtyard
    box grid with `n_mats` distinct materials cycling metal/rough/
    spec-gloss/glass/emissive workflows and `n_texs` textures spread over
    base-color / metallic-roughness / occlusion / emissive slots — the
    material-table and atlas shape of a reference-class asset, versus the
    courtyard's 5 materials / 3 textures."""
    from ..models.geometry import Textures
    from ..models.material import (NO_TEXTURE, TEX_BASE_COLOR,
                                   TEX_EMISSIVE, TEX_METALLIC_ROUGHNESS,
                                   TEX_OCCLUSION)

    rng = np.random.default_rng(seed)
    mats = MaterialBuilder()

    def slots(**kw):
        ti = np.full(8, NO_TEXTURE, np.uint32)
        for k, v in kw.items():
            ti[{"base": TEX_BASE_COLOR, "mr": TEX_METALLIC_ROUGHNESS,
                "occ": TEX_OCCLUSION, "emi": TEX_EMISSIVE}[k]] = v
        return ti

    # Base-color maps only: each additional SLOT type (mr/occ/emissive)
    # adds a sampling pass for every lane regardless of how few materials
    # carry it — the reference-class scale question this scene answers is
    # material/texture COUNT, so it exercises that axis; the extra-slot
    # machinery has its own tests (tests/test_mips.py) and the
    # `multi_slot` flag turns it on here for content-class experiments.
    for i in range(n_mats):
        t0 = i % n_texs
        t1 = (i * 7 + 3) % n_texs
        alb = tuple(rng.uniform(0.4, 1.0, 3))
        kind = i % 6
        if kind == 0:       # textured diffuse
            mats.add(albedo=alb, roughness=1.0,
                     texture_indices=slots(base=t0))
        elif kind == 1:     # textured metallic-roughness workflow
            mats.add(albedo=alb, metallic=0.9, roughness=0.3,
                     texture_indices=(slots(base=t0, mr=t1) if multi_slot
                                      else slots(base=t0)))
        elif kind == 2:     # SPEC-GLOSS workflow with a diffuse map
            mats.add(albedo=alb, metallic=0.0, roughness=0.6,
                     material_type=1, diffuse_factor=alb,
                     specular_color=tuple(rng.uniform(0.2, 1.0, 3)),
                     glossiness_factor=float(rng.uniform(0.2, 0.9)),
                     texture_indices=slots(base=t0))
        elif kind == 3:     # glass (untextured — transmission path)
            mats.add_glass(alb, 1.5, 0.9)
        elif kind == 4:     # textured + ambient-occlusion map
            mats.add(albedo=alb, roughness=0.8,
                     texture_indices=(slots(base=t0, occ=t1) if multi_slot
                                      else slots(base=t0)))
        else:               # emissive map
            mats.add(albedo=alb, emission=tuple(rng.uniform(0, 0.5, 3)),
                     texture_indices=(slots(base=t0, emi=t1) if multi_slot
                                      else slots(base=t0)))

    n_boxes = max(target_triangles // 24, n_mats)
    grid = int(np.ceil(np.sqrt(n_boxes)))
    spacing = 1.75
    extent = grid * spacing / 2.0
    gx, gz = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    pos = np.stack([
        (gx.reshape(-1) - grid // 2 + 0.5) * spacing,
        np.zeros(grid * grid),
        (gz.reshape(-1) - grid // 2 + 0.5) * spacing,
    ], axis=1)[:n_boxes].astype(np.float32)
    heights = rng.uniform(0.5, 4.0, n_boxes).astype(np.float32)
    widths = rng.uniform(0.3, 1.2, (n_boxes, 2)).astype(np.float32)
    sizes = np.stack([widths[:, 0], heights, widths[:, 1]], axis=1)
    centers = pos + np.stack([np.zeros(n_boxes), heights / 2 + 0.2,
                              np.zeros(n_boxes)], axis=1)
    bv, bf = _boxes(centers, sizes)
    box_mats = (np.arange(n_boxes) % n_mats).astype(np.uint32)
    hf_tris = max(target_triangles - n_boxes * 12, 2)
    n = int(np.sqrt(hf_tris / 2)) + 1
    hv, hfc = _heightfield(n, n, -extent, extent, -extent, extent,
                           lambda x, z: 0.15 * np.sin(x * 0.8)
                           * np.cos(z * 0.7))
    verts = np.concatenate([bv, hv])
    faces = np.concatenate([bf, hfc + bv.shape[0]])
    tri_mats = np.concatenate([np.repeat(box_mats, 12),
                               np.full(hfc.shape[0], 0, np.uint32)])
    uv = np.stack([(verts[:, 0] + verts[:, 2]) * 0.5,
                   verts[:, 1] * 0.5], axis=1).astype(np.float32)
    mesh = Mesh.from_arrays(verts, faces, tri_mats, uv=uv)

    lb = LightBuilder()
    lb.add_directional((0.3, -1.0, 0.2), (1.0, 0.98, 0.9), 1.5)
    lb.add_point((0.0, 8.0, 0.0), (1.0, 0.9, 0.7), 4.0)
    cam_z = float(np.floor(extent * 0.9 / spacing) * spacing)
    camera = Camera.create(position=(0.0, 2.5, cam_z),
                           direction=(0.0, -0.12, -1.0), fov=55.0)
    textures = Textures.from_images(
        zoo_source_images(n_texs, seed), mips=config.texture_mips)
    return prepare_scene(camera, Spheres.from_rows([]), mesh, mats.build(),
                         lb.build(), textures=textures, config=config)


def courtyard_textures(seed: int, texture_size: int, mips: int = 1,
                       budget_rows: int | None = None):
    """The courtyard's built atlas (`Textures.from_images` over
    `courtyard_source_images`), DISK-CACHED: at the reference-class 4096
    texel size the procedural image synthesis + mip/atlas packing is tens
    of seconds of host NumPy that is bit-deterministic in
    (seed, size, mips, budget) — so pay it once per checkout, not per
    session. Cache: <checkout>/.cache (override GPU_RAYTRACER_CACHE;
    empty string disables). Small sizes (< 1024) skip the cache — building
    is faster than a few MB of IO."""
    import dataclasses
    import os

    import jax.numpy as jnp

    from ..models.geometry import Textures

    build = lambda: Textures.from_images(
        courtyard_source_images(seed, texture_size=texture_size),
        mips=mips, budget_rows=budget_rows)
    from ..device import CHECKOUT

    cdir = os.environ.get("GPU_RAYTRACER_CACHE",
                          os.path.join(CHECKOUT, ".cache"))
    if not cdir or texture_size < 1024:
        return build()
    path = os.path.join(
        cdir, f"ctex_v1_s{seed}_t{texture_size}_m{mips}_b{budget_rows}.npz")
    fields = [f.name for f in dataclasses.fields(Textures)
              if f.name != "n_levels"]
    try:
        with np.load(path) as z:
            arrs = {k: jnp.asarray(z[k]) for k in fields}
            n_levels = int(z["n_levels"])
        return Textures(**arrs, n_levels=n_levels)
    except (OSError, KeyError):
        pass
    tex = build()
    try:
        os.makedirs(cdir, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        np.savez(tmp, n_levels=np.int64(tex.n_levels),
                 **{k: np.asarray(getattr(tex, k)) for k in fields})
        os.replace(tmp, path)
    except OSError:
        pass                    # read-only FS etc. — cache is best-effort
    return tex
