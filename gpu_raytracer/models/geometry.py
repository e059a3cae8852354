"""Geometric primitives (struct-of-arrays) + host helpers.

Covers the reference's `Sphere`, `Vertex`, `Triangle`, `TriangleLegacy` and
`Aabb` types (shared/src/lib.rs:97-150, impls lib.rs:641-831).
Arrays, not structs: vertices `[V,3]`, triangle indices `[T,3]`, etc.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class Spheres:
    center: jnp.ndarray       # [S,3] f32
    radius: jnp.ndarray       # [S] f32
    material_id: jnp.ndarray  # [S] u32

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def from_rows(rows: list[tuple]) -> "Spheres":
        """rows: (center, radius, material_id). Empty scenes get one
        radius-0 sphere (a guaranteed miss: discriminant < 0 for r=0 unless
        the ray passes exactly through the centre; also t ≤ MIN_RAY_DISTANCE)."""
        if not rows:
            rows = [((0.0, 0.0, 0.0), 0.0, 0)]
        c = np.asarray([r[0] for r in rows], np.float32).reshape(-1, 3)
        rad = np.asarray([r[1] for r in rows], np.float32)
        mid = np.asarray([r[2] for r in rows], np.uint32)
        return Spheres(jnp.asarray(c), jnp.asarray(rad), jnp.asarray(mid))


@pytree_dataclass
class Mesh:
    """Indexed triangle mesh — Vertex/Triangle semantics of
    shared/src/lib.rs:108-127.

    `from_arrays`/`empty` keep HOST (NumPy) arrays: the mesh is a host-side
    asset consumed by the BVH builder and refit; `prepare_scene` converts it
    to device arrays exactly once when assembling the Scene (round-tripping
    through the accelerator before the host build is pure transfer cost)."""

    vertices: jnp.ndarray     # [V,3] f32
    indices: jnp.ndarray      # [T,3] u32 (v0,v1,v2)
    material_id: jnp.ndarray  # [T] u32
    # Per-vertex texture coordinates (TEXCOORD_0). The reference's 12-byte
    # vertex carries positions only (shared/src/lib.rs:108-127) — one reason
    # its texture bindings go unread; here UVs are first-class so texturing
    # actually works. All-zeros when the asset has none.
    uv: jnp.ndarray           # [V,2] f32

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @staticmethod
    def empty() -> "Mesh":
        # One degenerate triangle (all vertices at origin): Möller-Trumbore
        # rejects it via the |det| < MIN_RAY_DISTANCE guard, so it never hits.
        return Mesh(
            vertices=np.zeros((1, 3), np.float32),
            indices=np.zeros((1, 3), np.uint32),
            material_id=np.zeros((1,), np.uint32),
            uv=np.zeros((1, 2), np.float32),
        )

    @staticmethod
    def from_arrays(vertices, indices, material_id, uv=None) -> "Mesh":
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        i = np.asarray(indices, np.uint32).reshape(-1, 3)
        m = np.asarray(material_id, np.uint32).reshape(-1)
        assert i.shape[0] == m.shape[0]
        if i.shape[0] == 0:
            return Mesh.empty()
        t = (np.zeros((v.shape[0], 2), np.float32) if uv is None
             else np.asarray(uv, np.float32).reshape(-1, 2))
        assert t.shape[0] == v.shape[0]
        return Mesh(v, i, m, t)

    def to_device(self) -> "Mesh":
        return Mesh(jnp.asarray(self.vertices), jnp.asarray(self.indices),
                    jnp.asarray(self.material_id), jnp.asarray(self.uv))


def dedup_triangles(tri_vertices: np.ndarray, material_ids: np.ndarray):
    """Convert fat triangles `[T,3,3]` to an indexed mesh with bit-exact
    position dedup — TriangleLegacy::to_indexed semantics
    (shared/src/lib.rs:688-749) and the glTF loader's
    HashMap-on-f32-bits dedup (src/gltf_loader.rs:287-394),
    vectorised with np.unique over the raw bit patterns."""
    tri_vertices = np.asarray(tri_vertices, np.float32).reshape(-1, 3, 3)
    flat = tri_vertices.reshape(-1, 3)
    bits = flat.view(np.uint32)
    # unique rows by bit pattern; `index` keeps first occurrence order stable
    _, first_idx, inverse = np.unique(
        bits, axis=0, return_index=True, return_inverse=True
    )
    # Reorder unique set by first appearance (matches find_or_add_vertex order).
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    vertices = flat[np.sort(first_idx)]
    indices = rank[inverse].reshape(-1, 3).astype(np.uint32)
    return vertices, indices, np.asarray(material_ids, np.uint32)


def triangle_aabbs(vertices: np.ndarray, indices: np.ndarray):
    """Per-triangle AABBs — Triangle::bounding_box
    (shared/src/lib.rs:671-685). Returns (min[T,3], max[T,3])."""
    tri = vertices[indices]  # [T,3,3]
    return tri.min(axis=1), tri.max(axis=1)


def aabb_union(min_a, max_a, min_b, max_b):
    """Aabb::union (shared/src/lib.rs:751-802)."""
    return np.minimum(min_a, min_b), np.maximum(max_a, max_b)


def aabb_surface_area(mn, mx):
    d = np.maximum(mx - mn, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


# Payload texels per 128-lane atlas row: lane 127 is a GUARD texel
# duplicating the wrap-neighbour of lane 126's texel (see Textures below).
TEX_CHUNK = 127


def _wrap_coords(x: np.ndarray, size: int, mode: int) -> np.ndarray:
    """NumPy sampler wrap to [0, size): 0=REPEAT 1=CLAMP 2=MIRRORED."""
    if mode == 1:
        return np.clip(x, 0, size - 1)
    if mode == 2:
        per = np.mod(x, 2 * size)
        return np.where(per < size, per, 2 * size - 1 - per)
    return np.mod(x, size)


def _downsample2x(img: np.ndarray) -> np.ndarray:
    """2x2 box-filter downsample of [H,W,4] u8 (edge-clamped, round-half-up)
    — the standard mip reduction."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    y0 = np.minimum(np.arange(h2) * 2, h - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.minimum(np.arange(w2) * 2, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    acc = (img[y0][:, x0].astype(np.uint16) + img[y0][:, x1]
           + img[y1][:, x0] + img[y1][:, x1])
    return ((acc + 2) // 4).astype(np.uint8)


def _atlas_block(img: np.ndarray, mode: int) -> np.ndarray:
    """Guard-band atlas block of one RGBA8 image → [h+1, srows, 128] u32.
    Lane l of chunk k of texture row y holds texel
    (wrap_x(127k + l), wrap_y(y)) — guards, tail padding and the extra
    vertical guard row all fall out of the same formula."""
    h, w = img.shape[:2]
    srows = -(-w // TEX_CHUNK)
    xs = _wrap_coords(
        (np.arange(srows)[:, None] * TEX_CHUNK + np.arange(128)),
        w, mode)                                  # [srows,128]
    ys = _wrap_coords(np.arange(h + 1), h, mode)  # [h+1]
    texels = np.ascontiguousarray(img).reshape(h, w, 4).view("<u4")[:, :, 0]
    return texels[ys[:, None, None], xs[None, :, :]]


@pytree_dataclass(meta_fields=("n_levels",))
class Textures:
    """Texture atlas — TextureInfo semantics
    (shared/src/lib.rs:85-95) holding the decoded RGBA8
    texels of src/gltf_loader.rs:128-184, re-laid-out as
    128-texel rows.

    GUARD-BAND LAYOUT. The atlas is a stack of 128-texel rows. Each texture
    row is split into `srows` chunks of 127 payload texels; lane 127 of every
    chunk duplicates the wrap-neighbour of the next texel column, and one
    extra guard ROW per texture duplicates the vertical wrap row. With texel
    (x, y) at atlas address `(offset_row + y*srows + x//127)*128 + x%127`,
    the four bilinear taps are always `a`, `a+1`, `a+srows*128`,
    `a+srows*128+1` — no per-tap wrap logic, and a whole bilinear fetch
    row-gathers exactly two atlas rows.
    Texels stay pre-packed little-endian RGBA-in-u32, the byte order the
    reference packs on upload (src/buffers.rs:423-431)."""

    width: jnp.ndarray    # [N] u32 logical texel width (of level 0)
    height: jnp.ndarray   # [N] u32 logical texel height (of level 0)
    format: jnp.ndarray   # [N] u32 (3 = RGBA8; everything is decoded to RGBA8)
    offset: jnp.ndarray   # [N] u32 byte offset of the texture's first atlas row
    size: jnp.ndarray     # [N] u32 atlas bytes (all levels)
    wrap: jnp.ndarray     # [N] u32 sampler wrap: 0=REPEAT 1=CLAMP 2=MIRRORED
    data_u32: jnp.ndarray  # [R*128] u32 texels, R whole 128-lane rows
    srows: jnp.ndarray       # [N] u32 atlas rows per texture row (= ceil(w/127))
    offset_row: jnp.ndarray  # [N] u32 atlas row index of texel (0,0)
    # MIP PYRAMID (n_levels > 1): level l+1 of a texture follows level l
    # contiguously, each level guard-banded exactly like a texture of its
    # own size, with w_{l+1} = max(w_l//2, 1), h_{l+1} = max(h_l//2, 1).
    # The level-l address base is therefore DERIVABLE from level-0 metadata
    # (off_{l+1} = off_l + (h_l+1)*ceil(w_l/127)) — samplers walk the chain
    # with a static loop, no per-level tables. `levels` is the per-texture
    # chain length; `n_levels` the static maximum (1 = no mips).
    levels: jnp.ndarray = None   # [N] u32
    n_levels: int = 1

    @property
    def count(self) -> int:
        return self.width.shape[0]

    @property
    def num_rows(self) -> int:
        return self.data_u32.shape[0] // 128

    @staticmethod
    def empty() -> "Textures":
        z = jnp.zeros((1,), jnp.uint32)
        return Textures(z, z, z, z, z, z, jnp.zeros((1,), jnp.uint32), z, z,
                        levels=jnp.ones((1,), jnp.uint32))

    @staticmethod
    def from_images(images: list[np.ndarray],
                    wrap: list[int] | None = None,
                    mips: int = 1,
                    budget_rows: int | None = None) -> "Textures":
        """images: list of [H,W,4] uint8 arrays; wrap: per-texture sampler
        wrap modes (0=REPEAT, the glTF default); mips: max mip levels to
        build (1 = none); budget_rows: if set, finest levels are dropped —
        always from the single most row-expensive chain first — until the
        whole atlas fits that many 128-texel rows, paid by the textures
        that cost the most (small maps keep full detail)."""
        if not images:
            return Textures.empty()
        wrap = list(wrap) if wrap is not None else [0] * len(images)
        chains = []
        for img in images:
            img = np.ascontiguousarray(np.asarray(img, np.uint8))
            assert img.ndim == 3 and img.shape[2] == 4, "textures must be RGBA8"
            chain = [img]
            while (len(chain) < mips
                   and max(chain[-1].shape[0], chain[-1].shape[1]) > 1):
                chain.append(_downsample2x(chain[-1]))
            chains.append(chain)

        def level_rows(img):
            h, w = img.shape[:2]
            return (h + 1) * (-(-w // TEX_CHUNK))

        if budget_rows is not None:
            # PER-TEXTURE detail allocation: repeatedly drop
            # the finest level of the SINGLE most expensive chain — big
            # atlases give up close-up detail first while small UI/detail
            # maps keep level 0 — instead of degrading every texture
            # globally in lockstep.
            while (sum(level_rows(l) for c in chains for l in c)
                   > budget_rows):
                droppable = [i for i, c in enumerate(chains) if len(c) > 1]
                if not droppable:
                    break
                worst = max(droppable,
                            key=lambda i: level_rows(chains[i][0]))
                chains[worst] = chains[worst][1:]

        widths, heights, offsets, sizes, srows_l, offrows, levels_l, rows = \
            [], [], [], [], [], [], [], []
        row = 0
        for chain, mode in zip(chains, wrap):
            h, w = chain[0].shape[:2]
            widths.append(w)
            heights.append(h)
            srows_l.append(-(-w // TEX_CHUNK))
            offrows.append(row)
            offsets.append(row * 512)
            levels_l.append(len(chain))
            tex_rows = 0
            for lvl in chain:
                block = _atlas_block(lvl, mode)   # [h+1, srows, 128]
                rows.append(block.reshape(-1, 128))
                tex_rows += level_rows(lvl)
            sizes.append(tex_rows * 512)
            row += tex_rows
        u32 = lambda x: jnp.asarray(np.asarray(x, np.uint32))
        flat = np.concatenate(rows, axis=0)
        return Textures(
            width=u32(widths), height=u32(heights),
            format=u32([3] * len(images)),
            offset=u32(offsets), size=u32(sizes),
            wrap=u32(wrap),
            data_u32=jnp.asarray(flat.reshape(-1).astype(np.uint32)),
            srows=u32(srows_l), offset_row=u32(offrows),
            levels=u32(levels_l),
            n_levels=max(len(c) for c in chains),
        )
