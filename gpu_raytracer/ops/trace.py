"""Closest-hit / any-hit tracing over a whole scene.

The batched equivalent of `find_closest_intersection`
(shader/src/lib.rs:174-249): spheres are tested exhaustively,
triangles through the BVH when present (brute force otherwise,
lib.rs:192-211), and the winner is selected with the reference's tie rule —
the sphere pass runs first with closest_t seeded to f32::MAX-2, the triangle
pass prunes at the sphere's t with strict `<`, so at equal t the sphere wins
(lib.rs:183-248).

Shadow/any-hit queries (`occluded`) are an addition the reference designed
but never wired (SURVEY.md §3.5 gap list).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..device import traversal
from ..models.scene import Scene
from ..utils.pytree import pytree_dataclass
from .bvh_traverse import bvh_traverse, bvh_traverse_threaded
from .intersect import MISS_T, closest_select, sphere_intersect, triangle_intersect
from .linalg import cross, normalize
from .packet_trace import packet_traverse
from .texture import interpolate_uv, sphere_uv
from .traverse_kernel import kernel_traverse

PACKET_SIZE = 1024  # rays per shared-cursor packet of the XLA traversal


def _mt_bary(orig, dirn, v0, e1, e2):
    """Möller-Trumbore barycentrics (v1,v2 weights) of known-hit triangles,
    one per ray (all args [N,...])."""
    h = cross(dirn, e2)
    a = jnp.sum(e1 * h, axis=-1)
    f = 1.0 / jnp.where(a == 0.0, 1.0, a)
    s = orig - v0
    u = f * jnp.sum(s * h, axis=-1)
    q = cross(s, e1)
    v = f * jnp.sum(dirn * q, axis=-1)
    return u, v


def _traverse(scene, orig, dirn, limit, leaf_size, any_hit=False,
              want_uv=False):
    """Triangle traversal by the platform's choice (device.py): the GPU
    kernel (ops/traverse_kernel.py) on a GPU; on the CPU the XLA packet
    traversal when the batch divides into packets (the renderer feeds
    tile-ordered batches), per-ray threaded traversal otherwise.

    Returns (t, tri, hit, normal, mat, uv) with uv the winner's interpolated
    TEXCOORD (zeros unless want_uv). The packet path extracts winner
    attributes in its flush; the others expand them from the winner id."""
    Tp = scene.tri_v0.shape[0]
    if traversal() == "kernel":
        t, tri, hit, bary = kernel_traverse(
            scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2,
            orig, dirn, limit, leaf_size=leaf_size, any_hit=any_hit)
        normal, mat = _winner_attrs(scene, tri, hit)
    elif orig.shape[0] % PACKET_SIZE == 0:
        t, tri, hit, normal, mat, bary = packet_traverse(
            scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2,
            orig, dirn, limit, tri_mat=scene.tri_mat, leaf_size=leaf_size,
            packet_size=PACKET_SIZE, any_hit=any_hit)
    else:
        t, tri, hit = bvh_traverse_threaded(
            scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2,
            orig, dirn, limit, leaf_size=leaf_size, any_hit=any_hit)
        normal, mat = _winner_attrs(scene, tri, hit)
        ti = jnp.clip(tri, 0, Tp - 1)
        bu, bv = _mt_bary(orig, dirn, scene.tri_v0[ti], scene.tri_e1[ti],
                          scene.tri_e2[ti])
        bary = jnp.where(hit[:, None], jnp.stack([bu, bv], axis=-1), 0.0)
    if want_uv:
        ti = jnp.clip(tri, 0, Tp - 1)
        uv = interpolate_uv(scene.tri_uv, ti, bary[:, 0], bary[:, 1])
        uv = jnp.where(hit[:, None], uv, 0.0)
    else:
        uv = jnp.zeros((orig.shape[0], 2), jnp.float32)
    return t, tri, hit, normal, mat, uv


def _winner_attrs(scene, tri, hit):
    """Geometric unit normal and material of each ray's winner triangle."""
    ti = jnp.clip(tri, 0, scene.tri_v0.shape[0] - 1)
    normal = normalize(cross(scene.tri_e1[ti], scene.tri_e2[ti]))
    normal = jnp.where(hit[:, None], normal, 0.0)
    mat = jnp.where(hit, scene.tri_mat[ti], -1)
    return normal, mat


SPHERE, TRIANGLE = 0, 1
_BRUTE_BLOCK = 512  # triangles per brute-force block (bounds the [N,K] tile)


@pytree_dataclass
class Hit:
    """Batched hit record (the reference's Intersection/IntersectionResult,
    shader/src/intersection.rs:9-38)."""

    t: jnp.ndarray            # [N] f32, MISS_T on miss
    hit: jnp.ndarray          # [N] bool
    prim_kind: jnp.ndarray    # [N] i32: 0=sphere, 1=triangle
    prim_id: jnp.ndarray      # [N] i32 (sphere index / leaf-order triangle index)
    point: jnp.ndarray        # [N,3] f32
    normal: jnp.ndarray       # [N,3] f32
    material_id: jnp.ndarray  # [N] i32
    # Texture coordinates at the hit: barycentric-interpolated TEXCOORD_0 for
    # triangles, equirectangular for spheres (an addition — the reference's
    # hit record carries none, its textures being unreadable without UVs).
    uv: jnp.ndarray           # [N,2] f32


def _trace_triangles_brute(scene: Scene, orig, dirn, max_t):
    """Blocked brute-force sweep (the reference fallback, lib.rs:272-296).
    fori_loop over fixed triangle tiles keeps the working set at
    [N,block] instead of materialising [N,T]."""
    Tp = scene.tri_v0.shape[0]
    n_blocks = -(-Tp // _BRUTE_BLOCK)
    pad = n_blocks * _BRUTE_BLOCK - Tp
    v0 = jnp.pad(scene.tri_v0, ((0, pad), (0, 0)))
    e1 = jnp.pad(scene.tri_e1, ((0, pad), (0, 0)))
    e2 = jnp.pad(scene.tri_e2, ((0, pad), (0, 0)))

    N = orig.shape[0]
    init = (jnp.broadcast_to(max_t, (N,)), jnp.full((N,), -1, jnp.int32))

    def body(b, carry):
        best_t, best_i = carry
        s = b * _BRUTE_BLOCK
        bv0 = jax.lax.dynamic_slice(v0, (s, 0), (_BRUTE_BLOCK, 3))
        be1 = jax.lax.dynamic_slice(e1, (s, 0), (_BRUTE_BLOCK, 3))
        be2 = jax.lax.dynamic_slice(e2, (s, 0), (_BRUTE_BLOCK, 3))
        t, hit = triangle_intersect(orig, dirn, bv0, be1, be2, best_t)
        t_blk, i_blk, any_blk = closest_select(t, hit)
        win = any_blk & (t_blk < best_t)
        return (jnp.where(win, t_blk, best_t),
                jnp.where(win, s + i_blk, best_i))

    best_t, best_i = jax.lax.fori_loop(0, n_blocks, body, init)
    hit = best_i >= 0
    return jnp.where(hit, best_t, MISS_T), best_i, hit


def trace(scene: Scene, orig: jnp.ndarray, dirn: jnp.ndarray,
          max_t=None, leaf_size: int | None = None,
          use_bvh: bool = True) -> Hit:
    """Closest hit for a ray batch. orig/dirn: [N,3].

    leaf_size is clamped up to the BVH's actual max leaf occupancy — a
    smaller static unroll would silently skip triangles in fuller leaves."""
    leaf_size = max(leaf_size or 1, scene.bvh.max_leaf)
    N = orig.shape[0]
    if max_t is None:
        max_t = MISS_T - 2.0  # f32::MAX - 2.0 seed (lib.rs:183)
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (N,))

    # --- spheres, exhaustive (lib.rs:252-269) ---
    s_t, s_hit = sphere_intersect(orig, dirn, scene.spheres.center,
                                  scene.spheres.radius, max_t)
    sph_t, sph_i, sph_any = closest_select(s_t, s_hit)
    tri_limit = jnp.where(sph_any, sph_t, max_t)  # strict < keeps sphere on tie

    textured = scene.textures.data_u32.shape[0] > 1  # static

    # --- triangles: BVH when built, brute force otherwise (lib.rs:192-211) ---
    if use_bvh and scene.bvh.num_nodes > 1:
        tri_t, tri_i, tri_any, tri_normal, tri_m, tri_uv = _traverse(
            scene, orig, dirn, tri_limit, leaf_size, want_uv=textured)
    else:
        tri_t, tri_i, tri_any = _trace_triangles_brute(scene, orig, dirn, tri_limit)
        ti = jnp.clip(tri_i, 0, scene.tri_v0.shape[0] - 1)
        tri_normal = normalize(cross(scene.tri_e1[ti], scene.tri_e2[ti]))
        tri_m = scene.tri_mat[ti]
        if textured:
            bu, bv = _mt_bary(orig, dirn, scene.tri_v0[ti], scene.tri_e1[ti],
                              scene.tri_e2[ti])
            tri_uv = interpolate_uv(scene.tri_uv, ti, bu, bv)
        else:
            tri_uv = jnp.zeros((N, 2), jnp.float32)

    use_tri = tri_any  # already strictly closer than any sphere hit
    t = jnp.where(use_tri, tri_t, jnp.where(sph_any, sph_t, MISS_T))
    hit = use_tri | sph_any
    prim_kind = jnp.where(use_tri, TRIANGLE, SPHERE).astype(jnp.int32)
    prim_id = jnp.where(use_tri, tri_i, sph_i).astype(jnp.int32)

    # --- expand the winner into point/normal/material ---
    point = orig + dirn * t[:, None]
    sc = scene.spheres.center[jnp.clip(sph_i, 0, scene.spheres.count - 1)]
    sphere_normal = normalize(point - sc)
    normal = jnp.where(use_tri[:, None], tri_normal, sphere_normal)
    normal = jnp.where(hit[:, None], normal, 0.0)

    sph_mat = scene.spheres.material_id.astype(jnp.int32)[
        jnp.clip(sph_i, 0, scene.spheres.count - 1)]
    material_id = jnp.where(use_tri, tri_m, sph_mat)
    material_id = jnp.where(hit, material_id, jnp.int32(-1))

    if textured:
        uv = jnp.where(use_tri[:, None], tri_uv, sphere_uv(sphere_normal))
        uv = jnp.where(hit[:, None], uv, 0.0)
    else:
        uv = jnp.zeros((N, 2), jnp.float32)

    return Hit(
        t=jnp.where(hit, t, MISS_T),
        hit=hit,
        prim_kind=jnp.where(hit, prim_kind, jnp.int32(-1)),
        prim_id=jnp.where(hit, prim_id, jnp.int32(-1)),
        point=jnp.where(hit[:, None], point, 0.0),
        normal=normal,
        material_id=material_id,
        uv=uv,
    )


def occluded(scene: Scene, orig: jnp.ndarray, dirn: jnp.ndarray,
             max_t: jnp.ndarray, leaf_size: int | None = None,
             use_bvh: bool = True) -> jnp.ndarray:
    """Any-hit query for shadow rays: True where something blocks (MIN_T, max_t)."""
    leaf_size = max(leaf_size or 1, scene.bvh.max_leaf)
    N = orig.shape[0]
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (N,))
    s_t, s_hit = sphere_intersect(orig, dirn, scene.spheres.center,
                                  scene.spheres.radius, max_t)
    sph_block = jnp.any(s_hit, axis=-1)
    if use_bvh and scene.bvh.num_nodes > 1:
        tri_block = _traverse(scene, orig, dirn, max_t, leaf_size,
                              any_hit=True)[2]
    else:
        _, _, tri_block = _trace_triangles_brute(scene, orig, dirn, max_t)
    return sph_block | tri_block
