"""Packet (shared-cursor) BVH traversal in XLA — the CPU path.

Per-ray traversal (ops/bvh_traverse.py) gathers node data per lane every
step. This module traverses the tree with ONE cursor per *packet* of
coherent rays (vmapped over packets) and splits the work into two phases:

  * **collect**: slab-only traversal steps — one packed node-record gather
    per step plus a dense [P] AABB test; leaf ids are pushed into a small
    per-packet buffer. Internal-node steps never pay triangle-test cost.
  * **flush**: when the buffer fills (or traversal ends), the collected
    leaves' triangles are tested densely against the packet, and the
    winner's attributes (normal, material, barycentrics) are carried as the
    tested triangle's own values — no extraction gathers afterwards.

Results are bit-identical to per-ray traversal: a packet visits a superset of
each ray's nodes in the same left-first DFS order (the order of the
reference's stack traversal, shader/src/bvh.rs:40-85); a
triangle lies inside its leaf AABB, so a ray that would have culled the leaf
can never pass the triangle's own precise test; strict-< updates in visit
order preserve the reference's tie rule (earlier triangle wins at equal t).

Packet coherence comes from the renderer feeding pixels in tile order
(64x64 tiles): rays in a packet share origin and near-parallel directions,
so the union of visited nodes stays close to a single ray's set. The GPU
kernel (ops/traverse_kernel.py) is the same shared-cursor idea per 32-ray
block, without the collect/flush split.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.bvh import Bvh
from .intersect import MIN_T, MISS_T

_K = 64          # leaf ids collected per flush round


@partial(jax.jit, static_argnames=("leaf_size", "packet_size", "any_hit"))
def packet_traverse(
    bvh: Bvh,
    tri_v0: jnp.ndarray,
    tri_e1: jnp.ndarray,
    tri_e2: jnp.ndarray,
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    max_t: jnp.ndarray,
    tri_mat: jnp.ndarray | None = None,
    leaf_size: int = 4,
    packet_size: int = 1024,
    any_hit: bool = False,
):
    """Closest-hit (or any-hit) for N rays in packets of `packet_size`.

    N must be a multiple of packet_size (renderer pads).
    Returns (best_t [N], best_tri [N] leaf-order id or -1, hit [N],
    normal [N,3] geometric unit normal of the winner, mat [N] material id,
    bary [N,2] the winner's Möller-Trumbore barycentrics (v1,v2 weights)).
    normal/mat/bary are zeros/-1 for misses and in any_hit mode.
    """
    N = orig.shape[0]
    P = packet_size
    assert N % P == 0, f"ray count {N} not a multiple of packet size {P}"
    B = N // P
    Tp = tri_v0.shape[0]
    num_nodes = bvh.left.shape[0]
    max_iters = jnp.int32(num_nodes + 4)
    K = _K

    o = orig.reshape(B, P, 3)
    d = dirn.reshape(B, P, 3)
    inv_d = 1.0 / d
    mt = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (N,)).reshape(B, P)

    i2f = lambda x: jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.float32)
    f2i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)

    # Packed per-node record → ONE gather per traversal step:
    # [min.xyz, max.xyz, hit_link, miss_link, tri_start, leaf_count]
    node_rec = jnp.concatenate([
        bvh.node_min, bvh.node_max,
        i2f(bvh.hit_link)[:, None], i2f(bvh.miss_link)[:, None],
        i2f(bvh.tri_start)[:, None],
        i2f(jnp.where(bvh.left < 0, bvh.tri_count, 0))[:, None],
    ], axis=1)                                        # [nn, 10]

    if tri_mat is None:
        tri_mat = jnp.zeros((Tp,), jnp.int32)
    # Per-triangle record: v0, e1, e2, unit normal, material (bitcast).
    # Degenerate padding triangles get normal 0, not NaN.
    n_raw = jnp.cross(tri_e1, tri_e2)
    n_len = jnp.sqrt(jnp.sum(n_raw * n_raw, axis=-1, keepdims=True))
    tri_n = jnp.where(n_len > 0.0, n_raw / jnp.maximum(n_len, 1e-30), 0.0)
    tri_rec = jnp.concatenate([
        tri_v0, tri_e1, tri_e2, tri_n,
        i2f(tri_mat.astype(jnp.int32))[:, None],
    ], axis=1)                                        # [Tp, 13]

    def per_packet(o, d, inv_d, mt):
        def traverse_cond(state):
            cursor, buf, cnt, best_t, it = state
            return (cursor >= 0) & (cnt < K) & (it < max_iters)

        def traverse_body(state):
            cursor, buf, cnt, best_t, it = state
            rec = node_rec[cursor]                 # [10], one gather
            t1 = (rec[0:3][None, :] - o) * inv_d   # [P,3] dense
            t2 = (rec[3:6][None, :] - o) * inv_d
            tmin_max = jnp.max(jnp.minimum(t1, t2), axis=-1)
            tmax_min = jnp.min(jnp.maximum(t1, t2), axis=-1)
            ray_hit = ((tmax_min >= 0.0) & (tmin_max <= tmax_min)
                       & (jnp.maximum(tmin_max, 0.0) < best_t))
            hit_any = jnp.any(ray_hit)
            is_leaf = f2i(rec[9]) > 0
            push = hit_any & is_leaf
            buf = jnp.where(push, buf.at[cnt].set(cursor), buf)
            cnt = cnt + push.astype(jnp.int32)
            cursor = jnp.where(hit_any, f2i(rec[6]), f2i(rec[7]))
            return cursor, buf, cnt, best_t, it + 1

        def flush(buf, cnt, best):
            def one_leaf(k, carry):
                best_t, best_tri, best_n, best_m, best_uv = carry
                live = k < cnt
                rec = node_rec[buf[jnp.minimum(k, K - 1)]]
                tri_s = f2i(rec[8])
                leaf_c = f2i(rec[9])
                start = jnp.clip(tri_s, 0, Tp - leaf_size)
                block = jax.lax.dynamic_slice(tri_rec, (start, 0),
                                              (leaf_size, 13))
                for j in range(leaf_size):
                    v0 = block[j, 0:3]
                    e1 = block[j, 3:6]
                    e2 = block[j, 6:9]
                    # dense Möller-Trumbore, one shared triangle vs P rays —
                    # intermediates stay [P]-shaped, winner attributes are
                    # the triangle's own scalars (no extraction gathers)
                    h = jnp.cross(d, e2[None, :])
                    a = jnp.sum(e1[None, :] * h, axis=-1)
                    f = 1.0 / a
                    s = o - v0[None, :]
                    u = f * jnp.sum(s * h, axis=-1)
                    q = jnp.cross(s, e1[None, :])
                    v = f * jnp.sum(d * q, axis=-1)
                    t = f * jnp.sum(e2[None, :] * q, axis=-1)
                    tri_ok = (
                        (jnp.abs(a) >= MIN_T)
                        & (u >= 0.0) & (u <= 1.0)
                        & (v >= 0.0) & (u + v <= 1.0)
                        & (t > MIN_T) & (t < best_t)
                    )
                    in_leaf = (start + j >= tri_s) & (start + j < tri_s + leaf_c)
                    win = tri_ok & live & in_leaf
                    if any_hit:
                        win = win & (best_tri < 0)
                    best_t = jnp.where(win, t, best_t)
                    best_tri = jnp.where(win, start + j, best_tri)
                    best_n = jnp.where(win[:, None], block[j, 9:12][None, :],
                                       best_n)
                    best_m = jnp.where(win, f2i(block[j, 12]), best_m)
                    best_uv = jnp.where(win[:, None],
                                        jnp.stack([u, v], axis=-1), best_uv)
                return best_t, best_tri, best_n, best_m, best_uv

            return jax.lax.fori_loop(0, K, one_leaf, best)

        def round_cond(state):
            cursor, best, it = state
            done = cursor < 0
            if any_hit:
                done = done | jnp.all(best[1] >= 0)
            return ~done & (it < max_iters)

        def round_body(state):
            cursor, best, it = state
            buf0 = jnp.zeros((K,), jnp.int32)
            cursor, buf, cnt, _, it = jax.lax.while_loop(
                traverse_cond, traverse_body,
                (cursor, buf0, jnp.int32(0), best[0], it))
            best = flush(buf, cnt, best)
            return cursor, best, it

        best0 = (mt, jnp.full((P,), -1, jnp.int32),
                 jnp.zeros((P, 3), jnp.float32), jnp.full((P,), -1, jnp.int32),
                 jnp.zeros((P, 2), jnp.float32))
        _, best, _ = jax.lax.while_loop(
            round_cond, round_body, (jnp.int32(0), best0, jnp.int32(0)))
        return best

    best_t, best_tri, best_n, best_m, best_uv = jax.vmap(per_packet)(
        o, d, inv_d, mt)
    best_t = best_t.reshape(N)
    best_tri = best_tri.reshape(N)
    hit = best_tri >= 0
    normal = jnp.where(hit[:, None], best_n.reshape(N, 3), 0.0)
    mat = jnp.where(hit, best_m.reshape(N), -1)
    bary = jnp.where(hit[:, None], best_uv.reshape(N, 2), 0.0)
    return jnp.where(hit, best_t, MISS_T), best_tri, hit, normal, mat, bary


def tiled_pixel_order(width: int, height: int, tile: int = 32):
    """Pixel coordinates in tile-major order for packet coherence.

    Returns (px [n], py [n]) covering a tile-padded frame (n >= W*H, extra
    lanes clamp to the last pixel); callers scatter results back with
    fb[py, px] = rgb, so duplicate clamped lanes just overwrite identically.
    """
    tx = -(-width // tile)
    ty = -(-height // tile)
    gy, gx = np.mgrid[0:tile, 0:tile]
    px_list = []
    py_list = []
    for t_y in range(ty):
        for t_x in range(tx):
            px_list.append(np.minimum(t_x * tile + gx.reshape(-1), width - 1))
            py_list.append(np.minimum(t_y * tile + gy.reshape(-1), height - 1))
    return (np.concatenate(px_list).astype(np.int32),
            np.concatenate(py_list).astype(np.int32))
