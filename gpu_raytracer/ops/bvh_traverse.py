"""Vectorised BVH traversal.

The XLA re-design of the reference's per-thread DFS traversal
(shader/src/bvh.rs:18-133): same algorithm — explicit stack,
root-first, AABB reject at pop, leaf ranges tested with Möller-Trumbore,
closest-t threaded through — but run for a whole ray *batch* in lockstep.
Per-ray state (stack, stack pointer, best hit) lives in [N,...] arrays; each
`lax.while_loop` step pops one node per ray, gathers node data, and either
tests a leaf's triangle range (contiguous thanks to leaf-ordered triangles)
or pushes children. Finished rays idle behind masks until all lanes drain.

Differences from the reference, both result-identical:
  * best-t pruning on the AABB entry distance (any contained triangle has
    t >= entry, and the triangle test is strict `<`, so culling entry > best_t
    cannot change the winner);
  * the triangle-index indirection (bvh.rs:113) is pre-folded by reordering
    triangles into leaf order at scene-prep.

Stack depth 64 and the push-right-then-left (left-first) order match
bvh.rs:35-38 and bvh.rs:74-83.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.bvh import Bvh
from .intersect import MIN_T, MISS_T, aabb_intersect
from .linalg import cross


def _triangle_hit_pairwise(orig, dirn, v0, e1, e2, max_t):
    """Möller-Trumbore, one triangle per ray (all args [N,...])."""
    h = cross(dirn, e2)
    a = jnp.sum(e1 * h, axis=-1)
    f = 1.0 / a
    s = orig - v0
    u = f * jnp.sum(s * h, axis=-1)
    q = cross(s, e1)
    v = f * jnp.sum(dirn * q, axis=-1)
    t = f * jnp.sum(e2 * q, axis=-1)
    hit = (
        (jnp.abs(a) >= MIN_T)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > MIN_T) & (t < max_t)
    )
    return jnp.where(hit, t, MISS_T), hit


@partial(jax.jit, static_argnames=("leaf_size", "stack_depth", "any_hit"))
def bvh_traverse(
    bvh: Bvh,
    tri_v0: jnp.ndarray,
    tri_e1: jnp.ndarray,
    tri_e2: jnp.ndarray,
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    max_t: jnp.ndarray,
    leaf_size: int = 4,
    stack_depth: int = 64,
    any_hit: bool = False,
):
    """Closest-hit (or any-hit) traversal for a ray batch.

    Returns (best_t [N], best_tri [N] i32 leaf-order id or -1, hit [N] bool).
    For any_hit=True, terminates rays at the first accepted hit (shadow rays).
    """
    N = orig.shape[0]
    Tp = tri_v0.shape[0]
    rows = jnp.arange(N)

    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (N,))
    stack = jnp.zeros((N, stack_depth), jnp.int32)
    sp = jnp.ones((N,), jnp.int32)  # root (node 0) pre-pushed
    best_t = max_t
    best_tri = jnp.full((N,), -1, jnp.int32)

    num_nodes = bvh.left.shape[0]
    # Worst-case pop count: every node visited once per ray.
    max_iters = jnp.int32(2 * num_nodes + stack_depth + 4)

    def cond(state):
        sp, _, _, _, it = state
        return jnp.any(sp > 0) & (it < max_iters)

    def body(state):
        sp, stack, best_t, best_tri, it = state
        active = sp > 0
        if any_hit:
            active = active & (best_tri < 0)
        top = jnp.maximum(sp - 1, 0)
        node = stack[rows, top]
        sp = jnp.where(sp > 0, sp - 1, 0)  # pop unconditionally when nonempty
        node = jnp.where(active, node, 0)

        nmin = bvh.node_min[node]
        nmax = bvh.node_max[node]
        box_hit, entry = aabb_intersect(orig, dirn, nmin, nmax)
        visit = active & box_hit & (entry <= best_t)

        left = bvh.left[node]
        right = bvh.right[node]
        tri_s = bvh.tri_start[node]
        tri_c = bvh.tri_count[node]
        is_leaf = left < 0
        do_leaf = visit & is_leaf

        # --- leaf: test up to leaf_size contiguous triangles (static unroll) ---
        for k in range(leaf_size):
            idx = jnp.clip(tri_s + k, 0, Tp - 1)
            lane = do_leaf & (k < tri_c)
            v0 = tri_v0[idx]
            e1 = tri_e1[idx]
            e2 = tri_e2[idx]
            t, hit = _triangle_hit_pairwise(orig, dirn, v0, e1, e2, best_t)
            win = lane & hit  # t < best_t is already strict inside the test
            best_t = jnp.where(win, t, best_t)
            best_tri = jnp.where(win, idx.astype(jnp.int32), best_tri)

        # --- internal: push right then left (left-first traversal) ---
        do_push = visit & ~is_leaf
        can1 = do_push & (sp < stack_depth - 1) & (right >= 0)
        stack = stack.at[rows, jnp.minimum(sp, stack_depth - 1)].set(
            jnp.where(can1, right, stack[rows, jnp.minimum(sp, stack_depth - 1)])
        )
        sp = sp + can1.astype(jnp.int32)
        can2 = do_push & (sp < stack_depth - 1) & (left >= 0)
        stack = stack.at[rows, jnp.minimum(sp, stack_depth - 1)].set(
            jnp.where(can2, left, stack[rows, jnp.minimum(sp, stack_depth - 1)])
        )
        sp = sp + can2.astype(jnp.int32)

        if any_hit:
            sp = jnp.where(best_tri >= 0, 0, sp)  # drain finished shadow rays

        return sp, stack, best_t, best_tri, it + 1

    sp, stack, best_t, best_tri, _ = jax.lax.while_loop(
        cond, body, (sp, stack, best_t, best_tri, jnp.int32(0))
    )
    hit = best_tri >= 0
    return jnp.where(hit, best_t, MISS_T), best_tri, hit


@partial(jax.jit, static_argnames=("leaf_size", "any_hit"))
def bvh_traverse_threaded(
    bvh: Bvh,
    tri_v0: jnp.ndarray,
    tri_e1: jnp.ndarray,
    tri_e2: jnp.ndarray,
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    max_t: jnp.ndarray,
    leaf_size: int = 4,
    any_hit: bool = False,
):
    """Stackless threaded traversal — the default, faster path.

    Same visit order and results as :func:`bvh_traverse` (left-first DFS,
    strict-< closest-hit pruning), but per-ray state is a single node index
    advanced through precomputed hit/miss links: each step is a handful of
    dense gathers and zero scatters. A ray is done when its cursor reaches
    -1. The GPU kernel (ops/traverse_kernel.py) walks the same links.
    """
    N = orig.shape[0]
    Tp = tri_v0.shape[0]

    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (N,))
    node = jnp.zeros((N,), jnp.int32)  # everyone starts at the root
    best_t = max_t
    best_tri = jnp.full((N,), -1, jnp.int32)

    num_nodes = bvh.left.shape[0]
    max_iters = jnp.int32(num_nodes + 4)
    inv_d = 1.0 / dirn  # hoisted out of the loop

    def cond(state):
        node, _, _, it = state
        return jnp.any(node >= 0) & (it < max_iters)

    def body(state):
        node, best_t, best_tri, it = state
        live = node >= 0
        n_idx = jnp.maximum(node, 0)

        nmin = bvh.node_min[n_idx]
        nmax = bvh.node_max[n_idx]
        t1 = (nmin - orig) * inv_d
        t2 = (nmax - orig) * inv_d
        tmin_max = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tmax_min = jnp.min(jnp.maximum(t1, t2), axis=-1)
        box_hit = (tmax_min >= 0.0) & (tmin_max <= tmax_min) & (tmin_max <= best_t)
        box_hit = box_hit & live

        is_leaf = bvh.left[n_idx] < 0
        tri_s = bvh.tri_start[n_idx]
        tri_c = bvh.tri_count[n_idx]
        do_leaf = box_hit & is_leaf

        for k in range(leaf_size):
            idx = jnp.clip(tri_s + k, 0, Tp - 1)
            lane = do_leaf & (k < tri_c)
            t, hit = _triangle_hit_pairwise(
                orig, dirn, tri_v0[idx], tri_e1[idx], tri_e2[idx], best_t)
            win = lane & hit
            best_t = jnp.where(win, t, best_t)
            best_tri = jnp.where(win, idx.astype(jnp.int32), best_tri)

        nxt = jnp.where(box_hit, bvh.hit_link[n_idx], bvh.miss_link[n_idx])
        node = jnp.where(live, nxt, node)
        if any_hit:
            node = jnp.where(best_tri >= 0, -1, node)
        return node, best_t, best_tri, it + 1

    node, best_t, best_tri, _ = jax.lax.while_loop(
        cond, body, (node, best_t, best_tri, jnp.int32(0)))
    hit = best_tri >= 0
    return jnp.where(hit, best_t, MISS_T), best_tri, hit
