"""On-device LBVH construction (SURVEY.md §7 P5 — the north star).

Replaces the host-side BVH build (src/bvh.rs:104-151, which
keeps the CPU in the per-frame loop) with a fully on-device pipeline so the
fly-through config can refit/rebuild every frame without host round-trips:

  1. Morton codes: triangle centroids quantised to 10 bits/axis, interleaved
     (vectorised magic-number bit spreading);
  2. sort: XLA's on-device sort over the codes;
  3. Karras (2012)-style hierarchy: every internal node's range, direction
     and split are found independently via longest-common-prefix queries —
     perfectly parallel, no sequential splitting;
  4. bottom-up AABB refit by repeated child-gather sweeps;
  5. threaded hit/miss links by parent-pointer jumping, so the result drops
     straight into the packet/threaded traversal kernels.

Node layout matches models.bvh.Bvh: [2T-1] nodes, root = node 0 (internal
nodes 0..T-2, leaves T-1..2T-2, leaf p covers sorted position p with
tri_count=1 — trace with leaf_size=1).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..models.bvh import Bvh


def expand_bits_10(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of v so they occupy every 3rd bit (u32)."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton_codes(centroids: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray):
    """30-bit Morton codes for [T,3] centroids within bounds lo/hi [3]."""
    x = jnp.clip((centroids - lo) / jnp.maximum(hi - lo, 1e-9), 0.0, 1.0)
    q = jnp.minimum((x * 1024.0).astype(jnp.uint32), 1023)
    return (expand_bits_10(q[:, 0]) << 2) | (expand_bits_10(q[:, 1]) << 1) \
        | expand_bits_10(q[:, 2])


def _nlz32(v: jnp.ndarray) -> jnp.ndarray:
    """Count leading zeros of u32 (0 → 32): smear the MSB down, popcount."""
    v = v.astype(jnp.uint32)
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    return (32 - jax.lax.population_count(v).astype(jnp.int32)).astype(jnp.int32)


def _karras_from_codes(codes: jnp.ndarray, leaf_min: jnp.ndarray,
                       leaf_max: jnp.ndarray):
    """Karras hierarchy over L PRE-SORTED leaf codes with AABBs [L,3].

    Returns (node_min, node_max, left, right, hit, miss) over 2L-1 nodes:
    internal nodes 0..L-2 (root 0), leaf for sorted position p at L-1+p.
    """
    T = codes.shape[0]
    n_internal = T - 1
    n_nodes = 2 * T - 1
    n_steps = max(int(math.ceil(math.log2(max(T, 2)))) + 2, 2)
    sweeps = min(max(4 * n_steps, 8), 128)

    def delta(i, j):
        """Common-prefix length of sorted codes i and j ([Karras 2012] §4),
        index bits breaking ties between equal codes; -1 out of range."""
        valid = (j >= 0) & (j < T)
        cj = codes[jnp.clip(j, 0, T - 1)]
        ci = codes[i]
        x = ci ^ cj
        ix = i.astype(jnp.uint32) ^ j.astype(jnp.uint32)
        d = jnp.where(x == 0, 32 + _nlz32(ix), _nlz32(x))
        return jnp.where(valid, d, jnp.int32(-1))

    i = jnp.arange(n_internal, dtype=jnp.int32)

    # direction and minimum prefix just outside the range
    d = jnp.where(delta(i, i + 1) >= delta(i, i - 1), 1, -1).astype(jnp.int32)
    delta_min = delta(i, i - d)

    # upper bound for the range length by galloping
    def gallop_body(carry):
        lmax, _ = carry
        nxt = lmax * 2
        grow = delta(i, i + nxt * d) > delta_min
        lmax = jnp.where(grow, nxt, lmax)
        return lmax, jnp.any(grow) & (jnp.max(lmax) < 2 * T)

    lmax, _ = jax.lax.while_loop(
        lambda c: c[1], gallop_body,
        (jnp.full((n_internal,), 2, jnp.int32), jnp.bool_(True)))
    lmax = lmax * 2

    # binary search for the exact length l
    def len_body(t, carry):
        l, step = carry
        step = jnp.maximum(step // 2, 1)
        ok = delta(i, i + (l + step) * d) > delta_min
        return jnp.where(ok, l + step, l), step

    l, _ = jax.lax.fori_loop(0, n_steps + 2, len_body,
                             (jnp.zeros_like(i), lmax))
    j = i + l * d
    delta_node = delta(i, j)

    # binary search for the split point gamma
    def split_body(t, carry):
        s, step = carry
        step = (step + 1) // 2
        probe = s + step * d
        ok = (jnp.abs(probe - i) < l) & (delta(i, probe) > delta_node)
        return jnp.where(ok, probe, s), jnp.maximum(step, 1)

    s, _ = jax.lax.fori_loop(0, n_steps + 2, split_body, (i, l))
    gamma = jnp.minimum(s, s + d)

    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    left_is_leaf = first == gamma
    right_is_leaf = last == gamma + 1
    left_child = jnp.where(left_is_leaf, n_internal + gamma, gamma).astype(jnp.int32)
    right_child = jnp.where(right_is_leaf, n_internal + gamma + 1,
                            gamma + 1).astype(jnp.int32)

    left = jnp.concatenate([left_child, jnp.full((T,), -1, jnp.int32)])
    right = jnp.concatenate([right_child, jnp.full((T,), -1, jnp.int32)])

    parent = jnp.full((n_nodes,), -1, jnp.int32)
    parent = parent.at[left_child].set(i)
    parent = parent.at[right_child].set(i)

    # bottom-up AABB refit: repeated child-gather sweeps converge once the
    # sweep count reaches the tree depth (bounded by `sweeps`)
    big = jnp.float32(3.0e38)
    node_min = jnp.concatenate([jnp.full((n_internal, 3), big), leaf_min])
    node_max = jnp.concatenate([jnp.full((n_internal, 3), -big), leaf_max])

    def refit_body(t, carry):
        nmin, nmax = carry
        new_min = jnp.minimum(nmin[left_child], nmin[right_child])
        new_max = jnp.maximum(nmax[left_child], nmax[right_child])
        return (jax.lax.dynamic_update_slice(nmin, new_min, (0, 0)),
                jax.lax.dynamic_update_slice(nmax, new_max, (0, 0)))

    node_min, node_max = jax.lax.fori_loop(0, sweeps, refit_body,
                                           (node_min, node_max))

    # threaded links: left children point at their sibling; right children
    # inherit the parent's miss — resolved by parent-chain jumping
    is_left = jnp.zeros((n_nodes,), bool).at[left_child].set(True)
    sibling = jnp.zeros((n_nodes,), jnp.int32).at[left_child].set(right_child)
    miss = jnp.where(is_left, sibling, jnp.int32(-2))
    miss = miss.at[0].set(-1)

    def links_body(t, miss):
        pulled = miss[jnp.maximum(parent, 0)]
        fill = jnp.where(parent >= 0, pulled, jnp.int32(-1))
        return jnp.where((miss == -2) & (fill != -2), fill, miss)

    miss = jax.lax.fori_loop(0, sweeps, links_body, miss)
    miss = jnp.where(miss == -2, -1, miss)
    hit = jnp.where(left >= 0, left, miss).astype(jnp.int32)

    return node_min, node_max, left, right, hit, miss.astype(jnp.int32)


@jax.jit
def build_lbvh_arrays(tri_min: jnp.ndarray, tri_max: jnp.ndarray):
    """Device LBVH from per-triangle AABBs [T,3]/[T,3]; T >= 2.

    Returns (node_min, node_max, left, right, tri_start, tri_count,
    hit_link, miss_link, order) — nodes [2T-1]; `order` [T] maps sorted-leaf
    position → original triangle index. One triangle per leaf.
    """
    T = tri_min.shape[0]
    n_internal = T - 1

    cent = 0.5 * (tri_min + tri_max)
    lo = jnp.min(tri_min, axis=0)
    hi = jnp.max(tri_max, axis=0)
    codes = morton_codes(cent, lo, hi)
    order = jnp.argsort(codes).astype(jnp.int32)

    node_min, node_max, left, right, hit, miss = _karras_from_codes(
        codes[order], tri_min[order], tri_max[order])
    tri_start = jnp.concatenate([jnp.zeros((n_internal,), jnp.int32),
                                 jnp.arange(T, dtype=jnp.int32)])
    tri_count = jnp.concatenate([jnp.zeros((n_internal,), jnp.int32),
                                 jnp.ones((T,), jnp.int32)])
    return (node_min, node_max, left, right, tri_start, tri_count,
            hit, miss, order)


@jax.jit
def build_lbvh_grouped_arrays(tri_min: jnp.ndarray, tri_max: jnp.ndarray):
    """Device LBVH with 8-triangle leaves (a quarter of the nodes of the
    1-triangle build below, and a leaf test of 8 contiguous triangles).

    The Karras tree is built over GROUPS of 8 Morton-consecutive triangles:
    group g's leaf covers sorted positions [8g, 8g+8) (the tail group is
    padded with degenerate slots), its AABB is the member union (a fixed
    -stride segmented reduce — no rebuild needed), and its code is its first
    member's. Subtree ranges are contiguous in sorted order, so collapsing
    to 8-slot leaves only reshapes the leaf level.

    Returns (node_min, node_max, left, right, tri_start, tri_count,
    hit_link, miss_link, order) — nodes [2G-1], G = ceil(T/8); `order` [T]
    maps sorted position → original triangle index; leaf g has
    tri_start = 8g, tri_count = 8 (padding slots are degenerate no-hit
    triangles).
    """
    GROUP = 8
    T = tri_min.shape[0]
    G = -(-T // GROUP)
    pad = G * GROUP - T

    cent = 0.5 * (tri_min + tri_max)
    lo = jnp.min(tri_min, axis=0)
    hi = jnp.max(tri_max, axis=0)
    codes = morton_codes(cent, lo, hi)
    order = jnp.argsort(codes).astype(jnp.int32)

    big = jnp.float32(3.0e38)
    smin = tri_min[order]
    smax = tri_max[order]
    if pad:
        smin = jnp.concatenate([smin, jnp.full((pad, 3), big)])
        smax = jnp.concatenate([smax, jnp.full((pad, 3), -big)])
    gmin = smin.reshape(G, GROUP, 3).min(axis=1)
    gmax = smax.reshape(G, GROUP, 3).max(axis=1)
    gcodes = codes[order][::GROUP]   # group start is always a real triangle

    if G == 1:
        node_min, node_max = gmin, gmax
        left = jnp.full((1,), -1, jnp.int32)
        right = jnp.full((1,), -1, jnp.int32)
        hit = jnp.full((1,), -1, jnp.int32)
        miss = jnp.full((1,), -1, jnp.int32)
        tri_start = jnp.zeros((1,), jnp.int32)
        tri_count = jnp.full((1,), GROUP, jnp.int32)
        return (node_min, node_max, left, right, tri_start, tri_count,
                hit, miss, order)

    node_min, node_max, left, right, hit, miss = _karras_from_codes(
        gcodes, gmin, gmax)
    n_internal = G - 1
    tri_start = jnp.concatenate([
        jnp.zeros((n_internal,), jnp.int32),
        (jnp.arange(G, dtype=jnp.int32) * GROUP)])
    tri_count = jnp.concatenate([jnp.zeros((n_internal,), jnp.int32),
                                 jnp.full((G,), GROUP, jnp.int32)])
    return (node_min, node_max, left, right, tri_start, tri_count,
            hit, miss, order)


def lbvh_from_mesh_device(vertices: jnp.ndarray, indices: jnp.ndarray,
                          material_id: jnp.ndarray, group: int = 1):
    """Full on-device pipeline: mesh arrays → (Bvh, tri_v0, tri_e1, tri_e2,
    tri_mat) in sorted-leaf order, ready for the traversal kernels.

    group=1: Karras 1-triangle leaves. group=8: 8-slot leaves (triangle
    arrays are padded to 8·ceil(T/8) with degenerate slots)."""
    idx = indices.astype(jnp.int32)
    a = vertices[idx[:, 0]]
    b = vertices[idx[:, 1]]
    c = vertices[idx[:, 2]]
    tri_min = jnp.minimum(a, jnp.minimum(b, c))
    tri_max = jnp.maximum(a, jnp.maximum(b, c))
    build = build_lbvh_arrays if group == 1 else build_lbvh_grouped_arrays
    (nmin, nmax, left, right, tri_start, tri_count, hit, miss,
     order) = build(tri_min, tri_max)
    bvh = Bvh(node_min=nmin, node_max=nmax, left=left, right=right,
              tri_start=tri_start, tri_count=tri_count,
              hit_link=hit, miss_link=miss, max_leaf=group)
    v0 = a[order]
    e1 = b[order] - v0
    e2 = c[order] - v0
    mat = material_id.astype(jnp.int32)[order]
    T = v0.shape[0]
    pad = (-T) % group
    if pad:
        z = jnp.zeros((pad, 3), jnp.float32)
        v0 = jnp.concatenate([v0, z])
        e1 = jnp.concatenate([e1, z])   # zero edges → det 0 → no hit
        e2 = jnp.concatenate([e2, z])
        mat = jnp.concatenate([mat, jnp.zeros((pad,), jnp.int32)])
    return bvh, v0, e1, e2, mat
