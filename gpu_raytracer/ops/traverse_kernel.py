"""BVH traversal kernel for the GPU (Pallas, Triton route).

The reference traces one ray per compute-shader thread with a private DFS
stack (shader/src/bvh.rs:18-133). Here a block of 32 rays
(one warp) walks the threaded (skip-pointer) layout of models/bvh.py with
ONE shared cursor: the cursor's node is tested against every ray of the
block, and the block enters it when any ray hits it (hit_link: left child,
or past a leaf), else skips it (miss_link). That is the reference's
left-first DFS order without a stack, each ray keeping its own closest t
(strict `<`), so every ray's winner is the one ops/bvh_traverse.py's
`bvh_traverse_threaded` picks. Node and triangle records stay in device
memory — the cursor's record is a broadcast load, served by L1/L2 — and a
step whose node is not a hit leaf skips the triangle loads.

On an H100 this shape beat a per-ray cursor (each lane walking the tree on
its own, with gathered node loads) on coherent primary and shadow rays and
tied it on incoherent bounces; 32-ray blocks beat 64 and 128 for both.

Returns (t, tri, hit, bary) like the threaded XLA traversal plus the
winner's Möller-Trumbore barycentrics; ops/trace.py expands normal,
material and uv from the winner id.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.bvh import Bvh
from .intersect import MIN_T, MISS_T

_MIN_T = float(MIN_T)  # a Python scalar: kernels cannot capture jnp constants
BLOCK = 32  # rays per program: one warp


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _slab(bmin, bmax, o, inv_d, best_t):
    """The threaded traversal's AABB test (ops/bvh_traverse.py)."""
    t1 = [(bmin[a] - o[a]) * inv_d[a] for a in range(3)]
    t2 = [(bmax[a] - o[a]) * inv_d[a] for a in range(3)]
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t1[0], t2[0]),
                                   jnp.minimum(t1[1], t2[1])),
                       jnp.minimum(t1[2], t2[2]))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t1[0], t2[0]),
                                   jnp.maximum(t1[1], t2[1])),
                       jnp.maximum(t1[2], t2[2]))
    return (tmax >= 0.0) & (tmin <= tmax) & (tmin <= best_t)


def _moller_trumbore(o, d, v0, e1, e2, best_t):
    """Möller-Trumbore against one triangle per lane → (ok, t, u, v)."""
    hx = d[1] * e2[2] - d[2] * e2[1]
    hy = d[2] * e2[0] - d[0] * e2[2]
    hz = d[0] * e2[1] - d[1] * e2[0]
    a = e1[0] * hx + e1[1] * hy + e1[2] * hz
    f = 1.0 / a
    sx, sy, sz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = f * (d[0] * qx + d[1] * qy + d[2] * qz)
    t = f * (e2[0] * qx + e2[1] * qy + e2[2] * qz)
    ok = ((jnp.abs(a) >= _MIN_T) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > _MIN_T) & (t < best_t))
    return ok, t, u, v


def _kernel(nf_ref, ni_ref, tri_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref,
            dz_ref, mt_ref, t_ref, id_ref, u_ref, v_ref, *, max_leaf,
            max_iters, any_hit, num_tris):
    """One block of BLOCK rays: node tables nf [nn,6] (min, max) and ni
    [nn,4] (hit link, miss link, tri start, leaf count), triangle table
    [Tp,9] (v0, e1, e2); ray columns and max_t in, (t, id, u, v) out."""
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    inv_d = tuple(1.0 / c for c in d)
    mt = mt_ref[...]
    zero = jnp.zeros_like(mt)
    # scalar selects are written as integer arithmetic (the Triton lowering
    # of a scalar `where` mixes i1 and i32)
    cursor0 = _any(mt > 0.0).astype(jnp.int32) - 1

    def leaf_test(box, ts, tc, best):
        bt, bi, bu, bv = best
        for k in range(max_leaf):
            idx = jnp.minimum(ts + k, num_tris - 1)
            v0 = tuple(tri_ref[idx, c] for c in range(3))
            e1 = tuple(tri_ref[idx, c] for c in range(3, 6))
            e2 = tuple(tri_ref[idx, c] for c in range(6, 9))
            ok, t, u, v = _moller_trumbore(o, d, v0, e1, e2, bt)
            win = box & ok & (k < tc)
            bt = jnp.where(win, t, bt)
            bi = jnp.where(win, idx, bi)
            bu = jnp.where(win, u, bu)
            bv = jnp.where(win, v, bv)
        return bt, bi, bu, bv

    def cond(state):
        cursor, bi, it = state[0], state[2], state[-1]
        go = (cursor >= 0) & (it < max_iters)
        if any_hit:
            go = go & _any((bi < 0) & (mt > 0.0))
        return go

    def body(state):
        cursor, bt, bi, bu, bv, it = state
        bmin = tuple(nf_ref[cursor, c] for c in range(3))
        bmax = tuple(nf_ref[cursor, c] for c in range(3, 6))
        box = _slab(bmin, bmax, o, inv_d, bt)
        if any_hit:
            box = box & (bi < 0)
        hit_any = _any(box)
        hit_l, miss_l = ni_ref[cursor, 0], ni_ref[cursor, 1]
        ts, tc = ni_ref[cursor, 2], ni_ref[cursor, 3]
        bt, bi, bu, bv = jax.lax.cond(
            hit_any & (tc > 0), lambda b: leaf_test(box, ts, tc, b),
            lambda b: b, (bt, bi, bu, bv))
        cursor = miss_l + (hit_l - miss_l) * hit_any.astype(jnp.int32)
        return cursor, bt, bi, bu, bv, it + 1

    init = (cursor0, mt, jnp.full(mt.shape, -1, jnp.int32), zero, zero,
            jnp.int32(0))
    _, bt, bi, bu, bv, _ = jax.lax.while_loop(cond, body, init)
    t_ref[...] = bt
    id_ref[...] = bi
    u_ref[...] = bu
    v_ref[...] = bv


@partial(jax.jit, static_argnames=("leaf_size", "any_hit", "interpret"))
def kernel_traverse(bvh: Bvh, tri_v0, tri_e1, tri_e2, orig, dirn, max_t, *,
                    leaf_size: int, any_hit: bool = False,
                    interpret: bool = False):
    """Closest-hit (or any-hit) for N rays of any count (padded to BLOCK).

    Returns (t [N] MISS_T on miss, tri [N] leaf-order id or -1, hit [N],
    bary [N,2] the winner's (v1, v2) weights, zeros on miss). `leaf_size`
    must cover the BVH's fullest leaf. `interpret` runs the kernel in the
    Pallas interpreter (CPU tests only)."""
    N = orig.shape[0]
    Np = -(-N // BLOCK) * BLOCK
    pad = Np - N
    mt = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (N,))

    def col(x, fill):
        return jnp.pad(x, (0, pad), constant_values=fill) if pad else x

    rays = ([col(orig[:, a], 0.0) for a in range(3)]
            + [col(dirn[:, a], 1.0) for a in range(3)] + [col(mt, 0.0)])
    leafc = jnp.where(bvh.left < 0, bvh.tri_count, 0)
    nf = jnp.concatenate([bvh.node_min, bvh.node_max], axis=1)     # [nn,6]
    ni = jnp.stack([bvh.hit_link, bvh.miss_link, bvh.tri_start, leafc],
                   axis=1).astype(jnp.int32)                       # [nn,4]
    tri = jnp.concatenate([tri_v0, tri_e1, tri_e2], axis=1)        # [Tp,9]

    kernel = partial(_kernel, max_leaf=leaf_size,
                     max_iters=bvh.left.shape[0] + 4, any_hit=any_hit,
                     num_tris=tri.shape[0])
    lanes = pl.BlockSpec((BLOCK,), lambda i: (i,))
    out = pl.pallas_call(
        kernel,
        grid=(Np // BLOCK,),
        in_specs=[pl.no_block_spec] * 3 + [lanes] * 7,
        out_specs=[lanes] * 4,
        out_shape=[jax.ShapeDtypeStruct((Np,), jnp.float32),
                   jax.ShapeDtypeStruct((Np,), jnp.int32),
                   jax.ShapeDtypeStruct((Np,), jnp.float32),
                   jax.ShapeDtypeStruct((Np,), jnp.float32)],
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="bvh_traverse",
    )(nf, ni, tri, *rays)
    t, tri_id, u, v = (x[:N] for x in out)
    hit = tri_id >= 0
    bary = jnp.where(hit[:, None], jnp.stack([u, v], axis=-1), 0.0)
    return jnp.where(hit, t, MISS_T), tri_id, hit, bary
