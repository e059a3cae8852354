"""Multi-device rendering via shard_map.

Two orthogonal strategies (composable in principle, exposed separately):

* **Ray sharding** (data-parallel analogue): the pixel/ray batch is split
  along the mesh's ray axis; the scene pytree is replicated. No collectives
  in the hot loop — each device traces its own rays, the framebuffer comes back
  ray-sharded. This is the scaling mode for the tile/fly-through configs.

* **Geometry sharding** (tensor-parallel analogue): the triangles are
  Morton-partitioned into spatially compact shards, each device owns a
  sub-BVH over its shard (GeometryShards), traverses the full ray batch
  against it, and the per-ray closest hit is combined across devices with a
  lexicographic (t, original-triangle-id) argmin. This is the mode for
  scenes too big for one device's memory.

* **Ring geometry+ray sharding** (`trace_geometry_sharded_ring`): both at
  once — each device holds N/D rays AND one sub-BVH; ray blocks ppermute
  around the ring carrying their running winner, whose best-t prunes every
  later sub-BVH at the root. Per-device compute scales with D on coherent
  content, unlike the replicated-ray combine above.

The reference has no multi-device path at all (SURVEY.md §2.4: "Multi-chip:
absent in reference"); this layer is an extension. Per-shard traversal
runs the XLA packet traversal (ops/packet_trace.py) on every platform.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.scene import Scene
from ..ops.intersect import MISS_T, closest_select, sphere_intersect
from ..ops.trace import Hit, SPHERE, TRIANGLE
from ..ops.linalg import normalize
from .mesh import RAY_AXIS


def render_rays_sharded(scene: Scene, px: jnp.ndarray, py: jnp.ndarray,
                        width: int, height: int, mesh: Mesh,
                        leaf_size: int = 4, use_bvh: bool = True,
                        sky=(0.0, 0.0, 0.0)) -> jnp.ndarray:
    """Full trace+shade (engine/renderer.py::render_chunk) with the ray
    batch sharded across the mesh.

    px/py length must divide by the mesh size (pad at the caller).
    Returns RGB [N,3], ray-sharded.
    """

    from ..engine.renderer import render_chunk

    def shard_fn(scene_rep, pxs, pys):
        return render_chunk(scene_rep, pxs, pys, width, height,
                            use_bvh=use_bvh, leaf_size=leaf_size,
                            sky=tuple(sky))

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS), check_vma=False,
    )
    return jax.jit(fn)(scene, px, py)


class GeometryShards:
    """Host-built per-shard acceleration structures for geometry sharding.

    The mesh's triangles are partitioned into `n_shards` SPATIALLY COMPACT
    chunks (Morton order of centroids, split contiguously), each chunk gets
    its own SAH BVH + leaf-ordered expanded triangle table, and
    everything is padded to common shapes and stacked with a leading shard
    axis so `shard_map` can place one sub-BVH per device. Build once per
    scene; trace per frame. Per-device work is O(N·log(T/D)).
    """

    def __init__(self, scene: Scene, n_shards: int):
        from ..models.bvh import build_bvh
        from ..models.scene import _expand_triangles

        mesh = scene.mesh
        verts = np.asarray(mesh.vertices)
        idx = np.asarray(mesh.indices)
        mat_ids = np.asarray(mesh.material_id)
        uv = np.asarray(mesh.uv)
        T = idx.shape[0]
        self.n_shards = n_shards

        # Morton partition of triangle centroids → D contiguous chunks
        cent = (verts[idx[:, 0]] + verts[idx[:, 1]] + verts[idx[:, 2]]) / 3.0
        lo, hi = cent.min(0), cent.max(0)
        q = np.clip(((cent - lo) / np.maximum(hi - lo, 1e-9)
                     * 1024.0).astype(np.uint64), 0, 1023)
        code = np.zeros(T, np.uint64)
        for b in range(10):
            for a in range(3):
                code |= ((q[:, a] >> b) & 1) << np.uint64(3 * b + (2 - a))
        order = np.argsort(code, kind="stable")
        chunks = np.array_split(order, n_shards)

        nmins, nmaxs, lefts, rights, starts, counts, hits, misses = \
            [], [], [], [], [], [], [], []
        v0s, e1s, e2s, mats, uvs, gids = [], [], [], [], [], []
        self.max_leaf = 1
        for chunk in chunks:
            chunk = np.asarray(chunk, np.int64)
            # More shards than triangles: build over a stand-in triangle but
            # make the shard INERT (zero edges never pass Möller–Trumbore,
            # gid=INT_MAX never wins the pmin tie-break). Reusing triangle 0
            # live would duplicate it across shards with bit-identical t/gid,
            # and the masked-psum combine below would then sum its attributes
            # once per duplicate (doubled normals, garbage material ids).
            inert = chunk.size == 0
            if inert:
                chunk = np.asarray([0], np.int64)
            res = build_bvh(verts, idx[chunk], leaf_size=8)
            v0, e1, e2, m, tuv, _src = _expand_triangles(
                verts, idx[chunk], mat_ids[chunk], uv, res.tri_order, 8)
            ordr = np.asarray(res.tri_order, np.int64)
            gid = np.where(ordr < 0, np.int64(2**31 - 1),
                           chunk[np.where(ordr < 0, 0, ordr)])
            gid = np.concatenate([gid, np.full(v0.shape[0] - gid.shape[0],
                                               2**31 - 1, np.int64)])
            if inert:
                e1 = np.zeros_like(e1)
                e2 = np.zeros_like(e2)
                gid = np.full_like(gid, 2**31 - 1)
            dev = res.to_device()
            self.max_leaf = max(self.max_leaf, dev.max_leaf)
            nmins.append(np.asarray(dev.node_min))
            nmaxs.append(np.asarray(dev.node_max))
            lefts.append(np.asarray(dev.left))
            rights.append(np.asarray(dev.right))
            starts.append(np.asarray(dev.tri_start))
            counts.append(np.asarray(dev.tri_count))
            hits.append(np.asarray(dev.hit_link))
            misses.append(np.asarray(dev.miss_link))
            v0s.append(v0)
            e1s.append(e1)
            e2s.append(e2)
            mats.append(m)
            uvs.append(tuv)
            gids.append(gid.astype(np.int32))

        big = np.float32(3.0e38)
        Nn = max(a.shape[0] for a in lefts)
        Tp = max(a.shape[0] for a in v0s)

        def pad_nodes(a, fill, width=None):
            out = []
            for x in a:
                p = Nn - x.shape[0]
                if p:
                    shape = (p,) + x.shape[1:]
                    x = np.concatenate([x, np.full(shape, fill, x.dtype)])
                out.append(x)
            return jnp.asarray(np.stack(out))

        def pad_tris(a, fill):
            out = []
            for x in a:
                p = Tp - x.shape[0]
                if p:
                    shape = (p,) + x.shape[1:]
                    x = np.concatenate([x, np.full(shape, fill, x.dtype)])
                out.append(x)
            return jnp.asarray(np.stack(out))

        # padding nodes are unreachable leaves with INVERTED (empty) bounds
        self.node_min = pad_nodes(nmins, big)
        self.node_max = pad_nodes(nmaxs, -big)
        self.left = pad_nodes(lefts, -1)
        self.right = pad_nodes(rights, -1)
        self.tri_start = pad_nodes(starts, 0)
        self.tri_count = pad_nodes(counts, 0)
        self.hit_link = pad_nodes(hits, -1)
        self.miss_link = pad_nodes(misses, -1)
        self.tri_v0 = pad_tris(v0s, 0.0)
        self.tri_e1 = pad_tris(e1s, 0.0)   # zero edges → no hit
        self.tri_e2 = pad_tris(e2s, 0.0)
        self.tri_mat = pad_tris(mats, 0)
        self.tri_uv = pad_tris(uvs, 0.0)
        self.orig_id = pad_tris(gids, 2**31 - 1)

    def arrays(self):
        """The stacked per-shard tables in the order the shard_map
        programs take them."""
        return (self.node_min, self.node_max, self.left, self.right,
                self.tri_start, self.tri_count, self.hit_link,
                self.miss_link, self.tri_v0, self.tri_e1, self.tri_e2,
                self.tri_mat, self.tri_uv, self.orig_id)


def _shard_traverse(o, d, mt, nmin, nmax, left, right, ts_, tc_, hl, ml,
                    v0, e1, e2, tmat, tuv, packet_size, leaf_size):
    """Closest hit of a ray block against this device's sub-BVH (the
    [1,...] shard slices shard_map hands over) → (t, local id, hit,
    normal, mat, uv)."""
    from ..models.bvh import Bvh
    from ..ops.packet_trace import packet_traverse

    bvh = Bvh(node_min=nmin[0], node_max=nmax[0], left=left[0],
              right=right[0], tri_start=ts_[0], tri_count=tc_[0],
              hit_link=hl[0], miss_link=ml[0], max_leaf=leaf_size)
    t, i_loc, hit, nrm, mat, bary = packet_traverse(
        bvh, v0[0], e1[0], e2[0], o, d, mt, tri_mat=tmat[0],
        leaf_size=leaf_size, packet_size=packet_size)
    il = jnp.clip(i_loc, 0, tuv.shape[1] - 1)
    w0 = 1.0 - bary[:, 0] - bary[:, 1]
    uvt = tuv[0, il]                                   # [N,3,2]
    uv = (w0[:, None] * uvt[:, 0] + bary[:, 0:1] * uvt[:, 1]
          + bary[:, 1:2] * uvt[:, 2])
    return t, il, hit, nrm, mat, uv


@lru_cache(maxsize=32)
def _geom_shard_fn(mesh: Mesh, packet_size: int, leaf_size: int):
    """Build + jit the geometry-sharded trace ONCE per (mesh, statics):
    jax.jit caches on function identity, so constructing shard_fn inside
    every trace call would re-trace and re-compile per call."""
    SHARD = RAY_AXIS
    INT_MAX = jnp.int32(2**31 - 1)

    def shard_fn(o_rep, d_rep, nmin, nmax, left, right, ts_, tc_, hl, ml,
                 v0, e1, e2, tmat, tuv, gid):
        mt = jnp.full((o_rep.shape[0],), MISS_T - 2.0, jnp.float32)
        t, il, hit, nrm, mat, uv = _shard_traverse(
            o_rep, d_rep, mt, nmin, nmax, left, right, ts_, tc_, hl, ml,
            v0, e1, e2, tmat, tuv, packet_size, leaf_size)
        g = jnp.where(hit, gid[0, il], INT_MAX)
        # combine by reduction (no [D,N] gathers):
        tm = jnp.where(hit, t, MISS_T)
        tmin = jax.lax.pmin(tm, SHARD)                     # global closest t
        on_t = hit & (tm <= tmin)
        gwin = jax.lax.pmin(jnp.where(on_t, g, INT_MAX), SHARD)
        win = on_t & (g == gwin)                           # exactly one device
        wf = win.astype(jnp.float32)
        nrm_g = jax.lax.psum(nrm * wf[:, None], SHARD)
        uv_g = jax.lax.psum(uv * wf[:, None], SHARD)
        mat_g = jax.lax.psum(jnp.where(win, mat, 0), SHARD)
        hit_any = jax.lax.psum(hit.astype(jnp.int32), SHARD) > 0
        return tmin, gwin, nrm_g, mat_g, uv_g, hit_any

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P()) + (P(RAY_AXIS),) * 14,
        out_specs=(P(),) * 6, check_vma=False,
    )
    return jax.jit(fn)


@lru_cache(maxsize=32)
def _geom_ring_fn(mesh: Mesh, packet_size: int, leaf_size: int):
    """Ring-rotated geometry+ray sharding: rays are split into D home
    blocks of N/D; each block visits the D sub-BVHs by ppermute-ing around
    the ring (D hops → blocks end home), carrying a running (t, gid,
    normal, mat, uv) winner. The running best-t enters every later shard's
    traversal as the initial max-t, so a ray that already found its hit
    prunes distant sub-BVHs at their root (strict-< slab prune) — per-device
    traversal work scales down with D on spatially coherent content instead
    of every device traversing the FULL replicated batch (the scheme kept
    as `trace_geometry_sharded`).

    Tie semantics: an exactly-equal-t hit in a later shard does not replace
    the running winner (the max-t prune is strict); cross-shard ties
    therefore resolve to the earlier-visited shard rather than the lower
    original id. Real content hits this only on shared edges split across
    shards."""
    SHARD = RAY_AXIS
    INT_MAX = jnp.int32(2**31 - 1)
    n_dev = mesh.devices.size
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def shard_fn(o_blk, d_blk, nmin, nmax, left, right, ts_, tc_, hl, ml,
                 v0, e1, e2, tmat, tuv, gid):
        o, dd = o_blk, d_blk          # local ray block [N/D, 3]
        n = o.shape[0]
        bt = jnp.full((n,), MISS_T - 2.0, jnp.float32)
        bg = jnp.full((n,), INT_MAX)
        bn = jnp.zeros((n, 3), jnp.float32)
        bm = jnp.zeros((n,), jnp.int32)
        buv = jnp.zeros((n, 2), jnp.float32)
        bh = jnp.zeros((n,), bool)

        for _step in range(n_dev):
            t, il, hit, nrm, mat, uv = _shard_traverse(
                o, dd, bt, nmin, nmax, left, right, ts_, tc_, hl, ml,
                v0, e1, e2, tmat, tuv, packet_size, leaf_size)
            g = jnp.where(hit, gid[0, il], INT_MAX)
            better = hit & (t < bt)
            bt = jnp.where(better, t, bt)
            bg = jnp.where(better, g, bg)
            bn = jnp.where(better[:, None], nrm, bn)
            bm = jnp.where(better, mat, bm)
            buv = jnp.where(better[:, None], uv, buv)
            bh = bh | better
            # rotate the block (rays + running winner) to the next device;
            # after n_dev hops every block is back home with the global
            # winner on board (~13 words/ray/hop)
            o, dd, bt, bg, bn, bm, buv, bh = [
                jax.lax.ppermute(x, SHARD, perm)
                for x in (o, dd, bt, bg, bn, bm, buv, bh)]
        tmin = jnp.where(bh, bt, MISS_T)
        return tmin, bg, bn, bm, buv, bh

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(RAY_AXIS),) * 16,
        out_specs=(P(RAY_AXIS),) * 6, check_vma=False,
    )
    return jax.jit(fn)


def _packet_size(n: int) -> int:
    """Largest XLA traversal packet that divides the ray count."""
    return max(k for k in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1)
               if n % k == 0)


def _merge_spheres(scene: Scene, orig, dirn, tri_t, tri_g, tri_n, tri_m,
                   tri_uv, tri_hit) -> Hit:
    """Combine the (replicated, tiny) sphere pass with the sharded triangle
    winner — shared tail of both geometry-sharding schemes."""
    from ..ops.texture import sphere_uv

    s_t, s_hit = sphere_intersect(orig, dirn, scene.spheres.center,
                                  scene.spheres.radius, MISS_T - 2.0)
    sph_t, sph_i, sph_any = closest_select(s_t, s_hit)
    use_tri = tri_hit & (~sph_any | (tri_t < sph_t))
    t = jnp.where(use_tri, tri_t, jnp.where(sph_any, sph_t, MISS_T))
    hit = use_tri | sph_any
    point = orig + dirn * t[:, None]
    sc = scene.spheres.center[jnp.clip(sph_i, 0, scene.spheres.count - 1)]
    normal = jnp.where(use_tri[:, None], tri_n, normalize(point - sc))
    mat = jnp.where(use_tri, tri_m,
                    scene.spheres.material_id.astype(jnp.int32)[
                        jnp.clip(sph_i, 0, scene.spheres.count - 1)])
    uv = jnp.where(use_tri[:, None], tri_uv,
                   sphere_uv(normalize(point - sc)))
    return Hit(
        t=jnp.where(hit, t, MISS_T), hit=hit,
        prim_kind=jnp.where(use_tri, TRIANGLE, SPHERE).astype(jnp.int32),
        prim_id=jnp.where(use_tri, tri_g, sph_i).astype(jnp.int32),
        point=jnp.where(hit[:, None], point, 0.0),
        normal=jnp.where(hit[:, None], normal, 0.0),
        material_id=jnp.where(hit, mat, -1).astype(jnp.int32),
        uv=jnp.where(hit[:, None], uv, 0.0),
    )


def _coherence_perm(scene: Scene, orig, dirn):
    """Global coherence-sort permutation for a sharded trace: the same
    (direction octant | axis | origin Morton) key the wavefront engine
    sorts bounce pools by (its measured 13x lesson — ops/wavefront.py
    _sort_perm). Sorting is a pure permutation: per-ray results are
    unchanged (traversal is per-ray; the cross-device combine tie-breaks on
    (t, original-triangle-id), not ray order), but packets — and the ring
    mode's N/D blocks — become coherent, so the shared-cursor traversal
    stops paying for interleaved octants. Returns (perm, inv)."""
    from ..ops.wavefront import _sort_perm

    perm = _sort_perm(scene, orig, dirn,
                      jnp.ones((orig.shape[0],), bool))
    return perm, jnp.argsort(perm)


def _apply_hit_perm(hit: Hit, inv) -> Hit:
    return jax.tree_util.tree_map(lambda a: a[inv], hit)


def trace_geometry_sharded_ring(scene: Scene, orig: jnp.ndarray,
                                dirn: jnp.ndarray, mesh: Mesh,
                                shards: GeometryShards | None = None,
                                sort: bool = True) -> Hit:
    """Closest hit with rays AND triangles sharded: each device traverses
    only N/D rays per step against its sub-BVH, ring-rotating blocks with
    their running winner (see _geom_ring_fn). Compute per device scales
    with D on coherent content (the running best-t retires later sub-BVHs
    at the root); memory scales with D as in trace_geometry_sharded.
    `sort` coherence-sorts the rays first (see _coherence_perm) — results
    are identical, incoherent batches traverse faster."""
    n_dev = mesh.devices.size
    if shards is None:
        shards = GeometryShards(scene, n_dev)
    assert shards.n_shards == n_dev

    if sort:
        perm, inv = _coherence_perm(scene, orig, dirn)
        hit = trace_geometry_sharded_ring(
            scene, orig[perm], dirn[perm], mesh, shards=shards, sort=False)
        return _apply_hit_perm(hit, inv)

    N = orig.shape[0]
    blk = -(-N // n_dev)
    pad = blk * n_dev - N
    o = jnp.concatenate([orig, jnp.zeros((pad, 3), orig.dtype)]) if pad \
        else orig
    d = jnp.concatenate([dirn, jnp.ones((pad, 3), dirn.dtype)]) if pad \
        else dirn
    fn = _geom_ring_fn(mesh, _packet_size(blk), shards.max_leaf)
    tri_t, tri_g, tri_n, tri_m, tri_uv, tri_hit = fn(o, d, *shards.arrays())
    if pad:
        tri_t, tri_g, tri_n, tri_m, tri_uv, tri_hit = (
            tri_t[:N], tri_g[:N], tri_n[:N], tri_m[:N], tri_uv[:N],
            tri_hit[:N])
    return _merge_spheres(scene, orig, dirn, tri_t, tri_g, tri_n, tri_m,
                          tri_uv, tri_hit)


def trace_geometry_sharded(scene: Scene, orig: jnp.ndarray, dirn: jnp.ndarray,
                           mesh: Mesh, shards: GeometryShards | None = None,
                           sort: bool = True) -> Hit:
    """Closest hit with triangles sharded across devices via per-shard BVHs.

    Each device traverses the FULL (replicated) ray batch against its own
    sub-BVH, then the global winner is combined by REDUCTION: pmin(t) →
    pmin(original id among t-winners, the reference tie rule: lower
    original index wins at equal t) → masked psum of the unique winner's
    attributes. That is 8 reduced words/ray independent of D. Build
    `shards = GeometryShards(scene, D)` once per scene and pass it in; it
    is rebuilt per call otherwise.
    """
    n_dev = mesh.devices.size
    if shards is None:
        shards = GeometryShards(scene, n_dev)
    assert shards.n_shards == n_dev

    if sort:
        perm, inv = _coherence_perm(scene, orig, dirn)
        hit = trace_geometry_sharded(
            scene, orig[perm], dirn[perm], mesh, shards=shards, sort=False)
        return _apply_hit_perm(hit, inv)

    fn = _geom_shard_fn(mesh, _packet_size(orig.shape[0]), shards.max_leaf)
    tri_t, tri_g, tri_n, tri_m, tri_uv, tri_hit = fn(orig, dirn,
                                                     *shards.arrays())
    return _merge_spheres(scene, orig, dirn, tri_t, tri_g, tri_n, tri_m,
                          tri_uv, tri_hit)


def render_frame_multichip(scene: Scene, width: int, height: int, mesh: Mesh,
                           leaf_size: int = 4, use_bvh: bool = True) -> np.ndarray:
    """Whole frame with ray sharding; pads N to the mesh size."""
    n = width * height
    n_dev = mesh.devices.size
    pad = (-n) % n_dev
    pyg, pxg = np.mgrid[0:height, 0:width]
    px = np.concatenate([pxg.reshape(-1), np.zeros(pad, np.int64)])
    py = np.concatenate([pyg.reshape(-1), np.zeros(pad, np.int64)])
    rgb = render_rays_sharded(scene, jnp.asarray(px, jnp.int32),
                              jnp.asarray(py, jnp.int32), width, height, mesh,
                              leaf_size=leaf_size, use_bvh=use_bvh)
    return np.asarray(rgb)[:n].reshape(height, width, 3)


def pathtrace_step_sharded(scene: Scene, accum, key, step_idx, px, py,
                           mesh: Mesh, *, width: int, height: int,
                           channel: int = 3, max_depth: int = 4,
                           rr_start: int = 2, shadows: bool = True,
                           leaf_size: int = 8, use_bvh: bool = True,
                           antialias: bool = True, spp: int = 1,
                           qmc: bool = True, qmc_seed=0,
                           tex_lod_bias: float = 0.0):
    """The PRODUCTION progressive path-trace step under shard_map: the
    same coherence-sort + QMC pool program the single-device PathTracer
    dispatches (engine/pathtracer._sample_chunk), with the ray batch and
    accumulator data-parallel over the mesh's ray axis and the scene
    replicated. Per-depth ray tallies psum — the only collective; radiance
    is pixel-local so the accumulator never moves.

    QMC pixel identity is global (shard base = axis_index * block), so
    with the default qmc+antialias sampler every ray draws the IDENTICAL
    lattice sample it would draw single-device — the D-device radiance
    equals the single-device step up to fp reassociation (the CPU-mesh
    parity test pins it at 1e-5).

    Returns (accum + contribution [C,3] ray-sharded, per-depth counts).
    """
    from ..engine.pathtracer import _sample_chunk

    n = px.shape[0]
    n_dev = mesh.devices.size
    assert n % n_dev == 0, "ray count must divide the mesh"
    blk = n // n_dev

    def shard_fn(scene_rep, accum_blk, key_rep, step_rep, pxs, pys):
        i = jax.lax.axis_index(RAY_AXIS)
        skey = jax.random.fold_in(key_rep, step_rep)
        jit_key = jax.random.fold_in(skey, i)
        jitter = (jax.random.uniform(jit_key, (blk, 2))
                  if antialias and not qmc else None)
        contrib, counts = _sample_chunk(
            scene_rep, pxs, pys, width, height, jit_key, channel,
            max_depth, rr_start, shadows, leaf_size, use_bvh, jitter,
            None, spp=spp, qmc=qmc, sample_base=step_rep,
            qmc_seed=qmc_seed, qmc_antialias=antialias,
            qmc_pid_base=i * blk, tex_lod_bias=tex_lod_bias)
        return accum_blk + contrib, jax.lax.psum(counts, RAY_AXIS)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(), P(), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=(P(RAY_AXIS), P()), check_vma=False)
    return jax.jit(fn)(scene, accum, key, jnp.int32(step_idx), px, py)
