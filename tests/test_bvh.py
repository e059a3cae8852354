"""BVH build properties + traversal parity vs brute force."""

import numpy as np
import jax.numpy as jnp

from gpu_raytracer.models.bvh import build_bvh, validate_bvh, LEAF
from gpu_raytracer.models.geometry import Mesh, Spheres
from gpu_raytracer.models.material import MaterialBuilder
from gpu_raytracer.models.light import LightBuilder
from gpu_raytracer.models.camera import Camera
from gpu_raytracer.models.scene import prepare_scene
from gpu_raytracer.ops.trace import trace


def _tri_soup(rng, n, spread=10.0, size=0.5):
    v0 = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(n, 3)).astype(np.float32) * size
    v2 = v0 + rng.normal(size=(n, 3)).astype(np.float32) * size
    verts = np.concatenate([v0, v1, v2])
    idx = np.arange(3 * n, dtype=np.uint32).reshape(3, n).T
    return verts, idx


def test_build_properties(rng):
    verts, idx = _tri_soup(rng, 500)
    res = build_bvh(verts, idx, leaf_size=4)
    validate_bvh(res, 500)
    assert res.max_depth < 64
    # root bounds contain everything
    assert (res.node_min[0] <= verts.min(axis=0) + 1e-5).all()
    assert (res.node_max[0] >= verts.max(axis=0) - 1e-5).all()


def test_build_single_triangle():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2]], np.uint32)
    res = build_bvh(verts, idx, leaf_size=4)
    assert res.left[0] == LEAF
    assert res.tri_count[0] == 1
    validate_bvh(res, 1)


def test_build_empty():
    res = build_bvh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32))
    assert res.tri_count[0] == 0


def _scene_from_soup(rng, n, leaf_size=4):
    verts, idx = _tri_soup(rng, n)
    mesh = Mesh.from_arrays(verts, idx, np.zeros(n, np.uint32))
    mb = MaterialBuilder()
    mb.add_diffuse((0.5, 0.5, 0.5))
    lb = LightBuilder()
    lb.add_point((0, 20, 0), (1, 1, 1), 1.0)
    return prepare_scene(Camera.default(), Spheres.from_rows([]), mesh,
                         mb.build(), lb.build())


def test_traversal_matches_brute_force(rng):
    scene = _scene_from_soup(rng, 400)
    n = 512
    o = rng.uniform(-12, 12, size=(n, 3)).astype(np.float32)
    target = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    hit_bvh = trace(scene, o, d, use_bvh=True)
    hit_brute = trace(scene, o, d, use_bvh=False)

    np.testing.assert_array_equal(np.asarray(hit_bvh.hit), np.asarray(hit_brute.hit))
    h = np.asarray(hit_bvh.hit)
    assert h.sum() > 50  # the soup actually gets hit
    np.testing.assert_allclose(np.asarray(hit_bvh.t)[h], np.asarray(hit_brute.t)[h],
                               rtol=1e-6)
    # hit records bit-stable: same triangle chosen (leaf-order ids differ from
    # original ids, so compare via t and material/normal instead)
    np.testing.assert_allclose(np.asarray(hit_bvh.normal)[h],
                               np.asarray(hit_brute.normal)[h], atol=1e-6)


def test_threaded_equals_stack_traversal(rng):
    from gpu_raytracer.ops.bvh_traverse import (
        bvh_traverse, bvh_traverse_threaded,
    )

    scene = _scene_from_soup(rng, 300)
    n = 512
    o = rng.uniform(-12, 12, size=(n, 3)).astype(np.float32)
    target = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    mt = jnp.full((n,), 3.0e38, jnp.float32)
    args = (scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, mt)
    t1, i1, h1 = bvh_traverse(*args)
    t2, i2, h2 = bvh_traverse_threaded(*args)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


def test_compute_links_invariants(rng):
    from gpu_raytracer.models.bvh import compute_links

    verts, idx = _tri_soup(rng, 100)
    res = build_bvh(verts, idx, leaf_size=4)
    hit, miss = compute_links(res.left, res.right)
    n = res.left.shape[0]
    # root's miss is exit; internal hit = left child; leaf hit = its miss
    assert miss[0] == -1
    leaves = res.left == LEAF
    np.testing.assert_array_equal(hit[~leaves], res.left[~leaves])
    np.testing.assert_array_equal(hit[leaves], miss[leaves])
    # following hit links from the root visits every node exactly once
    # (threaded DFS covers the tree)
    seen = np.zeros(n, bool)
    node = 0
    steps = 0
    while node != -1 and steps <= n:
        assert not seen[node]
        seen[node] = True
        node = int(hit[node])
        steps += 1
    assert seen.all()


def test_occlusion_matches_closest(rng):
    from gpu_raytracer.ops.trace import occluded

    scene = _scene_from_soup(rng, 200)
    n = 256
    o = rng.uniform(-12, 12, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    hit = trace(scene, o, d)
    occ = occluded(scene, o, d, jnp.full((n,), 1e30, jnp.float32))
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(hit.hit))


def test_degenerate_scene_coincident_triangles(rng):
    """Pathological input — thousands of near-coincident triangles (zero
    centroid spread defeats median/SAH splits): build must terminate, the
    traversal stack must stay bounded, and hits must match brute force."""
    base = np.asarray([[0.0, 0.0, -3.0], [1.0, 0.0, -3.0], [0.0, 1.0, -3.0]],
                      np.float32)
    jit = rng.normal(0, 1e-6, (2000, 3, 3)).astype(np.float32)
    verts = (base[None] + jit).reshape(-1, 3)
    idx = np.arange(verts.shape[0], dtype=np.uint32).reshape(-1, 3)
    mesh = Mesh.from_arrays(verts, idx, np.zeros(2000, np.uint32))
    mb = MaterialBuilder(); mb.add_diffuse((0.5, 0.5, 0.5))
    lb = LightBuilder(); lb.add_point((0, 0, 0), (1, 1, 1), 1.0)
    scene = prepare_scene(Camera.default(), Spheres.from_rows([]), mesh,
                          mb.build(), lb.build())

    n = 1024  # one full packet so the packet paths run
    o = np.tile(np.asarray([[0.2, 0.2, 1.0]], np.float32), (n, 1))
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    h_bvh = trace(scene, jnp.asarray(o), jnp.asarray(d), use_bvh=True)
    h_bf = trace(scene, jnp.asarray(o), jnp.asarray(d), use_bvh=False)
    np.testing.assert_array_equal(np.asarray(h_bvh.hit), np.asarray(h_bf.hit))
    assert np.asarray(h_bvh.hit).all()
    np.testing.assert_allclose(np.asarray(h_bvh.t), np.asarray(h_bf.t),
                               rtol=1e-5)


def test_spatial_splits_build_and_parity():
    """SBVH chopped spatial splits: duplicated
    clipped references on spanning geometry, full coverage, and an
    identical rendered image."""
    from gpu_raytracer import RaytracerConfig, render_image
    from gpu_raytracer.models.bvh import build_bvh_spatial, validate_bvh
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    rng = np.random.default_rng(3)
    # long thin diagonal triangles spanning many cells + a cluster of small
    # ones: the content class where spatial splits beat object splits
    n_long, n_small = 60, 300
    v0 = rng.uniform(-10, 10, (n_long, 3)).astype(np.float32)
    d1 = rng.normal(size=(n_long, 3)).astype(np.float32)
    d1 = d1 / np.linalg.norm(d1, axis=1, keepdims=True) * 15.0
    d2 = rng.normal(size=(n_long, 3)).astype(np.float32) * 0.1
    sm0 = rng.uniform(-10, 10, (n_small, 3)).astype(np.float32)
    verts = np.concatenate([
        v0, v0 + d1, v0 + d2,
        sm0, sm0 + rng.normal(size=(n_small, 3)).astype(np.float32) * 0.3,
        sm0 + rng.normal(size=(n_small, 3)).astype(np.float32) * 0.3,
    ]).astype(np.float32)
    nl3, ns3 = n_long, n_small
    il = np.stack([np.arange(nl3), np.arange(nl3) + nl3,
                   np.arange(nl3) + 2 * nl3], 1)
    base = 3 * nl3
    ismall = np.stack([base + np.arange(ns3), base + np.arange(ns3) + ns3,
                       base + np.arange(ns3) + 2 * ns3], 1)
    idx = np.concatenate([il, ismall]).astype(np.uint32)

    res = build_bvh_spatial(verts, idx, leaf_size=8)
    T = idx.shape[0]
    refs = res.tri_order[res.tri_order >= 0]
    assert set(refs.tolist()) == set(range(T))      # full coverage
    assert refs.shape[0] > T                        # splits really happened
    validate_bvh(res, T, allow_refs=True)

    # end-to-end image parity on the courtyard (same geometry, two builders)
    scene_obj = make_courtyard_scene(3000, seed=2)
    scene_sp = make_courtyard_scene(
        3000, seed=2, config=RaytracerConfig(bvh_spatial_splits=True))
    a = render_image(scene_obj, 64, 48, shadows=True)
    b = render_image(scene_sp, 64, 48, shadows=True)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_spatial_splits_all_straddle_degenerate_covers():
    """All-straddle spatial split: when every ref straddles the chosen
    plane the builder must fall back to a median split WITHOUT mutating
    ref bounds first — the former order clipped rmax in place and then
    discarded the right-side copies, leaving leaf boxes that under-cover
    their triangles (silent missed intersections)."""
    from gpu_raytracer.models.bvh import build_bvh_spatial

    # 12 identical-centroid triangles spanning x in [0, 16]: the object
    # split is degenerate (all centroids equal) and every ref straddles
    # any interior plane.
    n = 12
    verts = []
    for i in range(n):
        y = 0.01 * i
        verts.append([[0.0, y, 0.0], [16.0, y + 0.5, 0.0],
                      [8.0, y + 1.0, 1.0]])
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    idx = np.arange(3 * n, dtype=np.uint32).reshape(-1, 3)
    res = build_bvh_spatial(v, idx, leaf_size=4)

    left = np.asarray(res.left)
    tri_start = np.asarray(res.tri_start)
    tri_count = np.asarray(res.tri_count)
    nmin = np.asarray(res.node_min)
    nmax = np.asarray(res.node_max)
    order = np.asarray(res.tri_order)
    tv = v[idx.astype(np.int64)]                       # [n,3,3]
    for ni in range(left.shape[0]):
        if left[ni] >= 0:
            continue
        for s in range(tri_start[ni], tri_start[ni] + tri_count[ni]):
            t = order[s]
            if t < 0:
                continue
            tmin = tv[t].min(axis=0)
            tmax = tv[t].max(axis=0)
            # the leaf box may be a CLIPPED sub-box of the triangle, but
            # the union of all leaf boxes referencing t must cover it —
            # with a degenerate fallback a single leaf holds t, so that
            # leaf must cover it fully
            refs = []
            for nj in range(left.shape[0]):
                if left[nj] >= 0:
                    continue
                sl = order[tri_start[nj]:tri_start[nj] + tri_count[nj]]
                if (sl == t).any():
                    refs.append(nj)
            cover_min = np.min([nmin[r] for r in refs], axis=0)
            cover_max = np.max([nmax[r] for r in refs], axis=0)
            assert (cover_min <= tmin + 1e-5).all() and \
                   (cover_max >= tmax - 1e-5).all(), (ni, t)


def test_spatial_splits_flat_ref_on_plane_not_duplicated_in_place():
    """An axis-flat triangle lying exactly on the split plane must not land
    in BOTH children as the same mutable ref record (left_only/right_only
    overlap): total ref placements stay consistent and every triangle stays
    covered by the union of its leaf boxes."""
    from gpu_raytracer.models.bvh import build_bvh_spatial

    rng = np.random.default_rng(11)
    # long triangles spanning x in [0,16] force spatial splits at clean
    # bin-edge planes; add x-flat triangles exactly at those planes
    tris = []
    for i in range(24):
        y = 0.3 * i
        tris.append([[0.0, y, 0.0], [16.0, y + 0.4, 0.2],
                     [8.0, y + 0.8, 0.6]])
    for i in range(8):
        x = 2.0 * (i + 1)   # bin edges of a 16-wide extent
        tris.append([[x, 0.1 * i, 0.0], [x, 1.0 + 0.1 * i, 0.0],
                     [x, 0.5, 1.0]])
    v = np.asarray(tris, np.float32).reshape(-1, 3)
    idx = np.arange(v.shape[0], dtype=np.uint32).reshape(-1, 3)
    res = build_bvh_spatial(v, idx, leaf_size=4)
    order = np.asarray(res.tri_order)
    left = np.asarray(res.left)
    tri_start = np.asarray(res.tri_start)
    tri_count = np.asarray(res.tri_count)
    # every input triangle referenced at least once; coverage via union
    tv = v[idx.astype(np.int64)]
    nmin = np.asarray(res.node_min)
    nmax = np.asarray(res.node_max)
    for t in range(idx.shape[0]):
        refs = [nj for nj in range(left.shape[0]) if left[nj] < 0 and
                (order[tri_start[nj]:tri_start[nj] + tri_count[nj]] == t).any()]
        assert refs, t
        cover_min = np.min([nmin[r] for r in refs], axis=0)
        cover_max = np.max([nmax[r] for r in refs], axis=0)
        assert (cover_min <= tv[t].min(axis=0) + 1e-5).all()
        assert (cover_max >= tv[t].max(axis=0) - 1e-5).all()
