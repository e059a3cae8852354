"""On-device LBVH tests: structure validity + trace parity vs host SAH BVH."""

import numpy as np
import jax.numpy as jnp

from gpu_raytracer.ops.lbvh import (
    build_lbvh_arrays, expand_bits_10, lbvh_from_mesh_device, morton_codes,
    _nlz32,
)
from gpu_raytracer.ops.bvh_traverse import bvh_traverse_threaded
from gpu_raytracer.ops.packet_trace import packet_traverse


def test_nlz32():
    vals = np.array([0, 1, 2, 3, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFF, 1 << 20],
                    dtype=np.uint32)
    got = np.asarray(_nlz32(jnp.asarray(vals)))
    want = [32, 31, 30, 30, 0, 1, 0, 11]
    np.testing.assert_array_equal(got, want)


def test_expand_bits():
    # spreading 0b1111111111 puts bits at every 3rd position
    v = np.asarray(expand_bits_10(jnp.asarray([0x3FF], jnp.uint32)))[0]
    assert v == 0x09249249  # bits 0..9 -> positions 0,3,...,27
    v1 = np.asarray(expand_bits_10(jnp.asarray([1], jnp.uint32)))[0]
    assert v1 == 1


def test_morton_orders_along_axes():
    c = jnp.asarray([[0.0, 0, 0], [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    lo = jnp.zeros(3)
    hi = jnp.ones(3)
    m = np.asarray(morton_codes(c, lo, hi))
    assert m[0] < m[1] and m[0] < m[2] and m[0] < m[3]
    # x contributes the highest interleaved bit
    assert m[1] > m[2] > m[3]


def _soup(rng, n):
    v0 = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    v2 = v0 + rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    verts = np.concatenate([v0, v1, v2])
    idx = np.arange(3 * n, dtype=np.uint32).reshape(3, n).T
    return verts, idx


def _rays(rng, m):
    o = rng.uniform(-12, 12, (m, 3)).astype(np.float32)
    d = rng.uniform(-8, 8, (m, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_lbvh_structure(rng):
    n = 500
    verts, idx = _soup(rng, n)
    a = verts[idx[:, 0]]
    b = verts[idx[:, 1]]
    c = verts[idx[:, 2]]
    tmin = np.minimum(a, np.minimum(b, c))
    tmax = np.maximum(a, np.maximum(b, c))
    (nmin, nmax, left, right, ts, tc, hit, miss, order) = [
        np.asarray(x) for x in build_lbvh_arrays(jnp.asarray(tmin),
                                                 jnp.asarray(tmax))]
    n_nodes = 2 * n - 1
    assert left.shape[0] == n_nodes
    # every leaf reachable exactly once from the root
    seen = np.zeros(n_nodes, bool)
    stack = [0]
    leaf_positions = []
    while stack:
        nd = stack.pop()
        assert not seen[nd], "node visited twice (not a tree)"
        seen[nd] = True
        if left[nd] < 0:
            leaf_positions.append(ts[nd])
        else:
            stack.extend([int(left[nd]), int(right[nd])])
    assert seen.all()
    assert sorted(leaf_positions) == list(range(n))
    assert sorted(order.tolist()) == list(range(n))
    # parent bounds contain children
    internal = np.where(left >= 0)[0]
    for nd in internal[:200]:
        for ch in (left[nd], right[nd]):
            assert (nmin[nd] <= nmin[ch] + 1e-5).all()
            assert (nmax[nd] >= nmax[ch] - 1e-5).all()
    # threaded-link walk covers the tree
    seen2 = np.zeros(n_nodes, bool)
    nd, steps = 0, 0
    while nd != -1 and steps <= n_nodes:
        seen2[nd] = True
        nd = int(hit[nd])
        steps += 1
    assert seen2.all()


def test_lbvh_trace_parity_with_host_bvh(rng):
    """LBVH traversal must find identical hits to the host SAH tree."""
    from gpu_raytracer.models.bvh import build_bvh
    from gpu_raytracer.models.scene import _expand_triangles

    n = 400
    verts, idx = _soup(rng, n)
    bvh, v0, e1, e2, mat = lbvh_from_mesh_device(
        jnp.asarray(verts), jnp.asarray(idx),
        jnp.zeros((n,), jnp.uint32))

    res = build_bvh(verts, idx, leaf_size=4)
    hv0, he1, he2, hmat, _huv, _hsrc = _expand_triangles(
        verts, idx, np.zeros(n, np.uint32), np.zeros((verts.shape[0], 2),
                                                     np.float32),
        res.tri_order, 8)
    host_bvh = res.to_device()

    m = 512
    o = rng.uniform(-12, 12, (m, 3)).astype(np.float32)
    tgt = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    mt = jnp.full((m,), 3.0e38, jnp.float32)

    t_l, i_l, h_l = bvh_traverse_threaded(bvh, v0, e1, e2, o, d, mt,
                                          leaf_size=1)
    t_h, i_h, h_h = bvh_traverse_threaded(host_bvh, hv0, he1, he2, o, d, mt,
                                          leaf_size=4)
    np.testing.assert_array_equal(np.asarray(h_l), np.asarray(h_h))
    hmask = np.asarray(h_l)
    assert hmask.sum() > 30
    np.testing.assert_allclose(np.asarray(t_l)[hmask], np.asarray(t_h)[hmask],
                               rtol=1e-6)

    # packet traversal over the LBVH agrees too
    t_p, i_p, h_p, n_p, m_p, uv_p = packet_traverse(bvh, v0, e1, e2, o, d, mt,
                                              tri_mat=mat, leaf_size=1,
                                              packet_size=512)
    np.testing.assert_array_equal(np.asarray(h_p), hmask)
    np.testing.assert_allclose(np.asarray(t_p)[hmask], np.asarray(t_l)[hmask],
                               rtol=1e-6)


def test_lbvh_degenerate_small():
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                        [2, 2, 2], [3, 2, 2], [2, 3, 2]], np.float32)
    idx = np.asarray([[0, 1, 2], [3, 4, 5]], np.uint32)
    bvh, v0, e1, e2, mat = lbvh_from_mesh_device(
        jnp.asarray(verts), jnp.asarray(idx), jnp.zeros((2,), jnp.uint32))
    assert bvh.num_nodes == 3
    o = jnp.asarray([[0.2, 0.2, -1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    t, i, h = bvh_traverse_threaded(bvh, v0, e1, e2, o, d,
                                    jnp.full((1,), 3e38, jnp.float32),
                                    leaf_size=1)
    assert bool(h[0])
    np.testing.assert_allclose(float(t[0]), 1.0, rtol=1e-6)


def test_grouped_lbvh_enters_pallas_fast_path():
    """The on-device grouped build emits 8-triangle leaves that the Pallas
    traversal kernel (interpreted here) walks to the threaded XLA
    traversal's hits."""
    from gpu_raytracer.ops.traverse_kernel import kernel_traverse
    rng = np.random.default_rng(55)

    n = 300
    verts, idx = _soup(rng, n)
    bvh, v0, e1, e2, mat = lbvh_from_mesh_device(
        jnp.asarray(verts), jnp.asarray(idx), jnp.zeros((n,), jnp.uint32),
        group=8)
    assert bvh.max_leaf == 8
    assert v0.shape[0] % 8 == 0
    o, d = _rays(rng, 200)
    mt = jnp.full((200,), 3.0e38, jnp.float32)
    t_k, _, h_k, _ = kernel_traverse(bvh, v0, e1, e2, o, d, mt, leaf_size=8,
                                     interpret=True)
    t_x, _, h_x = bvh_traverse_threaded(bvh, v0, e1, e2, o, d, mt,
                                        leaf_size=8)
    np.testing.assert_array_equal(np.asarray(h_k), np.asarray(h_x))
    hm = np.asarray(h_x)
    assert hm.sum() > 10
    np.testing.assert_allclose(np.asarray(t_k)[hm], np.asarray(t_x)[hm],
                               rtol=1e-5)
    # leaf invariants: starts aligned, count 8, G = ceil(n/8) leaves
    left = np.asarray(bvh.left)
    ts = np.asarray(bvh.tri_start)[left < 0]
    tc = np.asarray(bvh.tri_count)[left < 0]
    G = -(-n // 8)
    assert bvh.num_nodes == 2 * G - 1
    assert (ts % 8 == 0).all() and (tc == 8).all()
    assert sorted(ts.tolist()) == [8 * g for g in range(G)]


def test_grouped_lbvh_trace_parity():
    """Grouped-leaf LBVH traversal finds identical hits to the 1-tri-leaf
    LBVH (padding slots are degenerate, grouping only reshapes leaves)."""
    rng = np.random.default_rng(66)
    n = 400
    verts, idx = _soup(rng, n)
    zmat = jnp.zeros((n,), jnp.uint32)
    bvh1, v01, e11, e21, _ = lbvh_from_mesh_device(
        jnp.asarray(verts), jnp.asarray(idx), zmat)
    bvh8, v08, e18, e28, mat8 = lbvh_from_mesh_device(
        jnp.asarray(verts), jnp.asarray(idx), zmat, group=8)

    m = 512
    o = rng.uniform(-12, 12, (m, 3)).astype(np.float32)
    tgt = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    mt = jnp.full((m,), 3.0e38, jnp.float32)

    t1, _, h1 = bvh_traverse_threaded(bvh1, v01, e11, e21, o, d, mt,
                                      leaf_size=1)
    t8, _, h8 = bvh_traverse_threaded(bvh8, v08, e18, e28, o, d, mt,
                                      leaf_size=8)
    np.testing.assert_array_equal(np.asarray(h8), np.asarray(h1))
    hm = np.asarray(h1)
    assert hm.sum() > 30
    np.testing.assert_allclose(np.asarray(t8)[hm], np.asarray(t1)[hm],
                               rtol=1e-6)


def test_refit_scene_moves_geometry_and_stays_fast():
    """models.scene.refit_scene: one jitted device pipeline; hits track the
    moved vertices, and the rebuilt tree keeps 8-triangle leaves."""
    import jax
    rng = np.random.default_rng(77)
    from gpu_raytracer.models.scene import prepare_scene, refit_scene
    from gpu_raytracer.models.geometry import Mesh, Spheres
    from gpu_raytracer.models.material import MaterialBuilder
    from gpu_raytracer.models.light import LightBuilder
    from gpu_raytracer.models.camera import Camera
    from gpu_raytracer.ops.trace import trace

    n = 200
    verts, idx = _soup(rng, n)
    mats = MaterialBuilder(); mats.add_diffuse((0.8, 0.3, 0.3))
    lb = LightBuilder(); lb.add_point((5, 7, 4), (1, 1, 1), 1.0, float("inf"))
    scene = prepare_scene(Camera.default(), Spheres.from_rows([]),
                          Mesh.from_arrays(verts, idx, np.zeros(n, np.uint32)),
                          mats.build(), lb.build())

    # identity refit: same geometry -> same hits as the host-built scene
    s0 = refit_scene(scene, jnp.asarray(verts), rebuild=True)
    assert s0.bvh.max_leaf == 8
    m = 256
    o = rng.uniform(-12, 12, (m, 3)).astype(np.float32)
    tgt = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    h_host = trace(scene, o, d)
    h_refit = trace(s0, o, d)
    np.testing.assert_array_equal(np.asarray(h_refit.hit),
                                  np.asarray(h_host.hit))
    hm = np.asarray(h_host.hit)
    np.testing.assert_allclose(np.asarray(h_refit.t)[hm],
                               np.asarray(h_host.t)[hm], rtol=1e-5)

    # translated refit == host build of the translated mesh
    shift = np.asarray([0.5, -0.25, 1.0], np.float32)
    s1 = refit_scene(s0, jnp.asarray(verts + shift))
    scene_t = prepare_scene(Camera.default(), Spheres.from_rows([]),
                            Mesh.from_arrays(verts + shift, idx,
                                             np.zeros(n, np.uint32)),
                            mats.build(), lb.build())
    h_a = trace(s1, o, d)
    h_b = trace(scene_t, o, d)
    np.testing.assert_array_equal(np.asarray(h_a.hit), np.asarray(h_b.hit))
    hm = np.asarray(h_b.hit)
    assert hm.sum() > 10
    np.testing.assert_allclose(np.asarray(h_a.t)[hm],
                               np.asarray(h_b.t)[hm], rtol=1e-5)


def test_topology_refit_deformed_matches_fresh_build():
    """Topology-preserving refit (models/scene.py::_refit_topology_core):
    deform the mesh, keep the SAH tree, resweep AABBs — hits and closest t
    must equal a fresh host build of the deformed mesh, and NO array shape
    may change (the per-frame zero-recompile contract)."""
    import jax
    rng = np.random.default_rng(99)
    from gpu_raytracer.models.scene import prepare_scene, refit_scene
    from gpu_raytracer.models.geometry import Mesh, Spheres
    from gpu_raytracer.models.material import MaterialBuilder
    from gpu_raytracer.models.light import LightBuilder
    from gpu_raytracer.models.camera import Camera
    from gpu_raytracer.ops.trace import trace

    n = 500
    verts, idx = _soup(rng, n)
    mats = MaterialBuilder(); mats.add_diffuse((0.8, 0.3, 0.3))
    lb = LightBuilder(); lb.add_point((5, 7, 4), (1, 1, 1), 1.0, float("inf"))

    def build(v):
        return prepare_scene(Camera.default(), Spheres.from_rows([]),
                             Mesh.from_arrays(v, idx,
                                              np.zeros(n, np.uint32)),
                             mats.build(), lb.build())

    scene = build(verts)
    assert scene.tri_src is not None
    # non-rigid deformation: per-vertex jitter + twist
    moved = (verts + rng.normal(0, 0.15, verts.shape)).astype(np.float32)
    s1 = refit_scene(scene, jnp.asarray(moved))
    # identical shapes and tree topology (zero-recompile contract)
    assert s1.tri_v0.shape == scene.tri_v0.shape
    np.testing.assert_array_equal(np.asarray(s1.bvh.left),
                                  np.asarray(scene.bvh.left))

    fresh = build(moved)
    m = 512
    o = rng.uniform(-12, 12, (m, 3)).astype(np.float32)
    tgt = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    h_r = trace(s1, o, d)
    h_f = trace(fresh, o, d)
    np.testing.assert_array_equal(np.asarray(h_r.hit), np.asarray(h_f.hit))
    hm = np.asarray(h_f.hit)
    assert hm.sum() > 50
    np.testing.assert_allclose(np.asarray(h_r.t)[hm],
                               np.asarray(h_f.t)[hm], rtol=1e-5)

    # parent boxes contain child boxes after the resweep
    nm = np.asarray(s1.bvh.node_min); nx = np.asarray(s1.bvh.node_max)
    left = np.asarray(s1.bvh.left); right = np.asarray(s1.bvh.right)
    internal = left >= 0
    for ch in (left[internal], right[internal]):
        assert (nm[internal] <= nm[ch] + 1e-5).all()
        assert (nx[internal] >= nx[ch] - 1e-5).all()
