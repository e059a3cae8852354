"""The GPU traversal kernel (ops/traverse_kernel.py) against its XLA twins.

On the CPU the kernel runs in the Pallas interpreter; the same comparison
on the compiled kernel carries the `gpu` marker and skips here.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpu_raytracer.ops.bvh_traverse import bvh_traverse_threaded
from gpu_raytracer.ops.camera_rays import generate_rays
from gpu_raytracer.ops.packet_trace import packet_traverse, tiled_pixel_order
from gpu_raytracer.ops.traverse_kernel import BLOCK, kernel_traverse


def _soup_scene(grouped: bool):
    """A random triangle soup, host-built (SAH) or rebuilt on device as a
    grouped LBVH (models/scene.py::refit_scene)."""
    from gpu_raytracer.models.camera import Camera
    from gpu_raytracer.models.geometry import Mesh, Spheres
    from gpu_raytracer.models.light import LightBuilder
    from gpu_raytracer.models.material import MaterialBuilder
    from gpu_raytracer.models.scene import prepare_scene, refit_scene

    rng = np.random.default_rng(21)
    n = 400
    cent = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    verts = (np.repeat(cent, 3, axis=0)
             + rng.normal(0, 0.4, (3 * n, 3)).astype(np.float32))
    idx = np.arange(3 * n, dtype=np.uint32).reshape(n, 3)
    mats = MaterialBuilder()
    mats.add_diffuse((0.8, 0.3, 0.3))
    lb = LightBuilder()
    lb.add_point((5, 7, 4), (1, 1, 1), 1.0, float("inf"))
    cam = Camera.create(position=(0.0, 0.0, 9.0), direction=(0.0, 0.0, -1.0),
                        fov=50.0)
    scene = prepare_scene(cam, Spheres.from_rows([]),
                          Mesh.from_arrays(verts, idx, np.zeros(n, np.uint32)),
                          mats.build(), lb.build())
    if grouped:
        scene = refit_scene(scene, jnp.asarray(verts), rebuild=True)
    return scene


def _scene(name):
    from gpu_raytracer import build_default_scene
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    if name == "default":
        return build_default_scene()
    if name == "courtyard5k":
        return make_courtyard_scene(target_triangles=5_000, seed=0)
    if name == "textured":
        return make_courtyard_scene(target_triangles=2_000, seed=3,
                                    textured=True, texture_size=64)
    return _soup_scene(grouped=(name == "grouped_lbvh"))


_SCENES = {}


def _cached_scene(name):
    if name not in _SCENES:
        _SCENES[name] = _scene(name)
    return _SCENES[name]


def _rays(scene, kind, n_side=16):
    """Tile-ordered camera rays (the renderer's feed) or random incoherent
    rays aimed into the scene's bounds."""
    W = H = n_side
    if kind == "camera":
        px, py = tiled_pixel_order(W, H, tile=8)
        return generate_rays(scene.camera, W, H, jnp.asarray(px),
                             jnp.asarray(py))
    rng = np.random.default_rng(5)
    lo = np.asarray(scene.bvh.node_min[0])
    hi = np.asarray(scene.bvh.node_max[0])
    n = W * H
    o = rng.uniform(lo - 1.0, hi + 1.0, (n, 3)).astype(np.float32)
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - o
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("kind", ["camera", "random"])
@pytest.mark.parametrize("scene_name", ["default", "courtyard5k",
                                        "sah_soup", "grouped_lbvh",
                                        "textured"])
@pytest.mark.parametrize("any_hit", [False, True],
                         ids=["closest", "anyhit"])
def test_kernel_matches_xla_twin(scene_name, kind, any_hit):
    """The interpreted kernel and the threaded XLA traversal agree: equal
    hit masks; equal winner ids, t and barycentrics for closest hits (the
    kernel's block cursor visits a superset of each ray's nodes in the
    same left-first order, strict `<` keeps the same winner)."""
    scene = _cached_scene(scene_name)
    o, d = _rays(scene, kind)
    n = o.shape[0]
    mt = jnp.full((n,), 3.0e38, jnp.float32)
    ls = scene.bvh.max_leaf
    t_k, i_k, h_k, b_k = kernel_traverse(
        scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, mt,
        leaf_size=ls, any_hit=any_hit, interpret=True)
    t_x, i_x, h_x = bvh_traverse_threaded(
        scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, mt,
        leaf_size=ls, any_hit=any_hit)
    np.testing.assert_array_equal(np.asarray(h_k), np.asarray(h_x))
    if any_hit:
        return
    hm = np.asarray(h_x)
    np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_x))
    np.testing.assert_allclose(np.asarray(t_k)[hm], np.asarray(t_x)[hm],
                               rtol=1e-5)
    # the winner's barycentrics, recomputed from its triangle
    from gpu_raytracer.ops.trace import _mt_bary
    ti = jnp.clip(i_x, 0, scene.tri_v0.shape[0] - 1)
    bu, bv = _mt_bary(o, d, scene.tri_v0[ti], scene.tri_e1[ti],
                      scene.tri_e2[ti])
    np.testing.assert_allclose(np.asarray(b_k)[hm, 0], np.asarray(bu)[hm],
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(b_k)[hm, 1], np.asarray(bv)[hm],
                               atol=1e-4)


@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK, BLOCK + 1, 3 * BLOCK + 7])
def test_kernel_pads_any_ray_count(n):
    """Any ray count: outputs are [n]-shaped with the contract's dtypes, and
    the padding lanes (max_t 0, retired at once) never leak into them."""
    scene = _cached_scene("courtyard5k")
    o, d = _rays(scene, "random")
    o, d = o[:n], d[:n]
    mt = jnp.full((n,), 3.0e38, jnp.float32)
    t, tri, hit, bary = kernel_traverse(
        scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, mt,
        leaf_size=scene.bvh.max_leaf, interpret=True)
    assert t.shape == (n,) and t.dtype == jnp.float32
    assert tri.shape == (n,) and tri.dtype == jnp.int32
    assert hit.shape == (n,) and hit.dtype == jnp.bool_
    assert bary.shape == (n, 2)
    t_x, tri_x, hit_x = bvh_traverse_threaded(
        scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, mt,
        leaf_size=scene.bvh.max_leaf)
    np.testing.assert_array_equal(np.asarray(hit), np.asarray(hit_x))
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(tri_x))


def test_kernel_respects_max_t():
    """max_t bounds the search: a limit below the closest hit misses, and
    a ray with max_t <= 0 (a dead wavefront lane) misses without work."""
    scene = _cached_scene("courtyard5k")
    o, d = _rays(scene, "camera")
    n = o.shape[0]
    big = jnp.full((n,), 3.0e38, jnp.float32)
    leaf = scene.bvh.max_leaf
    args = (scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d)
    t, _, hit, _ = kernel_traverse(*args, big, leaf_size=leaf,
                                   interpret=True)
    assert bool(hit.any())
    t2, _, hit2, _ = kernel_traverse(*args, jnp.where(hit, t * 0.999, 1.0),
                                     leaf_size=leaf, interpret=True)
    assert not bool((hit2 & hit).any())
    _, _, hit3, _ = kernel_traverse(*args, jnp.zeros((n,), jnp.float32),
                                    leaf_size=leaf, interpret=True)
    assert not bool(hit3.any())


def test_trace_kernel_branch_matches_xla_branch(monkeypatch):
    """ops/trace.py's kernel branch (taken on a GPU) expands normal,
    material and uv from the winner id exactly as the XLA branch does."""
    import gpu_raytracer.ops.trace as T

    scene = _cached_scene("textured")
    o, d = _rays(scene, "camera")
    want = T.trace(scene, o, d)
    monkeypatch.setattr(T, "traversal", lambda: "kernel")
    monkeypatch.setattr(T, "kernel_traverse",
                        lambda *a, **k: kernel_traverse(*a, **k,
                                                        interpret=True))
    got = T.trace(scene, o, d)
    hm = np.asarray(want.hit)
    assert hm.sum() > 50
    np.testing.assert_array_equal(np.asarray(got.hit), hm)
    np.testing.assert_array_equal(np.asarray(got.material_id),
                                  np.asarray(want.material_id))
    np.testing.assert_allclose(np.asarray(got.t)[hm], np.asarray(want.t)[hm],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.normal),
                               np.asarray(want.normal), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.uv), np.asarray(want.uv),
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_compiled_kernel_matches_xla_twin(gpu_device, any_hit):
    """The kernel as compiled for the card, against the threaded XLA
    traversal on the same card (chip_smoke.py phase 7 runs the same check
    at 1080p)."""
    with jax.default_device(gpu_device):
        scene = _scene("courtyard5k")
        o, d = _rays(scene, "camera", n_side=64)
        mt = jnp.full((o.shape[0],), 3.0e38, jnp.float32)
        ls = scene.bvh.max_leaf
        t_k, _, h_k, _ = kernel_traverse(
            scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, mt,
            leaf_size=ls, any_hit=any_hit)
        t_x, _, h_x = bvh_traverse_threaded(
            scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, mt,
            leaf_size=ls, any_hit=any_hit)
    np.testing.assert_array_equal(np.asarray(h_k), np.asarray(h_x))
    if not any_hit:
        hm = np.asarray(h_x)
        np.testing.assert_allclose(np.asarray(t_k)[hm],
                                   np.asarray(t_x)[hm], rtol=1e-5)
