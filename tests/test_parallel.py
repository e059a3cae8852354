"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpu_raytracer.parallel.mesh import make_mesh
from gpu_raytracer.parallel.shard import (
    render_frame_multichip, render_rays_sharded, trace_geometry_sharded,
)
from gpu_raytracer import render_image
from gpu_raytracer.ops.camera_rays import generate_rays, pixel_grid
from gpu_raytracer.ops.trace import trace

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


@needs_8
def test_ray_sharded_render_matches_single(default_scene):
    W = H = 32
    mesh = make_mesh(8)
    img = render_frame_multichip(default_scene, W, H, mesh)
    single = render_image(default_scene, W, H)
    np.testing.assert_allclose(img, single, atol=1e-6)


@needs_8
def test_geometry_sharded_trace_matches_single(default_scene, rng):
    mesh = make_mesh(8)
    n = 256
    o = rng.normal(size=(n, 3)).astype(np.float32) * 3
    t = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    t[:, 2] = -2.0
    d = t - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    sharded = trace_geometry_sharded(default_scene, o, d, mesh)
    single = trace(default_scene, o, d)
    np.testing.assert_array_equal(np.asarray(sharded.hit), np.asarray(single.hit))
    h = np.asarray(single.hit)
    np.testing.assert_allclose(np.asarray(sharded.t)[h],
                               np.asarray(single.t)[h], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(sharded.material_id)[h],
                                  np.asarray(single.material_id)[h])


@needs_8
def test_mesh_subset():
    mesh = make_mesh(4)
    assert mesh.devices.size == 4


@needs_8
def test_graft_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_graft_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128 * 128, 3)
    assert np.isfinite(np.asarray(out)).all()


@needs_8
def test_ray_sharded_tile_order_matches_render_chunk(default_scene):
    """Tile-ordered rays (the renderer's feed order) sharded over the mesh
    shade exactly as one single-device render_chunk call."""
    from gpu_raytracer.engine.renderer import render_chunk
    from gpu_raytracer.ops.packet_trace import tiled_pixel_order

    W, H = 40, 24
    px, py = tiled_pixel_order(W, H, tile=16)
    px, py = jnp.asarray(px), jnp.asarray(py)
    got = render_rays_sharded(default_scene, px, py, W, H, make_mesh(8))
    want = render_chunk(default_scene, px, py, W, H)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


@needs_8
def test_geometry_shards_bvh_courtyard():
    """8-device CPU mesh on the 100k
    courtyard, per-shard sub-BVH traversal matching single-device hits."""
    from gpu_raytracer.parallel.shard import GeometryShards
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(target_triangles=100_000, seed=0)
    mesh = make_mesh(8)
    shards = GeometryShards(scene, 8)
    # per-shard node tables really exist and are smaller than the global one
    assert shards.node_min.shape[0] == 8
    assert shards.node_min.shape[1] < scene.bvh.num_nodes
    assert int(np.asarray(shards.orig_id).min()) == 0

    rng2 = np.random.default_rng(9)
    m = 512
    o = rng2.uniform(-40, 40, (m, 3)).astype(np.float32)
    tgt = rng2.uniform(-20, 20, (m, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    sharded = trace_geometry_sharded(scene, o, d, mesh, shards=shards)
    single = trace(scene, o, d)
    np.testing.assert_array_equal(np.asarray(sharded.hit),
                                  np.asarray(single.hit))
    h = np.asarray(single.hit)
    assert h.sum() > 100
    np.testing.assert_allclose(np.asarray(sharded.t)[h],
                               np.asarray(single.t)[h], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(sharded.material_id)[h],
                                  np.asarray(single.material_id)[h])
    # normals agree up to the winner's orientation
    dn = np.abs(np.sum(np.asarray(sharded.normal)[h]
                       * np.asarray(single.normal)[h], axis=1))
    np.testing.assert_allclose(dn, 1.0, atol=1e-4)


@needs_8
def test_geometry_sharded_packet_rays(default_scene, rng):
    """Geometry sharding with a packet-shaped ray count (whole 1024-ray
    packets per shard) and the reduction-based combine — hits must match
    the single-device trace."""
    from gpu_raytracer.parallel.shard import GeometryShards
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(target_triangles=6_000, seed=2)
    mesh = make_mesh(8)
    shards = GeometryShards(scene, 8)
    assert shards.tri_v0.shape[0] == 8    # stacked per-shard tables

    rng2 = np.random.default_rng(11)
    m = 1024                              # one whole packet
    o = rng2.uniform(-30, 30, (m, 3)).astype(np.float32)
    tgt = rng2.uniform(-15, 15, (m, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    sharded = trace_geometry_sharded(scene, o, d, mesh, shards=shards)
    single = trace(scene, o, d)
    np.testing.assert_array_equal(np.asarray(sharded.hit),
                                  np.asarray(single.hit))
    h = np.asarray(single.hit)
    assert h.sum() > 100
    np.testing.assert_allclose(np.asarray(sharded.t)[h],
                               np.asarray(single.t)[h], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(sharded.material_id)[h],
                                  np.asarray(single.material_id)[h])


@needs_8
def test_geometry_shards_empty_chunks_inert(default_scene):
    """With more shards than triangles, the empty Morton
    chunks used to duplicate triangle 0 into every padded shard — the
    masked-psum combine then summed the winner's normal / material id / uv
    once PER DUPLICATE. Padded shards must be inert: aim rays straight at
    the real triangles and require exact attribute parity with the
    single-device trace."""
    from gpu_raytracer.ops.trace import TRIANGLE

    mesh = make_mesh(8)          # 8 shards over the default scene's 2 tris
    cent = np.asarray([[0.0, 1.0 / 3.0, -2.0], [1.5, -1.0 / 6.0, -3.0]],
                      np.float32)
    n = 128
    o = np.tile(np.asarray([[0.0, 2.0, 2.0]], np.float32), (n, 1))
    jit = np.random.default_rng(5).uniform(-0.25, 0.25, (n, 3)) \
        .astype(np.float32)
    tgt = np.repeat(cent, n // 2, axis=0) + jit
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    sharded = trace_geometry_sharded(default_scene, o, d, mesh)
    single = trace(default_scene, o, d)
    np.testing.assert_array_equal(np.asarray(sharded.hit),
                                  np.asarray(single.hit))
    tri = np.asarray(single.hit) & (np.asarray(single.prim_kind) == TRIANGLE)
    assert tri.sum() > 32        # both triangles actually get hit
    np.testing.assert_allclose(np.asarray(sharded.normal)[tri],
                               np.asarray(single.normal)[tri], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(sharded.material_id)[tri],
                                  np.asarray(single.material_id)[tri])
    np.testing.assert_allclose(np.asarray(sharded.uv)[tri],
                               np.asarray(single.uv)[tri], atol=1e-5)


@needs_8
def test_geometry_ring_matches_single():
    """Ring-rotated geometry+ray sharding — each device traverses N/8 rays
    per step, blocks ppermute around the ring carrying
    the running winner — must reproduce the single-device closest hit."""
    from gpu_raytracer.parallel.shard import (GeometryShards,
                                                  trace_geometry_sharded_ring)
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(target_triangles=6_000, seed=2)
    mesh = make_mesh(8)
    shards = GeometryShards(scene, 8)

    rng2 = np.random.default_rng(13)
    m = 2048                              # 256 rays per device block
    o = rng2.uniform(-30, 30, (m, 3)).astype(np.float32)
    tgt = rng2.uniform(-15, 15, (m, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    sharded = trace_geometry_sharded_ring(scene, o, d, mesh, shards=shards)
    single = trace(scene, o, d)
    np.testing.assert_array_equal(np.asarray(sharded.hit),
                                  np.asarray(single.hit))
    h = np.asarray(single.hit)
    assert h.sum() > 200

    # non-divisible ray count exercises the block padding (1003 % 8 != 0)
    odd = trace_geometry_sharded_ring(scene, o[:1003], d[:1003], mesh,
                                      shards=shards)
    np.testing.assert_array_equal(np.asarray(odd.hit), h[:1003])
    np.testing.assert_allclose(np.asarray(odd.t)[h[:1003]],
                               np.asarray(single.t)[:1003][h[:1003]],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(sharded.t)[h],
                               np.asarray(single.t)[h], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(sharded.material_id)[h],
                                  np.asarray(single.material_id)[h])
    # (prim_id is the ORIGINAL mesh id here vs the single trace's
    # leaf-order id — not comparable; t/material/normal parity is.)
    dn = np.abs(np.sum(np.asarray(sharded.normal)[h]
                       * np.asarray(single.normal)[h], axis=1))
    np.testing.assert_allclose(dn, 1.0, atol=1e-4)


@needs_8
def test_geometry_ring_packet_blocks():
    """The ring path with packet-shaped blocks (8192 rays = 1024/device)."""
    from gpu_raytracer.parallel.shard import (GeometryShards,
                                                  trace_geometry_sharded_ring)
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(target_triangles=3_000, seed=4)
    mesh = make_mesh(8)
    shards = GeometryShards(scene, 8)

    rng2 = np.random.default_rng(17)
    m = 8192                              # 1024 per device
    o = rng2.uniform(-25, 25, (m, 3)).astype(np.float32)
    tgt = rng2.uniform(-12, 12, (m, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    sharded = trace_geometry_sharded_ring(scene, o, d, mesh, shards=shards)
    single = trace(scene, o, d)
    np.testing.assert_array_equal(np.asarray(sharded.hit),
                                  np.asarray(single.hit))
    h = np.asarray(single.hit)
    assert h.sum() > 500
    np.testing.assert_allclose(np.asarray(sharded.t)[h],
                               np.asarray(single.t)[h], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(sharded.material_id)[h],
                                  np.asarray(single.material_id)[h])


@needs_8
def test_ray_sharded_textured_matches_single():
    """The ray-sharded whole-frame path on a textured scene: the 8-device
    frame equals the single-device frame."""
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(target_triangles=1500, seed=1,
                                 textured=True)
    W, H = 64, 32
    fb = render_frame_multichip(scene, W, H, make_mesh(8))
    single = render_image(scene, W, H)
    np.testing.assert_allclose(fb, single, atol=1e-5)


@needs_8
def test_pathtrace_step_sharded_matches_single(default_scene):
    """The PRODUCTION path-trace step (pool + coherence sorts + QMC)
    under shard_map must reproduce the
    single-device PathTracer step — global QMC pixel identity makes
    every ray draw the identical lattice sample, so the 8-device
    radiance matches up to fp reassociation."""
    from gpu_raytracer.engine.pathtracer import PathTracer
    from gpu_raytracer.parallel.shard import pathtrace_step_sharded

    W = H = 32
    mesh = make_mesh(8)
    pt = PathTracer(default_scene, W, H, shadows=True, spectral=True)
    pt.step()
    single = np.asarray(pt.accum)
    counts_single = np.asarray(pt._last_counts)

    pt2 = PathTracer(default_scene, W, H, shadows=True, spectral=True)
    accum, counts = pathtrace_step_sharded(
        default_scene, pt2.accum, pt2.key, 0, pt2._px, pt2._py, mesh,
        width=W, height=H, channel=3,
        max_depth=pt2.config.max_bounce_depth,
        rr_start=pt2.config.russian_roulette_start,
        leaf_size=pt2.config.bvh_leaf_size, use_bvh=pt2.use_bvh,
        qmc=True, qmc_seed=pt2._qmc_seed)
    np.testing.assert_allclose(np.asarray(accum), single, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(counts), counts_single)
