"""Wavefront path tracing tests: reference-mode parity, energy sanity,
Russian roulette, progressive accumulation."""

import numpy as np
import jax
import jax.numpy as jnp

from gpu_raytracer import build_default_scene
from gpu_raytracer.engine.pathtracer import PathTracer
from gpu_raytracer.ops.rng import lcg_next_f32, lcg_pixel_seed
from gpu_raytracer.ops.wavefront import (
    SKY_WAVEFRONT, camera_wavefront_rays, path_trace_pool,
    wavefront_single_bounce,
)


def test_lcg_matches_reference_constants():
    """SimpleRng (shader/src/wavefront.rs:50-72): LCG with Numerical Recipes
    constants; next_f32 = (u >> 8) / 2^24."""
    state = jnp.asarray([12345], jnp.uint32)
    s1, f1 = lcg_next_f32(state)
    expect_u = (12345 * 1664525 + 1013904223) & 0xFFFFFFFF
    assert int(s1[0]) == expect_u
    assert abs(float(f1[0]) - (expect_u >> 8) / 16777216.0) < 1e-9
    seed = lcg_pixel_seed(7, jnp.asarray([3], jnp.uint32),
                          jnp.asarray([2], jnp.uint32), 100)
    assert int(seed[0]) == 7 + 3 + 2 * 100


def test_single_bounce_reference_semantics(default_scene):
    """Shipped wavefront behaviour: miss → sky(0.1,0.2,0.3)×throughput; hit →
    shading×throughput, then terminate (shader/src/lib.rs:92-149)."""
    W = H = 32
    py, px = np.mgrid[0:H, 0:W]
    px = jnp.asarray(px.reshape(-1))
    py = jnp.asarray(py.reshape(-1))
    color = np.asarray(wavefront_single_bounce(default_scene, px, py, W, H))
    img = color.reshape(H, W, 3)
    # corners miss → exactly the wavefront sky color
    np.testing.assert_allclose(img[0, 0], np.asarray(SKY_WAVEFRONT), atol=1e-7)
    # centre hits the red sphere → differs from sky, red-dominant
    c = img[H // 2, W // 2]
    assert c[0] > c[2]

    # hits must equal the legacy shading path exactly (same formulas)
    from gpu_raytracer.engine.renderer import render_chunk
    legacy = np.asarray(render_chunk(default_scene, px, py, W, H))
    from gpu_raytracer.ops.camera_rays import generate_rays
    from gpu_raytracer.ops.trace import trace
    o, d = generate_rays(default_scene.camera, W, H, px, py)
    hits = np.asarray(trace(default_scene, o, d).hit)
    np.testing.assert_allclose(color[hits], legacy[hits], atol=1e-6)


def test_camera_wavefront_ray_defaults(default_scene):
    """WavefrontRay::camera_ray (shared/src/lib.rs:861-878)."""
    rays = camera_wavefront_rays(default_scene.camera, 8, 8,
                                 jnp.asarray([3]), jnp.asarray([5]), 2)
    assert float(rays.throughput[0, 0]) == 1.0
    assert float(rays.medium_ior[0]) == 1.0
    assert float(rays.t_min[0]) == np.float32(1e-3)
    assert int(rays.ray_type[0]) == 0
    assert int(rays.bounce_depth[0]) == 0
    assert int(rays.wavelength_channel[0]) == 2
    assert int(rays.pixel[0]) == 5 * 8 + 3
    assert bool(rays.active[0])


def test_path_trace_terminates_and_is_finite(default_scene):
    W = H = 24
    py, px = np.mgrid[0:H, 0:W]
    rays = camera_wavefront_rays(default_scene.camera, W, H,
                                 jnp.asarray(px.reshape(-1)),
                                 jnp.asarray(py.reshape(-1)), 1)
    rad, counts = path_trace_pool(default_scene, rays, jax.random.PRNGKey(0),
                                  max_depth=4, shadows=True)
    counts = np.asarray(counts)
    # depth 0 has the full pool active; populations shrink monotonically
    assert counts[0] == W * H
    assert all(counts[i] >= counts[i + 1] for i in range(len(counts) - 1))
    rad = np.asarray(rad)
    assert np.isfinite(rad).all()
    assert (rad >= 0).all()
    assert rad.max() > 0.05


def test_depth_zero_equals_single_bounce_plus_continuation_energy(default_scene):
    """max_depth=0 must reproduce the single-bounce result exactly (no RR,
    no continuation) when shadows are off."""
    W = H = 16
    py, px = np.mgrid[0:H, 0:W]
    px = jnp.asarray(px.reshape(-1))
    py = jnp.asarray(py.reshape(-1))
    rays = camera_wavefront_rays(default_scene.camera, W, H, px, py, 0)
    rad0 = np.asarray(path_trace_pool(default_scene, rays,
                                      jax.random.PRNGKey(1), max_depth=0,
                                      rr_start=99, shadows=False)[0])
    single = np.asarray(wavefront_single_bounce(default_scene, px, py, W, H))
    np.testing.assert_allclose(rad0, single, atol=1e-5)


def test_pathtracer_accumulation(default_scene):
    from gpu_raytracer import RaytracerConfig

    pt = PathTracer(default_scene, 16, 16,
                    config=RaytracerConfig(ray_batch_size=256, max_bounce_depth=2),
                    spectral=False, antialias=True)
    pt.step()
    img1 = pt.image()
    pt.step()
    img2 = pt.image()
    assert pt.samples == 2
    assert np.isfinite(img2).all()
    # accumulation averages: after reset the buffer clears
    pt.reset()
    assert pt.samples == 0
    assert float(np.abs(pt.image()).max()) == 0.0
    assert img1.shape == img2.shape == (16, 16, 3)


def test_spectral_mode_runs(default_scene):
    from gpu_raytracer import RaytracerConfig

    pt = PathTracer(default_scene, 8, 8,
                    config=RaytracerConfig(ray_batch_size=64, max_bounce_depth=2),
                    spectral=True, antialias=False)
    img = pt.render(2)
    assert img.shape == (8, 8, 3)
    assert np.isfinite(img).all()


def test_pathtracer_counters_real_device_counts(default_scene):
    """WavefrontCounters populated with REAL per-depth actives (the
    reference fills them with a simulated 0.7^depth decay,
    src/compute.rs:467-474)."""
    from gpu_raytracer.engine.pathtracer import PathTracer

    pt = PathTracer(default_scene, 32, 32, spectral=False, shadows=False)
    pt.step()
    wc = pt.counters()
    assert wc.has_any_active_rays()
    assert wc.get_ray_count(0) == 32 * 32          # all camera rays active
    assert wc.get_ray_count(1) <= wc.get_ray_count(0)
    assert wc.next_active_bounce_depth(0) in (1, None)


def test_multi_spp_pooled_step(default_scene):
    """samples_per_step=2 traces both samples in one pooled wavefront; the
    accumulated mean must agree statistically with two 1-spp steps."""
    from gpu_raytracer.engine.pathtracer import PathTracer

    a = PathTracer(default_scene, 32, 32, shadows=False, seed=5,
                   samples_per_step=2)
    a.step()
    assert a.samples == 2
    img_a = a.image()
    assert np.isfinite(img_a).all()

    b = PathTracer(default_scene, 32, 32, shadows=False, seed=5)
    b.step()
    b.step()
    img_b = b.image()
    # independent RNG streams -> compare aggregate brightness, not pixels
    assert abs(img_a.mean() - img_b.mean()) / max(img_b.mean(), 1e-6) < 0.25


def test_permute_pool_packed_field_roundtrip(default_scene):
    """The 16-column packed permute (channel|ray_type|depth|active in ONE
    exact-f32 field) must round-trip every field for an arbitrary
    permutation, including the extremes of each bit range (depth 61,
    channel 3, ray_type 3, active on/off)."""
    import jax
    import numpy as np
    import jax.numpy as jnp
    from gpu_raytracer.ops.wavefront import (
        camera_wavefront_rays, _permute_pool, RGB_CHANNEL)
    from gpu_raytracer.utils.pytree import replace

    N = 512
    rng = np.random.default_rng(5)
    px = jnp.asarray(rng.integers(0, 64, N).astype(np.int32))
    py = jnp.asarray(rng.integers(0, 64, N).astype(np.int32))
    r = camera_wavefront_rays(default_scene.camera, 64, 64, px, py,
                              RGB_CHANNEL)
    r = replace(
        r,
        ray_type=jnp.asarray(rng.integers(0, 4, N).astype(np.int32)),
        bounce_depth=jnp.asarray(
            rng.choice([0, 1, 7, 33, 61], N).astype(np.int32)),
        wavelength_channel=jnp.asarray(
            rng.integers(0, 4, N).astype(np.int32)),
        active=jnp.asarray(rng.integers(0, 2, N).astype(bool)),
        medium_ior=jnp.asarray(rng.uniform(1.0, 2.5, N).astype(np.float32)),
    )
    radiance = jnp.asarray(rng.random((N, 3), np.float32))
    orig = jnp.asarray(rng.permutation(N).astype(np.int32))
    perm = jnp.asarray(rng.permutation(N).astype(np.int32))
    r2, rad2, orig2 = _permute_pool(r, radiance, orig, perm)

    p = np.asarray(perm)
    np.testing.assert_array_equal(np.asarray(r2.ray_type),
                                  np.asarray(r.ray_type)[p])
    np.testing.assert_array_equal(np.asarray(r2.bounce_depth),
                                  np.asarray(r.bounce_depth)[p])
    np.testing.assert_array_equal(np.asarray(r2.wavelength_channel),
                                  np.asarray(r.wavelength_channel)[p])
    np.testing.assert_array_equal(np.asarray(r2.active),
                                  np.asarray(r.active)[p])
    np.testing.assert_array_equal(np.asarray(r2.pixel),
                                  np.asarray(r.pixel)[p])
    np.testing.assert_array_equal(np.asarray(orig2), np.asarray(orig)[p])
    np.testing.assert_array_equal(np.asarray(r2.origin),
                                  np.asarray(r.origin)[p])
    np.testing.assert_array_equal(np.asarray(r2.medium_ior),
                                  np.asarray(r.medium_ior)[p])
    np.testing.assert_array_equal(np.asarray(rad2), np.asarray(radiance)[p])
    # pool-constant fields pass through untouched
    np.testing.assert_array_equal(np.asarray(r2.t_min), np.asarray(r.t_min))
    np.testing.assert_array_equal(np.asarray(r2.inv_pdf),
                                  np.asarray(r.inv_pdf))
