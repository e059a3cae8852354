"""Edge-avoiding à-trous denoiser (ops/denoise.py) — an addition beyond
the reference (it ships no reconstruction filter; its wavefront path
tracer is a stub, src/compute.rs:365-553).

Property tests on synthetic G-buffers (noise shrinks on flat regions,
geometric edges and albedo detail survive, sky never bleeds) plus an
end-to-end PathTracer.denoised_image run on the default scene.
"""

import numpy as np
import jax.numpy as jnp

from gpu_raytracer.ops.denoise import atrous_denoise


def _flat_gbuffer(h, w):
    normal = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (h, w, 3))
    depth = jnp.full((h, w), 5.0)
    return normal, depth


def test_flat_region_noise_shrinks():
    """Constant illumination + white noise on a flat wall: the filter must
    cut the MSE to the clean image by well over an order of magnitude."""
    h = w = 64
    rng = np.random.default_rng(0)
    clean = np.full((h, w, 3), 0.5, np.float32)
    noisy = clean + rng.normal(0, 0.1, clean.shape).astype(np.float32)
    normal, depth = _flat_gbuffer(h, w)
    out = np.asarray(atrous_denoise(jnp.asarray(noisy), normal, depth,
                                    iterations=4))
    mse_in = float(np.mean((noisy - clean) ** 2))
    mse_out = float(np.mean((out - clean) ** 2))
    assert mse_out < mse_in / 15.0, (mse_in, mse_out)


def test_normal_edge_preserved():
    """Two walls at different normals and different illumination: each
    side converges toward its own mean, nothing crosses the crease."""
    h = w = 64
    rng = np.random.default_rng(1)
    left = np.asarray([0.8, 0.2, 0.2], np.float32)
    right = np.asarray([0.1, 0.1, 0.6], np.float32)
    clean = np.empty((h, w, 3), np.float32)
    clean[:, : w // 2] = left
    clean[:, w // 2:] = right
    noisy = clean + rng.normal(0, 0.05, clean.shape).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2] = [0.0, 0.0, 1.0]
    normal[:, w // 2:] = [1.0, 0.0, 0.0]
    depth = jnp.full((h, w), 5.0)
    out = np.asarray(atrous_denoise(jnp.asarray(noisy), jnp.asarray(normal),
                                    depth, iterations=4))
    # per-side error to the side's clean colour shrinks...
    for sl, ref in ((np.s_[:, : w // 2], left), (np.s_[:, w // 2:], right)):
        mse_in = float(np.mean((noisy[sl] - ref) ** 2))
        mse_out = float(np.mean((out[sl] - ref) ** 2))
        assert mse_out < mse_in / 4.0, (mse_in, mse_out)
    # ...and the step stays a step: columns adjacent to the crease keep
    # their own side's colour (no cross-edge bleed beyond the noise floor)
    assert np.allclose(out[:, w // 2 - 1].mean(axis=0), left, atol=0.03)
    assert np.allclose(out[:, w // 2].mean(axis=0), right, atol=0.03)


def test_depth_edge_preserved():
    """Same normal but a large depth step (wall in front of wall): the
    depth weight alone must keep the two illumination levels apart."""
    h = w = 64
    rng = np.random.default_rng(2)
    clean = np.empty((h, w, 3), np.float32)
    clean[: h // 2] = 0.9
    clean[h // 2:] = 0.15
    noisy = clean + rng.normal(0, 0.05, clean.shape).astype(np.float32)
    normal = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (h, w, 3))
    depth = np.full((h, w), 2.0, np.float32)
    depth[h // 2:] = 10.0
    out = np.asarray(atrous_denoise(jnp.asarray(noisy), normal,
                                    jnp.asarray(depth), iterations=4))
    assert abs(float(out[: h // 2].mean()) - 0.9) < 0.03
    assert abs(float(out[h // 2:].mean()) - 0.15) < 0.03


def test_albedo_detail_survives_demodulation():
    """A checkerboard albedo under flat noisy illumination: texture detail
    lives in the demodulation factor and must come back at full contrast,
    while the illumination noise still shrinks."""
    h = w = 64
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (((yy // 4) + (xx // 4)) % 2).astype(np.float32)
    albedo = np.repeat((0.2 + 0.7 * checker)[..., None], 3, axis=-1)
    illum = 0.6 + rng.normal(0, 0.08, (h, w, 3)).astype(np.float32)
    noisy = albedo * illum
    clean = albedo * 0.6
    normal, depth = _flat_gbuffer(h, w)
    out = np.asarray(atrous_denoise(jnp.asarray(noisy), normal, depth,
                                    jnp.asarray(albedo), iterations=4))
    mse_in = float(np.mean((noisy - clean) ** 2))
    mse_out = float(np.mean((out - clean) ** 2))
    assert mse_out < mse_in / 10.0, (mse_in, mse_out)
    # the checker contrast ratio is intact (demodulation is exact)
    hi = out[checker > 0.5].mean()
    lo = out[checker < 0.5].mean()
    assert abs(hi / lo - 0.9 / 0.2) < 0.2, (hi, lo)


def test_sky_does_not_bleed():
    """Miss pixels carry a zero normal: a bright sky half-frame must not
    leak into dark geometry, and the sky itself stays untouched."""
    h = w = 32
    clean = np.empty((h, w, 3), np.float32)
    clean[: h // 2] = 1.0        # sky (miss)
    clean[h // 2:] = 0.05        # dark floor
    normal = np.zeros((h, w, 3), np.float32)
    normal[h // 2:] = [0.0, 1.0, 0.0]
    depth = np.full((h, w), 1e30, np.float32)
    depth[h // 2:] = 3.0
    out = np.asarray(atrous_denoise(jnp.asarray(clean), jnp.asarray(normal),
                                    jnp.asarray(depth), iterations=3))
    assert np.allclose(out[: h // 2], 1.0, atol=1e-5)       # sky untouched
    assert np.abs(out[h // 2:] - 0.05).max() < 1e-5          # no bleed


def test_pathtracer_denoised_image_end_to_end(default_scene):
    """denoised_image on the default scene: right shape, finite, and
    closer to a higher-spp reference than the raw accumulation."""
    from gpu_raytracer.engine.pathtracer import PathTracer

    w = h = 32
    pt = PathTracer(default_scene, w, h, shadows=False, seed=3)
    for _ in range(2):
        pt.step()
    raw = pt.image()
    den = pt.denoised_image(iterations=3)
    assert den.shape == (h, w, 3) and np.isfinite(den).all()

    ref = PathTracer(default_scene, w, h, shadows=False, seed=11)
    for _ in range(48):
        ref.step()
    ref_img = ref.image()
    mse_raw = float(np.mean((raw - ref_img) ** 2))
    mse_den = float(np.mean((den - ref_img) ** 2))
    assert mse_den < mse_raw, (mse_raw, mse_den)


def test_gbuffer_shapes_and_miss_convention(default_scene):
    from gpu_raytracer.engine.pathtracer import PathTracer

    pt = PathTracer(default_scene, 24, 16, shadows=False)
    normal, depth, albedo = pt.gbuffer()
    assert normal.shape == (16, 24, 3)
    assert depth.shape == (16, 24)
    assert albedo.shape == (16, 24, 3)
    n2 = np.asarray(jnp.sum(normal * normal, axis=-1))
    miss = n2 < 0.25
    assert miss.any() and (~miss).any()   # the demo scene has sky + geometry
    assert np.allclose(np.asarray(albedo)[miss], 1.0)
