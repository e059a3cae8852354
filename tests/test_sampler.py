"""Low-discrepancy sampler (ops/sampler.py): fixed-point exactness,
per-pixel stratification, and end-to-end variance reduction through the
PathTracer vs the independent threefry stream.

The reference has no QMC analogue (its shaders draw from a per-pixel LCG,
shader/src/wavefront.rs:44-72); this is an
quality-per-sample extension. Measured on the default scene (CPU, 32x32,
depth 4, shadows, 4 seeds): MSE ratio qmc/rng = 0.50 / 0.46 / 0.48 at
8 / 16 / 32 spp — QMC halves the error at equal cost.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gpu_raytracer.ops.sampler import (
    JITTER_TAG, N_DIMS, _alphas_q, qmc_jitter, qmc_uniforms)

M32 = 0xFFFFFFFF


def _np_pcg(x):
    x = np.asarray(x, np.uint64)
    x = (x * 747796405 + 2891336453) & M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (x >> 22) ^ x


def _np_qmc(pid, s, depth, seed, alphas_q):
    """uint64 NumPy mirror of qmc_uniforms — the lattice math is exact
    wrapping u32 fixed point, so the JAX version must match bit-for-bit."""
    pid = np.asarray(pid, np.uint64)
    s = np.asarray(s, np.uint64)
    hd = _np_pcg((np.uint64(depth) * 0x9E3779B9 + np.uint64(seed)) & M32)
    h = _np_pcg(pid ^ hd)
    cols = []
    for k, a in enumerate(np.asarray(alphas_q, np.uint64)):
        rot = _np_pcg((h + ((k * 0x85EBCA6B + 0x165667B1) & M32)) & M32)
        v = (a * s + rot) & M32
        cols.append((v >> 8).astype(np.float32) / np.float32(1 << 24))
    return np.stack(cols, -1)


def test_bitexact_vs_numpy_mirror():
    pid = jnp.asarray([0, 1, 7, 123456, 2**31 - 1], jnp.int32)
    s = jnp.asarray([0, 1, 63, 100000, 2**20], jnp.int32)
    for depth in (0, 3, int(JITTER_TAG)):
        got = np.asarray(qmc_uniforms(pid, s, depth, 42))
        want = _np_qmc(np.asarray(pid), np.asarray(s), depth, 42,
                       _alphas_q(N_DIMS))
        np.testing.assert_array_equal(got, want)


def test_marginals_uniform():
    n = 4096
    u = np.asarray(qmc_uniforms(jnp.arange(n) % 17, jnp.arange(n) // 17,
                                2, 0))
    assert u.shape == (n, N_DIMS)
    assert (u >= 0).all() and (u < 1).all()
    assert np.abs(u.mean(0) - 0.5).max() < 0.02


def test_per_pixel_stratification():
    """64 successive samples of ONE pixel must cover [0,1) with far lower
    discrepancy than independent draws: additive-recurrence max gap is
    ~2.5/N (measured 0.017-0.043 across the 7 dims); i.i.d. would sit
    near log(N)/N ~ 0.1 with heavy tails."""
    u = np.asarray(qmc_uniforms(jnp.zeros(64, jnp.int32), jnp.arange(64),
                                1, 7))
    for k in range(N_DIMS):
        v = np.sort(u[:, k])
        gaps = np.diff(np.concatenate([[v[-1] - 1.0], v]))  # circular
        assert gaps.max() < 0.06, (k, gaps.max())


def test_jitter_2d_spread():
    """The R_2 pixel jitter spreads 64 sample positions with a minimum
    pairwise distance ~0.08 (an i.i.d. set collides at ~0.01)."""
    j = np.asarray(qmc_jitter(jnp.zeros(64, jnp.int32), jnp.arange(64), 0))
    d2 = ((j[None] - j[:, None]) ** 2).sum(-1)
    mind = np.sqrt(d2[np.triu_indices(64, 1)].min())
    assert mind > 0.05, mind


def test_spatially_white_across_pixels():
    """What matters for image quality is that at any FIXED sample index
    the values across pixels are white in pixel space (the per-pixel
    Cranley-Patterson phase is a hash of pid). Two pixels' s-SEQUENCES of
    one dim are necessarily correlated — they are phase-shifted copies of
    the same 1D lattice (corr of frac(x+a) vs frac(x+b) ranges up to 1);
    that correlation is invisible spatially because the phases are white.
    Assert the spatial property: per-fixed-s uniformity and no
    neighbour-pid correlation."""
    n = 4096
    pid = jnp.arange(n, dtype=jnp.int32)
    for s_fix in (0, 7, 63):
        u = np.asarray(qmc_uniforms(pid, jnp.full((n,), s_fix), 1, 0))
        assert np.abs(u.mean(0) - 0.5).max() < 0.03
        for k in range(N_DIMS):
            # lag-1 autocorrelation over pid ~ N(0, 1/sqrt(n))
            assert abs(np.corrcoef(u[:-1, k], u[1:, k])[0, 1]) < 0.08


def test_qmc_pooled_step_equals_sequential():
    """Under QMC the sample stream is addressed by (pixel, sample index),
    not by pool layout: samples_per_step=2 in ONE pooled wavefront must
    reproduce two sequential 1-spp steps to fp-order tolerance (with the
    independent stream these differ statistically — see
    test_multi_spp_pooled_step)."""
    from gpu_raytracer import build_default_scene
    from gpu_raytracer.engine.pathtracer import PathTracer

    sc = build_default_scene()
    a = PathTracer(sc, 16, 16, shadows=False, seed=5, samples_per_step=2)
    a.step()
    b = PathTracer(sc, 16, 16, shadows=False, seed=5)
    b.step()
    b.step()
    assert a.samples == b.samples == 2
    np.testing.assert_allclose(a.image(), b.image(), atol=2e-6)


def test_qmc_reduces_mse(default_scene):
    """End-to-end variance reduction: at 8 spp the QMC accumulation must
    land measurably closer to a converged reference than the independent
    stream (measured ratio ~0.5; asserted < 0.85 over 2 seeds)."""
    from gpu_raytracer.engine.pathtracer import PathTracer

    W = H = 16
    ref = np.zeros((H, W, 3), np.float32)
    for sd in (100, 101):
        pt = PathTracer(default_scene, W, H, shadows=False, seed=sd,
                        sampler="rng")
        for _ in range(128):
            pt.step()
        ref += pt.image()
    ref /= 2.0

    def mse(sampler):
        tot = 0.0
        for sd in (0, 1):
            pt = PathTracer(default_scene, W, H, shadows=False, seed=sd,
                            sampler=sampler)
            for _ in range(8):
                pt.step()
            tot += float(((pt.image() - ref) ** 2).mean())
        return tot / 2.0

    m_rng, m_qmc = mse("rng"), mse("qmc")
    assert m_qmc < 0.85 * m_rng, (m_qmc, m_rng)


def test_qmc_checkpoint_resume_exact(default_scene, tmp_path):
    """Resume continues the lattice exactly: sample_base comes from the
    restored `samples` count, so checkpoint+resume reproduces the
    uninterrupted accumulation bit-for-bit (8 spp straight == 4 spp +
    checkpoint + 4 spp)."""
    from gpu_raytracer.engine.pathtracer import PathTracer

    p = str(tmp_path / "ckpt.npz")
    a = PathTracer(default_scene, 16, 16, shadows=False, seed=3)
    for _ in range(4):
        a.step()
    a.save_checkpoint(p)
    for _ in range(4):
        a.step()
    b = PathTracer(default_scene, 16, 16, shadows=False, seed=3)
    b.load_checkpoint(p)
    for _ in range(4):
        b.step()
    np.testing.assert_allclose(a.image(), b.image(), atol=1e-6)


def test_rng_sampler_still_available():
    from gpu_raytracer import build_default_scene
    from gpu_raytracer.engine.pathtracer import PathTracer

    sc = build_default_scene()
    r = PathTracer(sc, 8, 8, shadows=False, sampler="rng")
    r.step()
    q = PathTracer(sc, 8, 8, shadows=False, sampler="qmc")
    q.step()
    assert np.isfinite(r.image()).all() and np.isfinite(q.image()).all()
    assert not np.allclose(r.image(), q.image())
    with pytest.raises(ValueError):
        PathTracer(sc, 8, 8, sampler="sobol")
