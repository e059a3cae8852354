"""Adaptive (variance-guided) path tracing — engine/adaptive.py.

The reference spends its progressive budget uniformly (tile round-robin,
src/compute.rs); adaptive allocation is an
extension. These tests pin: round-robin warmup coverage, error-guided
concentration after warmup, per-pixel-count mean correctness, checkpoint
round-trip, and the denoised reconstruction under heterogeneous counts.
"""

import numpy as np
import pytest

from gpu_raytracer.engine.adaptive import TILE_PX, AdaptivePathTracer
from gpu_raytracer.engine.pathtracer import PathTracer


def _make(default_scene, K=2, **kw):
    # 128x128 -> T = 4 tiles of 64x64
    kw.setdefault("shadows", False)
    return AdaptivePathTracer(default_scene, 128, 128, tiles_per_step=K,
                              **kw)


def test_requires_tile_multiple(default_scene):
    with pytest.raises(ValueError):
        AdaptivePathTracer(default_scene, 100, 64)


def test_warmup_covers_every_tile(default_scene):
    pt = _make(default_scene, K=2)
    assert pt.T == 4 and pt.adaptive_from == 4   # two full sweeps
    pt.step()
    pt.step()
    counts = np.asarray(pt.counts)
    assert (counts == 1).all()          # first sweep: every tile once
    assert pt.samples == pytest.approx(1.0)
    pt.step()
    pt.step()
    counts = np.asarray(pt.counts)
    assert (counts == 2).all()          # second sweep: variance seeded


def test_adaptive_concentrates_samples(default_scene):
    pt = _make(default_scene, K=1)      # one tile per step after warmup
    for _ in range(pt.adaptive_from + 8):
        pt.step()
    counts = np.asarray(pt.counts).reshape(pt.T, TILE_PX)
    per_tile = counts[:, 0]
    # every tile seeded, refinement went somewhere specific
    assert (counts >= 1).all()
    assert (counts == counts[:, :1]).all()      # uniform within a tile
    assert per_tile.max() >= per_tile.min() + 4  # concentrated, not spread
    img = pt.image()
    assert np.isfinite(img).all() and img.max() > 0


def test_image_is_per_pixel_mean(default_scene):
    pt = _make(default_scene, K=2)
    for _ in range(5):
        pt.step()
    n = np.maximum(np.asarray(pt.counts), 1)[:, None]
    want = np.asarray(pt.accum) / n
    got = pt.image()[pt._py_host, pt._px_host]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_statistical_agreement_with_uniform(default_scene):
    """The adaptive estimator is unbiased: its converged mean brightness
    must agree with the uniform tracer's."""
    a = _make(default_scene, K=4, seed=2)   # K == T -> every step uniform
    for _ in range(8):
        a.step()
    u = PathTracer(default_scene, 128, 128, shadows=False, seed=3)
    for _ in range(8):
        u.step()
    ma, mu = a.image().mean(), u.image().mean()
    assert abs(ma - mu) / max(mu, 1e-6) < 0.2


def test_checkpoint_roundtrip(default_scene, tmp_path):
    p = str(tmp_path / "ada.npz")
    a = _make(default_scene, K=2, seed=1)
    for _ in range(4):
        a.step()
    a.save_checkpoint(p)
    b = _make(default_scene, K=2, seed=1)
    b.load_checkpoint(p)
    assert b._steps == a._steps
    np.testing.assert_array_equal(np.asarray(a.counts), np.asarray(b.counts))
    np.testing.assert_allclose(a.image(), b.image())
    b.step()                                    # resumes cleanly
    assert np.asarray(b.counts).sum() > np.asarray(a.counts).sum()


def test_denoised_image_heterogeneous_counts(default_scene):
    pt = _make(default_scene, K=1)
    for _ in range(pt.adaptive_from + 2):
        pt.step()
    img = pt.denoised_image(iterations=2)
    assert img.shape == (128, 128, 3)
    assert np.isfinite(img).all()
