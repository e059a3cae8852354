"""Interleaved fly-through sampling (PathTracer.step_interleaved /
Viewer.fly_interleave): coverage, bookkeeping, and bounded quality vs the
full-step pipeline."""

import numpy as np
import jax.numpy as jnp
import pytest

from gpu_raytracer import build_default_scene
from gpu_raytracer.engine.pathtracer import PathTracer
from gpu_raytracer.engine.viewer import Viewer


W, H = 64, 64


@pytest.fixture(scope="module")
def scene():
    return build_default_scene()


def test_full_rotation_covers_every_pixel_once(scene):
    pt = PathTracer(scene, W, H, shadows=False)
    m = 4
    assert pt.interleave_ok(m)
    for _ in range(m):
        pt.step_interleaved(m)
    counts = np.asarray(pt._count_base)
    assert pt.samples == 0
    np.testing.assert_array_equal(counts, np.ones(W * H, np.float32))
    img = pt.image()
    assert np.isfinite(img).all() and (img >= 0).all()
    # content actually reached the frame (default scene is mostly lit)
    assert img.mean() > 1e-3


def test_cosets_partition_the_frame(scene):
    pt = PathTracer(scene, W, H, shadows=False)
    for m in (2, 4, 8):
        sets = pt._cosets(m)
        all_idx = np.concatenate([np.asarray(i) for i, _, _ in sets])
        assert all_idx.shape[0] == W * H
        assert np.array_equal(np.sort(all_idx), np.arange(W * H))
        for idx, px, py in sets:
            i = np.asarray(idx)
            assert (np.diff(i) > 0).all()          # sorted, unique
            # the coset's coords match the accumulator rows it scatters to
            np.testing.assert_array_equal(np.asarray(px),
                                          pt._px_host[i])
            np.testing.assert_array_equal(np.asarray(py),
                                          pt._py_host[i])


def test_mixed_full_and_partial_bookkeeping(scene):
    pt = PathTracer(scene, W, H, shadows=False)
    pt.step()                          # scalar count 1 everywhere
    pt.step_interleaved(4)             # +1 on one quarter
    counts = np.asarray(pt._count_base)
    assert pt.samples == 0             # folded into the vector
    assert (np.sort(np.unique(counts)) == [1.0, 2.0]).all()
    assert (counts == 2.0).sum() == W * H // 4
    img = pt.image()
    assert np.isfinite(img).all()


def test_interleaved_mean_matches_full_mean(scene):
    """One full rotation of interleaved steps estimates the same image as
    a full step: both are 1-spp unbiased estimators, so their difference
    on a mostly-diffuse scene is sample noise, not bias. Compare means
    over a few samples with a generous-but-meaningful bound."""
    pt_a = PathTracer(scene, W, H, shadows=False, seed=0)
    pt_b = PathTracer(scene, W, H, shadows=False, seed=0)
    spp = 4
    for _ in range(spp):
        pt_a.step()
    for _ in range(4 * spp):
        pt_b.step_interleaved(4)
    a, b = pt_a.image(), pt_b.image()
    assert np.asarray(pt_b._count_base).min() == spp
    mse = float(np.mean((a - b) ** 2))
    ref = float(np.mean(a ** 2)) + 1e-9
    assert mse / ref < 0.5, (mse, ref)   # noise-level, not structural


def test_viewer_fly_interleave_quality_bounded(scene):
    """Quality bound: the interleaved fly pipeline (warp +
    1/m sampling + denoise) must stay close to the FULL fly pipeline on
    the same camera path. Threshold: relative MSE < 0.05 between the two
    presented (denoised f32) frames after a short fly."""
    def fly(interleave):
        v = Viewer(scene, W, H, shadows=False, verbose=False)
        v.handle_key("p")
        v.fly_interleave = interleave
        for _ in range(6):
            v.run_compute()               # seed accumulation (full steps)
        for k in "wdwa":
            v.handle_key(k)               # warp + (interleaved) step
            v.run_compute()
        return np.asarray(v._fb_dev)

    full = fly(1)
    part = fly(4)
    assert full.shape == part.shape == (H, W, 3)
    rel = float(np.mean((full - part) ** 2) / (np.mean(full ** 2) + 1e-9))
    assert rel < 0.05, rel


def test_interleave_falls_back_when_frame_does_not_divide(scene):
    pt = PathTracer(scene, 66, 33, shadows=False)   # 33 odd: no 2x2 grid
    assert not pt.interleave_ok(4)
    pt.step_interleaved(4)                          # silently a full step
    assert pt.samples == 1 and pt._count_base is None
