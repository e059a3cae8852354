"""Temporal reprojection (engine/pathtracer._warp_history): camera moves
warp the path-trace accumulation into the new view instead of restarting
it. The reference restarts from scratch on every move (trigger_recompute);
this is an extension, so the tests pin its own contract:
identity-warp exactness, depth-validated history transport, disocclusion
rejection, the clamp, and the blend arithmetic after new samples arrive.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gpu_raytracer.engine.pathtracer import PathTracer
from gpu_raytracer.models.camera import Camera


def _pt(default_scene, spp=3, **kw):
    kw.setdefault("shadows", False)
    kw.setdefault("antialias", False)
    p = PathTracer(default_scene, 32, 32, **kw)
    for _ in range(spp):
        p.step()
    return p


def test_identity_warp_preserves_image(default_scene):
    pt = _pt(default_scene, spp=3)
    before = pt.image()
    pt.set_camera(pt.scene.camera, temporal=True)   # same view
    assert pt.samples == 0 and pt._count_base is not None
    n0 = np.asarray(pt._count_base)
    # every pixel revalidates against itself: full history (3 < clamp 8)
    assert (n0 > 0).mean() > 0.98
    assert n0.max() == pytest.approx(3.0)
    # the stochastic-bilinear fetch jitter may pull a few pixels whose
    # projection float-errs across the rounding boundary to a (depth-
    # valid) neighbour; the rest must round-trip exactly
    diff = np.abs(pt.image() - before).max(axis=-1)
    assert (diff > 2e-5).mean() < 0.01


def test_translation_transports_history(default_scene):
    pt = _pt(default_scene, spp=4)
    cam = pt.scene.camera
    moved = Camera(position=cam.position + jnp.asarray([0.08, 0.0, 0.0]),
                   direction=cam.direction, up=cam.up, fov=cam.fov)
    pt.set_camera(moved, temporal=True)
    n0 = np.asarray(pt._count_base)
    assert (n0 > 0).mean() > 0.5        # most pixels keep their history
    assert np.isfinite(pt.image()).all()


def test_rotation_disoccludes_new_region(default_scene):
    """A hard rotation brings off-screen content into view: those pixels
    must start from ZERO history (reprojecting them lands out of the old
    frame), while still-visible content keeps its history."""
    pt = _pt(default_scene, spp=4)
    cam = pt.scene.camera
    # rotate direction ~30 deg around Y
    c, s = np.cos(0.5), np.sin(0.5)
    d = np.asarray(cam.direction)
    nd = jnp.asarray([c * d[0] + s * d[2], d[1], -s * d[0] + c * d[2]],
                     jnp.float32)
    pt.set_camera(Camera(position=cam.position, direction=nd, up=cam.up,
                         fov=cam.fov), temporal=True)
    n0 = np.asarray(pt._count_base)
    assert (n0 == 0).any()              # disoccluded pixels restart
    assert (n0 > 0).any()               # surviving pixels keep history


def test_clamp_bounds_history(default_scene):
    pt = _pt(default_scene, spp=12)
    pt.temporal_clamp = 4.0
    pt.set_camera(pt.scene.camera, temporal=True)
    n0 = np.asarray(pt._count_base)
    assert n0.max() == pytest.approx(4.0)


def test_blend_arithmetic_after_new_samples(default_scene):
    """image() must be (history_mean*n0 + new_sum) / (n0 + k)."""
    pt = _pt(default_scene, spp=2)
    pt.set_camera(pt.scene.camera, temporal=True)
    accum0 = np.asarray(pt.accum).copy()
    n0 = np.asarray(pt._count_base).copy()
    pt.step()
    pt.step()
    want = (np.asarray(pt.accum)) / np.maximum(n0 + 2, 1.0)[:, None]
    got = pt.image()[pt._py_host, pt._px_host]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(pt.denoised_image(iterations=2)).all()


def test_reset_clears_history(default_scene):
    pt = _pt(default_scene, spp=2)
    pt.set_camera(pt.scene.camera, temporal=True)
    assert pt._count_base is not None
    pt.reset()
    assert pt._count_base is None
    assert float(np.abs(pt.image()).max()) == 0.0


def test_nontemporal_set_camera_still_resets(default_scene):
    pt = _pt(default_scene, spp=2)
    pt.set_camera(pt.scene.camera)      # default: trigger_recompute parity
    assert pt.samples == 0 and pt._count_base is None


def test_viewer_temporal_toggle(default_scene):
    from gpu_raytracer.engine.viewer import Viewer

    v = Viewer(default_scene, 32, 32, shadows=False, verbose=False)
    assert v.temporal
    v.handle_key("p")
    v.run_compute()
    v.run_compute()
    v.handle_key("w")                   # move: history warps, not resets
    v.run_compute()                     # (the warp rides the fused moving
    assert v._pt.samples == 0           # frame dispatched here)
    assert v._pt._count_base is not None
    assert np.isfinite(v.framebuffer).all()
    v.handle_key("t")                   # temporal off
    assert not v.temporal
    v.handle_key("w")
    assert v._pt._count_base is None    # plain restart


def test_adaptive_temporal_warp(default_scene):
    from gpu_raytracer.engine.adaptive import AdaptivePathTracer

    pt = AdaptivePathTracer(default_scene, 128, 128, shadows=False,
                            tiles_per_step=4)
    for _ in range(pt.adaptive_from):
        pt.step()                       # two warmup sweeps: n=2 everywhere
    pt.set_camera(pt.scene.camera, temporal=True)
    counts = np.asarray(pt.counts)
    assert pt._count_base is None       # folded into the moment buffers
    assert counts.max() == 2            # history survived as counts
    assert np.isfinite(pt.image()).all()
    pt.step()                           # adaptive stepping resumes
    assert np.asarray(pt.counts).sum() > counts.sum()


def test_cached_gbuffer_warp_matches_retrace(default_scene):
    """The steady-state warp feeds the PREVIOUS warp's depth back as the
    old-camera depth instead of retracing it — preferentially in tile
    order (packed straight into the [C,5] history gather), falling back
    to a reorder of the row-major G-buffer plane, falling back to a full
    retrace. All three variants must be bit-equal: the cached planes ARE
    the same trace's output, just routed differently."""
    import jax.numpy as jnp
    from gpu_raytracer.models.camera import Camera

    def two_warps(mode):
        pt = _pt(default_scene, spp=3)
        cam = pt.scene.camera
        m1 = Camera(position=cam.position + jnp.asarray([0.05, 0.0, 0.0]),
                    direction=cam.direction, up=cam.up, fov=cam.fov)
        m2 = Camera(position=cam.position + jnp.asarray([0.05, 0.05, 0.0]),
                    direction=cam.direction, up=cam.up, fov=cam.fov)
        pt.set_camera(m1, temporal=True)     # first warp: traces old depth
        assert pt._gbuf_tile is not None     # ...and leaves the G-buffer
        pt.step()
        if mode == "rowmajor":
            pt.gbuffer()                     # materialise row-major planes
            pt._gbuf_tile = None             # ...then force their reorder
        elif mode == "retrace":
            pt._gbuf = None                  # force the full retrace
            pt._gbuf_tile = None
        pt.set_camera(m2, temporal=True)
        return np.asarray(pt.accum), np.asarray(pt._count_base)

    a_tile, n_tile = two_warps("tile")
    a_rm, n_rm = two_warps("rowmajor")
    a_trace, n_trace = two_warps("retrace")
    np.testing.assert_array_equal(n_tile, n_rm)
    np.testing.assert_array_equal(a_tile, a_rm)
    np.testing.assert_array_equal(n_tile, n_trace)
    np.testing.assert_array_equal(a_tile, a_trace)


def test_gbuffer_cache_matches_fresh_trace(default_scene):
    """gbuffer() after a temporal warp returns the warp's byproduct — it
    must equal a from-scratch _gbuffer trace for the same scene+camera."""
    import jax.numpy as jnp
    from gpu_raytracer.models.camera import Camera

    pt = _pt(default_scene, spp=2)
    cam = pt.scene.camera
    moved = Camera(position=cam.position + jnp.asarray([0.03, 0.0, 0.0]),
                   direction=cam.direction, up=cam.up, fov=cam.fov)
    pt.set_camera(moved, temporal=True)
    cached = [np.asarray(x) for x in pt.gbuffer()]
    pt._gbuf = None
    pt._gbuf_tile = None
    fresh = [np.asarray(x) for x in pt.gbuffer()]
    for c, f in zip(cached, fresh):
        np.testing.assert_array_equal(c, f)

def test_denoise_after_warp_matches_fresh_gbuffer(default_scene):
    """After a warp, denoised_frame lazily materialises the warp's
    tile-ordered G-buffer; the frame must be bit-equal to denoising with
    a from-scratch traced G-buffer (same scene+camera)."""
    import jax.numpy as jnp
    from gpu_raytracer.models.camera import Camera

    pt = _pt(default_scene, spp=2)
    cam = pt.scene.camera
    moved = Camera(position=cam.position + jnp.asarray([0.03, 0.0, 0.0]),
                   direction=cam.direction, up=cam.up, fov=cam.fov)
    pt.set_camera(moved, temporal=True)
    pt.step()
    assert pt._gbuf_tile is not None and pt._gbuf is None
    lazy = np.asarray(pt.denoised_frame(iterations=2))
    assert pt._gbuf is not None          # materialised once, then cached
    pt._gbuf = None
    pt._gbuf_tile = None                 # force the fresh-trace route
    fresh = np.asarray(pt.denoised_frame(iterations=2))
    np.testing.assert_array_equal(lazy, fresh)
