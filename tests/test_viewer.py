"""Viewer / interactive shell tests."""

import numpy as np

from gpu_raytracer import RaytracerConfig
from gpu_raytracer.engine.viewer import Viewer


def _viewer(scene, w=64, h=48):
    # small tile so the progressive cursor actually advances frame by frame
    return Viewer(scene, w, h, config=RaytracerConfig(tile_size=32),
                  verbose=False)


def test_progressive_frames_fill_framebuffer(default_scene):
    v = _viewer(default_scene)
    assert v.progressive.total_tiles == 4  # 2x2 tiles of 32px over 64x48
    n = v.run_compute()
    assert n >= 1
    v.render_to_completion()
    assert v.progressive.complete
    # idle frame renders nothing (compute.rs:85-100)
    assert v.run_compute() == 0
    assert np.isfinite(v.framebuffer).all()
    assert v.framebuffer.max() > 0.0


def test_key_movement_triggers_recompute(default_scene):
    v = _viewer(default_scene)
    v.render_to_completion()
    fb1 = v.framebuffer.copy()
    v.handle_key("a")
    assert not v.progressive.complete  # recompute triggered
    v.render_to_completion()
    assert not np.array_equal(fb1, v.framebuffer)


def test_mouse_drag_rotates(default_scene):
    v = _viewer(default_scene)
    d0 = v.controller.direction.copy()
    v.handle_mouse_drag(50.0, 10.0)
    assert not np.allclose(d0, v.controller.direction)
    assert abs(np.linalg.norm(v.controller.direction) - 1.0) < 1e-5


def test_escape_quits(default_scene):
    v = _viewer(default_scene)
    v.handle_key("escape")
    assert v.should_quit


def test_failed_gltf_load_keeps_scene(default_scene):
    v = _viewer(default_scene)
    before = v.scene
    v.load_gltf("/nonexistent/model.gltf")
    assert v.scene is before


def test_fly_through_script(default_scene):
    v = _viewer(default_scene, 32, 32)
    frames = v.fly_through([("key", "w"), ("mouse", 20.0, 0.0), ("key", "s")],
                           frames_per_step=1)
    assert len(frames) == 3
    for f in frames:
        assert np.isfinite(f).all()


def test_edge_tiles_clamp(default_scene):
    # 50x40 with 32px tiles -> ragged edge tiles must fill exactly
    v = Viewer(default_scene, 50, 40, config=RaytracerConfig(tile_size=32),
               verbose=False)
    v.render_to_completion()
    assert v.framebuffer.shape == (40, 50, 3)
    assert np.isfinite(v.framebuffer).all()


def test_viewer_pathtrace_toggle():
    """'p' switches the event loop to progressive path tracing; camera
    moves restart accumulation; 'p' again returns to Whitted."""
    from gpu_raytracer import build_default_scene
    from gpu_raytracer.engine.viewer import Viewer

    v = Viewer(build_default_scene(), 32, 32, shadows=False, verbose=False)
    v.handle_key("p")
    assert v.pathtrace
    v.run_compute()
    v.run_compute()
    assert v._pt.samples == 2
    fb = v.framebuffer
    assert np.isfinite(fb).all() and fb.shape == (32, 32, 3)
    v.handle_key("w")              # move -> warp deferred to the next frame
    v.run_compute()                # one-dispatch/composed moving frame
    assert v._pt.samples == 0      # history folded into per-pixel counts
    assert v._pt._count_base is not None
    v.handle_key("p")
    assert not v.pathtrace
    v.run_compute()                # whitted path still works


def test_viewer_denoised_pathtrace_preview():
    """While the accumulation is young the path-trace frame is the
    à-trous reconstruction; past denoise_until (or with 'n' toggled off)
    it is the raw accumulated mean."""
    from gpu_raytracer import build_default_scene
    from gpu_raytracer.engine.viewer import Viewer

    v = Viewer(build_default_scene(), 32, 32, shadows=False, verbose=False)
    v.handle_key("p")
    v.run_compute()
    fb_dn = v.framebuffer.copy()
    assert np.isfinite(fb_dn).all()
    assert not np.allclose(fb_dn, v._pt.image())   # filtered, not raw
    v.handle_key("n")                              # denoise off
    assert not v.denoise
    v.run_compute()
    assert np.allclose(v.framebuffer, v._pt.image())
    v.handle_key("n")                              # back on, but converged:
    v.denoise_until = 2                            # samples==2 -> raw
    v.run_compute()
    assert np.allclose(v.framebuffer, v._pt.image())


def test_load_gltf_resets_pathtracer(default_scene, tmp_path):
    """'L' while path tracing must render the NEW scene: load_gltf drops the
    stale PathTracer (the reference marks every buffer dirty on load,
    main.rs:63-72)."""
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from gltf_fixtures import cornell_box_gltf, write_gltf

    v = _viewer(default_scene, 32, 32)
    v.handle_key("p")
    v.run_compute()
    stale = v._pt
    assert stale is not None
    path = write_gltf(tmp_path / "box.gltf", cornell_box_gltf())
    v.load_gltf(path)
    assert v._pt is None or v._pt is not stale
    v.run_compute()                       # path tracing still on: new scene
    assert v.pathtrace and v._pt is not stale
    assert v._pt.scene is v.scene


def test_update_geometry_resets_pathtracer(default_scene):
    """Refit while 'p' is active must path-trace the moved geometry."""
    v = _viewer(default_scene, 32, 32)
    v.handle_key("p")
    v.run_compute()
    assert v._pt.samples == 1
    base = np.asarray(default_scene.mesh.vertices)
    v.update_geometry(base + np.float32([0.0, 0.25, 0.0]))
    assert v._pt.samples == 0             # accumulation restarted
    assert v._pt.scene is v.scene         # new geometry, not stale
    v.run_compute()
    assert np.isfinite(v.framebuffer).all()


def test_viewer_resize(default_scene):
    """In-session resolution change (main.rs:246-250, renderer.rs:477-495):
    the next frame renders at the new size."""
    v = _viewer(default_scene, 64, 48)
    v.render_to_completion()
    assert v.framebuffer.shape == (48, 64, 3)
    v.resize(40, 24)
    assert not v.progressive.complete     # full re-render triggered
    v.render_to_completion()
    fb = v.framebuffer
    assert fb.shape == (24, 40, 3)
    assert np.isfinite(fb).all() and fb.max() > 0.0
    # resize while path tracing keeps the mode at the new resolution
    v.handle_key("p")
    v.run_compute()
    v.resize(32, 32)
    v.run_compute()
    assert v.framebuffer.shape == (32, 32, 3)


def test_many_light_viewer_temporal_refinement():
    """A stationary many-light (64 > 16) Viewer shows the exact per-light
    sum from its first frame: the main path loops over every light, so
    there is no sampled-light noise to refine. Idle frames leave the frame
    alone; a camera move redraws."""
    import jax.numpy as jnp
    from gpu_raytracer.engine.renderer import render_chunk
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(1500, seed=3, lights=64)
    assert scene.lights.count > 16
    W, H = 64, 32
    v = Viewer(scene, W, H, verbose=False)
    assert v.run_compute() == 1      # one 128px tile covers the frame
    fb1 = v.framebuffer.copy()

    px, py, _ = v.renderer._pixel_order()
    ref = v.renderer._to_image(np.asarray(render_chunk(
        scene, jnp.asarray(px), jnp.asarray(py), W, H, shadows=False,
        use_bvh=True, leaf_size=8)))
    np.testing.assert_allclose(fb1, ref, atol=1e-6)

    for _ in range(3):
        assert v.run_compute() == 0  # idle frames neither redraw nor drift
    np.testing.assert_array_equal(v.framebuffer, fb1)
    # a camera move redraws the whole frame
    v.handle_key("w")
    assert v.run_compute() == 1
    assert np.abs(v.framebuffer - fb1).max() > 0.0


def test_framebuffer_u8_matches_quantised_f32(default_scene):
    """framebuffer_u8 must equal the host-quantised f32 framebuffer in BOTH
    modes: device-quantised path-trace frames (the 4x-smaller readback) and
    host-quantised whitted frames. The display quantise is sRGB-encoded
    (utils/image.py header); device and host encodes may round a value
    sitting exactly on a u8 boundary differently (XLA vs numpy power), so
    allow <=1 count."""
    from gpu_raytracer.utils.image import to_u8

    v = Viewer(default_scene, 32, 32, shadows=False, verbose=False)
    v.run_compute()                                   # whitted frame
    want = to_u8(v.framebuffer)
    got = v.framebuffer_u8
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)

    v.handle_key("p")                                 # path-trace frame
    v.run_compute()
    got = v.framebuffer_u8                            # device-side quantise
    want = to_u8(v.framebuffer)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_pathtrace_fly_through_keeps_history(default_scene):
    """fly_through in path-trace mode: every scripted camera move warps the
    accumulation (temporal default) instead of restarting it, and frames
    come out finite through the denoised-preview present path."""
    v = _viewer(default_scene, 32, 32)
    v.handle_key("p")
    for _ in range(3):
        v.frame()                       # build some history at the start
    assert v._pt.samples == 3
    frames = v.fly_through([("key", "w"), ("mouse", 15.0, 0.0)],
                           frames_per_step=1)
    assert len(frames) == 2
    for f in frames:
        assert np.isfinite(f).all()
    # the move warped history rather than zeroing it: reprojected counts
    # survive in _count_base (the interleaved moving frame keeps all
    # per-pixel bookkeeping in the vector, scalar samples stays 0)
    assert v._pt._count_base is not None
    assert float(np.asarray(v._pt._count_base).max()) > 1.0
    assert v._pt.samples == 0


def test_cli_fly_pathtrace(tmp_path, default_scene):
    from gpu_raytracer.__main__ import main

    out = str(tmp_path / "frames")
    main(["fly", "--demo", "--pathtrace", "--width", "32", "--height", "32",
          "--script", "w mouse:10,0", "-o", out])
    import os
    files = sorted(os.listdir(out))
    assert files == ["frame_0000.png", "frame_0001.png"]


def test_present_frame_pipelining_semantics(default_scene):
    """present_frame: device u8 handle for path-trace frames (no fetch),
    host u8 ndarray for whitted frames; materialised values match
    framebuffer_u8 exactly, and an old handle stays valid (immutable)
    after the viewer renders further frames."""
    import jax

    v = Viewer(default_scene, 32, 32, shadows=False, verbose=False)
    v.run_compute()                               # whitted: host path
    h0 = v.present_frame()
    assert isinstance(h0, np.ndarray) and h0.dtype == np.uint8

    v.handle_key("p")
    v.run_compute()                               # path-trace: device path
    h1 = v.present_frame()
    assert isinstance(h1, jax.Array)
    want1 = v.framebuffer_u8
    v.run_compute()                               # advance one frame
    h2 = v.present_frame()
    # the old handle still materialises to ITS frame, not the new one
    np.testing.assert_array_equal(np.asarray(h1), want1)
    assert not np.array_equal(np.asarray(h2), want1) or v._pt.samples == 1
    np.testing.assert_array_equal(np.asarray(h2), v.framebuffer_u8)
