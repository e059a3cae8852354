"""Interactive application shell (headless).

The equivalent of the reference's winit app (src/main.rs):
a `Viewer` owns the scene, camera controller, progressive tile scheduler and
perf counters, and exposes the same interaction surface — WASD movement,
mouse-drag look, Space to re-render, L to load a glTF scene with
fall-back-to-current-scene error handling (main.rs:150-219) — driven
programmatically (or from a terminal loop) instead of a window event loop.
Every frame: run_compute (progressive tiles into the persistent framebuffer)
then "present" (the framebuffer is available as an array / PNG), mirroring
the redraw path (main.rs:278-286).
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.camera import CameraController
from ..models.scene import Scene
from .perf import PerformanceState, ProgressiveTiming, Timer
from .progressive import ProgressiveState
from .renderer import Renderer


class Viewer:
    def __init__(self, scene: Scene, width: int = 1280, height: int = 720,
                 config: RaytracerConfig = DEFAULT_CONFIG,
                 shadows: bool = False, verbose: bool = True,
                 sync_timing: bool = False):
        self.config = config
        self.width = width
        self.height = height
        self.shadows = shadows
        self.verbose = verbose
        # sync_timing=True fences the device after every whole-frame compute
        # so per-tile timings measure true execution. Off by default:
        # unfenced, frames pipeline and timings measure submission, exactly
        # like the reference (src/compute.rs:77 acknowledges
        # the same).
        self.sync_timing = sync_timing
        self.scene = scene
        self.renderer = Renderer(scene, width, height, config=config,
                                 shadows=shadows)
        self.controller = CameraController(scene.camera, config)
        self.progressive = ProgressiveState(width, height, config)
        self.perf = PerformanceState(config.performance_stats_interval, verbose)
        self.timing = ProgressiveTiming()
        # The frame lives on DEVICE in whole-frame mode (the reference's
        # present path also never leaves the GPU — the fragment shader
        # samples the storage textures, src/renderer.rs:778-818); the host
        # copy materialises lazily through the `framebuffer` property.
        self._fb_host = np.zeros((height, width, 3), np.float32)
        self._fb_dev = None
        self._fb_host_dirty = False
        self._fb_rowmajor = False   # True: _fb_dev is a row-major pt frame
        self.should_quit = False
        # Interactive progressive path tracing ('p' key): one spp per frame
        # accumulated by engine/pathtracer.py; camera moves restart it.
        self.pathtrace = False
        self._pt = None
        # Denoised path-trace preview ('n' key): while the accumulation is
        # young (< denoise_until spp) present the edge-avoiding à-trous
        # reconstruction (ops/denoise.py) instead of the raw mean, then
        # hand off to the converged accumulation — the first seconds after
        # every camera move stay smooth instead of speckled.
        self.denoise = True
        self.denoise_until = 32
        # Temporal reprojection ('t' key): camera moves WARP the path-trace
        # accumulation into the new view (depth-validated, history clamped
        # to temporal_clamp spp — engine/pathtracer._warp_history) instead
        # of restarting it, so the fly-through keeps its convergence.
        self.temporal = True
        # Fly-through interleave ('i' key cycles 1/2/4/8): a MOVING
        # path-trace frame samples only every m-th pixel (rotating coset,
        # PathTracer.step_interleaved) — the warp carries history into all
        # pixels and the à-trous pass reconstructs, so the wavefront cost
        # drops ~m-fold while geometry edges stay full-res. Static frames
        # always take full steps (convergence quality is untouched).
        self.fly_interleave = 4
        self._pt_moved = False
        # moving frames reconstruct with one fewer à-trous iteration than
        # the converging preview (4): the temporal history keeps noise low
        # and the widest-radius pass is the least visible in motion
        self.fly_denoise_iters = 3
        # Tile pixel template in 64x64-subtile order: rays of a 128x128
        # progressive tile stay coherent within each 64x64 subtile.
        from ..ops.packet_trace import tiled_pixel_order

        ts = config.tile_size
        self._tile_gx, self._tile_gy = tiled_pixel_order(ts, ts, tile=64)
        self._tile_coords = {}   # tile index -> (px_host, py_host, px_dev, py_dev)
        self._sync_mode()

    def _sync_mode(self) -> None:
        """Pick the progressive granularity for the current scene.

        The reference's adaptive tiles-per-frame schedule
        (shared/src/lib.rs:1195-1203) exists to bound per-frame latency on a
        GPU where a full frame takes many frame budgets. With the traversal
        kernel (device.py) a whole 1080p frame takes a few milliseconds, so
        the whole frame becomes ONE progressive tile ("render everything
        while ≤16 tiles remain" — the schedule's own fast-scene limit); the
        XLA traversal keeps the 128px cadence because there a full frame
        genuinely spans many frames.
        """
        from ..device import traversal

        self._whole_frame = traversal() == "kernel"
        self.progressive.resize(self.width, self.height)
        if self._whole_frame:
            self.progressive.tiles_x = self.progressive.tiles_y = 1
            self.progressive.total_tiles = 1
            self.progressive.tiles_per_frame = 1
            self.progressive.current_tile = 0

    # ---- interaction surface (main.rs:150-197, input.rs) ----

    def handle_key(self, key: str) -> None:
        key = key.lower()
        if key == "w":
            self.controller.move(forward=1.0)
        elif key == "s":
            self.controller.move(forward=-1.0)
        elif key == "a":
            self.controller.move(strafe=-1.0)
        elif key == "d":
            self.controller.move(strafe=1.0)
        elif key == " " or key == "space":
            pass  # fallthrough to recompute below
        elif key == "p":
            # Toggle progressive path tracing (an extension: the reference's
            # wavefront renderer was dead code, compute.rs:365-553 — here
            # it's the same engine behind one key).
            self.pathtrace = not self.pathtrace
            if self.pathtrace:
                self._ensure_pathtracer()
            return
        elif key == "n":
            self.denoise = not self.denoise
            return
        elif key == "t":
            self.temporal = not self.temporal
            return
        elif key == "i":
            # cycle the moving-frame interleave factor (1 = full steps)
            self.fly_interleave = {1: 2, 2: 4, 4: 8, 8: 1}.get(
                self.fly_interleave, 4)
            return
        elif key == "l":
            self.load_gltf("model.gltf")
            return
        elif key == "escape":
            self.should_quit = True
            return
        else:
            return
        self._apply_camera()

    def handle_mouse_drag(self, dx: float, dy: float) -> None:
        self.controller.rotate(dx, dy)
        self._apply_camera()

    def _apply_camera(self) -> None:
        self.scene = self.scene.with_camera(self.controller.camera())
        self.renderer.scene = self.scene
        if self._pt is not None:
            if self.temporal and self._pt._total_samples() > 0:
                # defer the warp: run_compute dispatches the whole moving
                # frame (warp + interleaved step + denoise) as ONE fused
                # program (PathTracer.fly_frame) — the camera recorded
                # here is the warp target
                self._pt_moved = True
            else:
                # restart accumulation (the reference's trigger_recompute)
                self._pt.set_camera(self.scene.camera,
                                    temporal=self.temporal)
        self.progressive.trigger_recompute()
        self.timing = ProgressiveTiming()

    def _ensure_pathtracer(self):
        if self._pt is None:
            from .pathtracer import PathTracer

            self._pt = PathTracer(self.scene, self.width, self.height,
                                  config=self.config, shadows=self.shadows)

    def load_gltf(self, path: str) -> None:
        """ContentManager::load_gltf semantics (main.rs:63-72): replace the
        scene, keep the current one on failure, full re-render either way."""
        from ..models.gltf import scene_from_gltf

        try:
            new_scene = scene_from_gltf(path, config=self.config)
        except Exception as e:  # reference formats and continues (main.rs:203-219)
            if self.verbose:
                print(f"Failed to load glTF scene '{path}': {e}")
            return
        self.scene = new_scene
        self.renderer = Renderer(new_scene, self.width, self.height,
                                 config=self.config, shadows=self.shadows)
        self.controller = CameraController(new_scene.camera, self.config)
        # Drop the path tracer with the OLD scene — 'L' while path tracing
        # must render the new one (it is re-created lazily on the next
        # pathtrace frame; the reference marks all five buffers dirty here,
        # main.rs:65-69).
        self._pt = None
        self._sync_mode()
        self.progressive.trigger_recompute()
        self.timing = ProgressiveTiming()

    def update_geometry(self, vertices) -> None:
        """Animated-geometry mode (BASELINE config 5): move the mesh's
        vertices and rebuild the BVH ON DEVICE (models.scene.refit_scene —
        one jitted LBVH pipeline, no host round-trip), then re-render. The
        reference rebuilds host-side on every scene change
        (src/scene.rs:107-109)."""
        from ..models.scene import refit_scene

        self.scene = refit_scene(self.scene, jnp.asarray(vertices))
        self.renderer.scene = self.scene
        if self._pt is not None:
            # moving geometry invalidates the accumulation AND the path
            # tracer's scene (refit while 'p' is active must not render the
            # stale geometry)
            self._pt.scene = self.scene
            self._pt.reset()
        self.progressive.trigger_recompute()

    def resize(self, width: int, height: int) -> None:
        """In-session resolution change — the reference's
        `WindowEvent::Resized`/`ScaleFactorChanged` path
        (src/main.rs:246-250, renderer.rs:477-495): rebuild
        the render surface (renderer + coordinate caches), the progressive
        grid and the framebuffer at the new size, then trigger a full
        re-render. The camera and scene are untouched."""
        if (width, height) == (self.width, self.height) or width < 1 \
                or height < 1:
            return
        self.width = width
        self.height = height
        self.renderer = Renderer(self.scene, width, height,
                                 config=self.config, shadows=self.shadows)
        self._fb_host = np.zeros((height, width, 3), np.float32)
        self._fb_dev = None
        self._tile_coords = {}
        if self._pt is not None:     # accumulation shape is per-resolution
            self._pt = None
            if self.pathtrace:
                self._ensure_pathtracer()
        self._sync_mode()            # rebuilds the progressive grid too
        self.progressive.trigger_recompute()
        self.timing = ProgressiveTiming()

    # ---- frame loop (run_compute + render, main.rs:136-144, 278-286) ----

    def _coords(self, tile: int):
        """Per-tile pixel coordinates, device arrays uploaded once per
        resolution (they only depend on the tile grid, not the scene)."""
        got = self._tile_coords.get(tile)
        if got is None:
            x0, y0, _, _ = self.progressive.tile_rect(tile, self.width,
                                                      self.height)
            # full-tile launch with edge clamping (is_pixel_in_bounds,
            # shader/src/lib.rs:152-163: OOB lanes compute but don't land —
            # here they recompute the clamped edge pixel, so the host
            # scatter below writes each real pixel with its own value)
            px = np.minimum(x0 + self._tile_gx, self.width - 1)
            py = np.minimum(y0 + self._tile_gy, self.height - 1)
            got = (px, py, jnp.asarray(px), jnp.asarray(py))
            self._tile_coords[tile] = got
        return got

    def run_compute(self) -> int:
        """Render this frame's share of tiles into the framebuffer.
        Returns the number of tiles rendered (0 once complete — idle frames,
        compute.rs:85-100).

        All of this frame's tile dispatches are issued back-to-back and
        synced ONCE (the reference likewise submits one command buffer for
        the whole frame, src/compute.rs:137-166); each dispatch goes through
        Renderer.render_rays, the same pipeline as the headline benchmark.
        """
        if self.pathtrace:
            self._ensure_pathtracer()
            moving = self._pt_moved and self.temporal
            self._pt_moved = False
            if moving and self.denoise:
                # ONE fused dispatch: warp to the recorded camera +
                # interleaved 1/m step + denoise (PathTracer.fly_frame)
                with Timer() as timer:
                    self._fb_dev = self._pt.fly_frame(
                        self.scene.camera, m=self.fly_interleave,
                        iterations=self.fly_denoise_iters)
                self.timing.record_tile(timer.ms)
            elif moving:
                # denoiser toggled off: composed path, raw mean present
                with Timer() as timer:
                    self._pt.set_camera(self.scene.camera, temporal=True)
                    if self.fly_interleave > 1:
                        self._pt.step_interleaved(self.fly_interleave)
                    else:
                        self._pt.step()
                self.timing.record_tile(timer.ms)
                self._fb_dev = self._pt.image_device()
            else:
                with Timer() as timer:
                    self._pt.step()
                self.timing.record_tile(timer.ms)
                # present stays ON DEVICE (row-major [H,W,3] f32) — the
                # host copy materialises lazily through `framebuffer` /
                # `framebuffer_u8`, so step+denoise dispatch
                # asynchronously and presenters that want u8 fetch a
                # quarter of the bytes
                if self.denoise and self._pt.samples < self.denoise_until:
                    self._fb_dev = self._pt.denoised_frame()
                else:
                    self._fb_dev = self._pt.image_device()
            self._fb_rowmajor = True
            self._fb_host_dirty = True
            return 1
        tiles = self.progressive.next_tiles()
        if self._whole_frame:
            if tiles:
                with Timer() as timer:
                    self._fb_dev = self.renderer.render_device()
                    if self.sync_timing:
                        jax.block_until_ready(self._fb_dev)
                self._fb_rowmajor = False
                self._fb_host_dirty = True
                self.timing.record_tile(timer.ms)
                if self.progressive.complete and self.verbose:
                    self.timing.print_summary()
            return len(tiles)
        results = []
        with Timer() as timer:
            for t in tiles:
                px, py, dpx, dpy = self._coords(t)
                results.append((px, py, self.renderer.render_rays(dpx, dpy)))
            if results:
                jax.block_until_ready(results[-1][2])
        for px, py, rgb in results:
            self._fb_host[py, px] = np.asarray(rgb)
        self._fb_dev = None
        if tiles:
            per_tile = timer.ms / len(tiles)
            for _ in tiles:
                self.timing.record_tile(per_tile)
        if tiles and self.progressive.complete and self.verbose:
            self.timing.print_summary()
        return len(tiles)

    @property
    def framebuffer(self) -> np.ndarray:
        """Host [H,W,3] f32 frame — the display readback (one device→host
        copy, like the reference's swapchain present being a separate pass
        from compute). Cached until the next whole-frame compute."""
        if self._fb_dev is not None and self._fb_host_dirty:
            if getattr(self, "_fb_rowmajor", False):
                # path-trace frames are already row-major [H,W,3]
                fb = np.asarray(self._fb_dev)
                # keep _fb_host writable (the whitted tile path mutates it
                # in place after a 'p' toggle back)
                self._fb_host = fb if fb.flags.writeable else fb.copy()
            else:
                self._fb_host = self.renderer._to_image(
                    np.asarray(self._fb_dev))
            self._fb_host_dirty = False
        return self._fb_host

    @property
    def framebuffer_u8(self) -> np.ndarray:
        """Display-ready [H,W,3] u8 frame. For device-resident path-trace
        frames the clip+quantise runs ON DEVICE and the readback is u8 —
        a quarter of the f32 bytes (the same trick as Renderer.render_u8);
        otherwise it quantises the f32 host frame
        (bit-identical either way)."""
        return np.asarray(self.present_frame())

    def present_frame(self):
        """The current frame's display-ready [H,W,3] u8 image WITHOUT
        forcing a device→host fetch: device-resident path-trace frames
        return the device u8 array (quantise dispatched, not read back),
        everything else returns a host ndarray. Presenters that pipeline
        (server/window) hold this handle and materialise it with
        np.asarray one frame later, so the readback of frame N-1 overlaps
        frame N's device compute — the swapchain-present analogue (XLA
        arrays are immutable; the handle stays valid across later frames).
        """
        if (self._fb_dev is not None and self._fb_host_dirty
                and getattr(self, "_fb_rowmajor", False)):
            from .pathtracer import _to_u8
            return _to_u8(self._fb_dev)
        from ..utils.image import to_u8
        return to_u8(self.framebuffer)

    def present_frame_packed(self):
        """present_frame at HALF the readback bytes: device-resident frames
        come back as a device YUV 4:2:0 u8 handle ([H*3/2, W] — see
        utils/yuv.py; materialize_frame() unpacks), 1.5 bytes/px vs RGB's
        3 — the remote-present answer every video pipeline uses.
        Non-device frames fall back to the RGB u8 host array."""
        if (self._fb_dev is not None and self._fb_host_dirty
                and getattr(self, "_fb_rowmajor", False)
                and self._fb_dev.ndim == 3
                and self._fb_dev.dtype != np.uint8
                and self.height % 2 == 0 and self.width % 2 == 0):
            from ..utils.yuv import encode_yuv420
            h = encode_yuv420(self._fb_dev)
            try:
                # start the device->host transfer NOW: it proceeds as
                # soon as the frame completes, overlapping the next
                # frame's compute, so materialize_frame one frame later
                # pays only the host-side unpack
                h.copy_to_host_async()
            except Exception:
                pass
            return h
        return self.present_frame()

    @staticmethod
    def materialize_frame(handle) -> np.ndarray:
        """Fetch + unpack a present_frame / present_frame_packed handle to
        display RGB u8 [H,W,3]."""
        arr = np.asarray(handle)
        if arr.ndim == 2:                 # packed YUV 4:2:0
            from ..utils.yuv import decode_yuv420
            return decode_yuv420(arr)
        return arr

    def frame(self) -> np.ndarray:
        """One event-loop turn: compute + present (device-resident)."""
        self.run_compute()
        self.perf.update_frame_count()
        return self.framebuffer

    def render_to_completion(self, max_frames: int = 100000) -> np.ndarray:
        """Compute every remaining tile (presenting only once at the end —
        intermediate frames stay on device)."""
        while not self.progressive.complete and max_frames > 0:
            self.run_compute()
            self.perf.update_frame_count()
            max_frames -= 1
        return self.framebuffer

    def fly_through(self, script: list[tuple], frames_per_step: int = 1) -> list[np.ndarray]:
        """Scripted interactive session: script entries are ('key', k) or
        ('mouse', dx, dy). Returns the framebuffer after each step."""
        out = []
        for action in script:
            if action[0] == "key":
                self.handle_key(action[1])
            elif action[0] == "mouse":
                self.handle_mouse_drag(action[1], action[2])
            for _ in range(frames_per_step):
                self.frame()
            out.append(self.framebuffer.copy())
            if self.should_quit:
                break
        return out
