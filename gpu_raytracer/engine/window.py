"""Native OS-window present path.

The reference presents through a winit window + Vulkan swapchain with a
continuous redraw loop — every `RedrawRequested` runs compute then a render
pass, and `MainEventsCleared` immediately requests the next redraw
(src/main.rs:229-293); keys WASD/Space/L and left-button
mouse drags mutate the camera (main.rs:150-197). On headless GPU hosts this
framework's interactive surface is the HTTP live viewer (engine/server.py).
When the host DOES have a display, `NativeWindow` wraps the SAME `Viewer`
(so every input/progressive/path-trace semantic is shared) in a stdlib
Tk window:

  * present = one `Viewer.run_compute()` + a PPM-encoded `PhotoImage`
    swap per event-loop turn, re-armed with `after(0)` — the continuous
    redraw loop of main.rs:285-287 (`MainEventsCleared → request_redraw`);
  * `<KeyPress>` routes keysyms to `Viewer.handle_key` (WASD/Space/P/L,
    Escape quits — main.rs:150-186);
  * left-drag deltas go to `Viewer.handle_mouse_drag` (input.rs:28-47);
  * window `<Configure>` size changes call `Viewer.resize` (the
    reference's `WindowEvent::Resized`, main.rs:254-257).

The Tk handle is injectable so the window logic is fully testable on
headless CI (tests/test_window.py drives a fake Tk); `window_available()`
gates the CLI cleanly when there is no display server.
"""

from __future__ import annotations

import time

import numpy as np


def window_available(tk=None) -> bool:
    """True when a display server is reachable (a Tk root can be created)."""
    try:
        if tk is None:
            import tkinter as tk  # noqa: F811
        root = tk.Tk()
        root.destroy()
        return True
    except Exception:
        return False


def _ppm_bytes(fb: np.ndarray) -> bytes:
    """[H,W,3] frame (f32 0..1, or already-quantised u8) → binary PPM (P6)
    — the one raster format Tk's stdlib PhotoImage ingests without PIL.
    Quantisation matches the device u8 present path
    (engine/renderer.py::render_u8)."""
    if fb.dtype == np.uint8:
        u8 = fb
    else:
        from ..utils.image import to_u8
        u8 = to_u8(fb)          # sRGB display encode (utils/image.py)
    h, w = u8.shape[:2]
    return b"P6 %d %d 255\n" % (w, h) + u8.tobytes()


class NativeWindow:
    """OS-window shell around a `Viewer` (reference `State` + winit loop).

    Parameters
    ----------
    viewer : engine.viewer.Viewer
        Drives compute, camera, progressive state; shared with serve/CLI.
    tk : module, optional
        tkinter-compatible module (injected by tests; defaults to stdlib
        tkinter).
    max_fps : float
        Present-rate cap; the compute itself is asynchronous (dispatch
        cadence), mirroring the reference's uncapped redraw loop but
        keeping a Python UI thread responsive.
    """

    def __init__(self, viewer, tk=None, title: str = "gpu_raytracer",
                 max_fps: float = 120.0):
        if tk is None:
            import tkinter as tk  # noqa: F811
        self._tk = tk
        self.viewer = viewer
        self.closed = False
        self._min_dt = 1.0 / max_fps if max_fps > 0 else 0.0
        self._last_present = 0.0
        self._drag_last = None
        self._photo = None  # keep a ref: Tk drops images that get GC'd
        self._pending = None  # previous tick's device u8 present handle

        self.root = tk.Tk()
        self.root.title(title)
        self.label = tk.Label(self.root)
        self.label.pack(fill="both", expand=True)
        self.root.geometry(f"{viewer.width}x{viewer.height}")
        self.root.bind("<KeyPress>", self._on_key)
        self.root.bind("<ButtonPress-1>", self._on_press)
        self.root.bind("<B1-Motion>", self._on_drag)
        self.root.bind("<ButtonRelease-1>", self._on_release)
        self.root.bind("<Configure>", self._on_configure)
        self.root.protocol("WM_DELETE_WINDOW", self.close)

    # ---- input routing (main.rs:150-197 semantics) ----

    def _on_key(self, event) -> None:
        key = getattr(event, "keysym", "") or ""
        if key:
            self.viewer.handle_key(key)       # WASD/Space/P/L + Escape
        if getattr(self.viewer, "should_quit", False):
            self.close()                      # main.rs:160-168

    def _on_press(self, event) -> None:
        self._drag_last = (event.x, event.y)

    def _on_drag(self, event) -> None:
        if self._drag_last is None:           # motion without press
            self._drag_last = (event.x, event.y)
            return
        dx = event.x - self._drag_last[0]
        dy = event.y - self._drag_last[1]
        self._drag_last = (event.x, event.y)
        if dx or dy:
            self.viewer.handle_mouse_drag(float(dx), float(dy))

    def _on_release(self, event) -> None:
        self._drag_last = None

    def _on_configure(self, event) -> None:
        # Resize only on REAL size changes of the toplevel (Configure also
        # fires for child widgets and moves).
        if getattr(event, "widget", self.root) is not self.root:
            return
        w, h = int(getattr(event, "width", 0)), int(getattr(event, "height", 0))
        if w >= 16 and h >= 16 and (w, h) != (self.viewer.width,
                                              self.viewer.height):
            self.viewer.resize(w, h)

    # ---- present loop (main.rs:278-287) ----

    def tick(self) -> None:
        """One event-loop turn: compute + present (+ re-arm)."""
        if self.closed:
            return
        if getattr(self.viewer, "should_quit", False):
            self.close()
            return
        self.viewer.run_compute()
        self.viewer.perf.update_frame_count()
        now = time.perf_counter()
        if now - self._last_present >= self._min_dt:
            self._present()
            self._last_present = now
        if not self.closed:
            self.root.after(1, self.tick)     # MainEventsCleared → redraw

    def _present(self) -> None:
        # u8 present: device-quantised for path-trace frames (a quarter of
        # the f32 readback bytes), host-quantised otherwise — pipelined one
        # frame deep: materialise the PREVIOUS tick's device handle while
        # this tick's frame computes (Viewer.present_frame)
        nxt = self.viewer.present_frame_packed()   # YUV 4:2:0 device handle
        fb = self.viewer.materialize_frame(
            self._pending if self._pending is not None else nxt)
        self._pending = nxt
        self._photo = self._tk.PhotoImage(data=_ppm_bytes(fb))
        self.label.configure(image=self._photo)

    def run(self) -> None:
        """Blocking event loop (the reference's `event_loop.run`)."""
        self.root.after(0, self.tick)
        self.root.mainloop()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.root.destroy()
        except Exception:
            pass
