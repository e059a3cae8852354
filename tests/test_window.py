"""Native OS-window shell (engine/window.py) — driven through a fake Tk.

The window logic (event routing, present encoding, resize, close) is
display-independent; these tests inject a tkinter-compatible fake so the
full loop runs on headless CI, the same way test_server.py exercises the
HTTP shell without a browser.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from gpu_raytracer import RaytracerConfig
from gpu_raytracer.engine.viewer import Viewer
from gpu_raytracer.engine.window import (NativeWindow, _ppm_bytes,
                                             window_available)


class FakeWidget:
    def __init__(self, *a, **kw):
        self.config_calls = []

    def pack(self, **kw):
        pass

    def configure(self, **kw):
        self.config_calls.append(kw)


class FakeRoot(FakeWidget):
    def __init__(self, *a, **kw):
        super().__init__()
        self.bindings = {}
        self.after_queue = []
        self.destroyed = False
        self._title = None

    def title(self, t):
        self._title = t

    def geometry(self, g):
        self._geometry = g

    def bind(self, seq, fn):
        self.bindings[seq] = fn

    def protocol(self, name, fn):
        self.bindings[name] = fn

    def after(self, ms, fn):
        self.after_queue.append(fn)

    def mainloop(self):
        # run queued callbacks until the queue drains or the window dies
        for _ in range(1000):
            if self.destroyed or not self.after_queue:
                return
            self.after_queue.pop(0)()

    def destroy(self):
        self.destroyed = True
        self.after_queue.clear()


class FakePhoto:
    last_data = None

    def __init__(self, data=None):
        FakePhoto.last_data = data
        self.data = data


class FakeTk:
    """Module-shaped namespace matching the tkinter surface window.py uses."""
    Tk = FakeRoot
    Label = FakeWidget
    PhotoImage = FakePhoto


def _window(scene, w=64, h=48, **kw):
    v = Viewer(scene, w, h, config=RaytracerConfig(tile_size=32),
               verbose=False)
    return NativeWindow(v, tk=FakeTk, max_fps=0.0, **kw), v


def test_ppm_encoding_round_trip():
    fb = np.zeros((2, 3, 3), np.float32)
    fb[0, 0] = [1.0, 0.5, 0.0]
    data = _ppm_bytes(fb)
    assert data.startswith(b"P6 3 2 255\n")
    pix = np.frombuffer(data.split(b"\n", 1)[1], np.uint8).reshape(2, 3, 3)
    # sRGB display encode (utils/image.py): 0.5 -> 188, extremes fixed
    assert tuple(pix[0, 0]) == (255, 188, 0)
    assert pix[1].sum() == 0


def test_tick_presents_frames(default_scene):
    win, v = _window(default_scene)
    win.tick()
    assert v.perf.frame_count == 1
    assert FakePhoto.last_data is not None
    assert FakePhoto.last_data.startswith(b"P6 64 48 255\n")
    assert win.label.config_calls                 # image swapped in
    assert win.root.after_queue                   # loop re-armed


def test_run_drains_to_completion_and_escape_quits(default_scene):
    win, v = _window(default_scene)
    # a keypress event routes through Viewer.handle_key
    z0 = float(v.controller.position[2])
    win.root.bindings["<KeyPress>"](SimpleNamespace(keysym="w"))
    assert float(v.controller.position[2]) != z0
    win.tick()
    # escape sets Viewer.should_quit AND closes the window (main.rs:160-168)
    win.root.bindings["<KeyPress>"](SimpleNamespace(keysym="Escape"))
    assert v.should_quit and win.closed and win.root.destroyed
    win.tick()                                    # no-op after close
    assert not win.root.after_queue


def test_mouse_drag_routes_deltas(default_scene):
    win, v = _window(default_scene)
    d0 = v.controller.direction.copy()
    win.root.bindings["<ButtonPress-1>"](SimpleNamespace(x=10, y=10))
    win.root.bindings["<B1-Motion>"](SimpleNamespace(x=60, y=20))
    assert not np.allclose(d0, v.controller.direction)
    win.root.bindings["<ButtonRelease-1>"](SimpleNamespace(x=60, y=20))
    assert win._drag_last is None


def test_configure_resizes_viewer(default_scene):
    win, v = _window(default_scene)
    ev = SimpleNamespace(widget=win.root, width=96, height=64)
    win.root.bindings["<Configure>"](ev)
    assert (v.width, v.height) == (96, 64)
    # child-widget Configure events are ignored
    ev2 = SimpleNamespace(widget=win.label, width=5, height=5)
    win.root.bindings["<Configure>"](ev2)
    assert (v.width, v.height) == (96, 64)
    win.tick()
    assert FakePhoto.last_data.startswith(b"P6 96 64 255\n")


def test_wm_delete_closes(default_scene):
    win, v = _window(default_scene)
    win.root.bindings["WM_DELETE_WINDOW"]()
    assert win.closed and win.root.destroyed


def test_run_mainloop_with_quit(default_scene):
    win, v = _window(default_scene)
    # after a few frames, inject escape via the queue so mainloop exits
    frames = []

    def poke():
        frames.append(v.perf.frame_count)
        if len(frames) >= 3:
            win.root.bindings["<KeyPress>"](SimpleNamespace(keysym="Escape"))
        else:
            win.root.after(0, poke)

    win.root.after(0, poke)
    win.run()
    assert win.closed and v.perf.frame_count >= 1


def test_window_available_fake_and_failing():
    assert window_available(tk=FakeTk)

    class Dead:
        def Tk(self):
            raise RuntimeError("no display")

    assert not window_available(tk=Dead())
