"""Live present loop over HTTP: the windowed event loop, headless.

The reference's application surface is a winit window with a swapchain
present pass and WASD/mouse input (src/main.rs:229-293,
renderer.rs:778-818, input.rs). A GPU server has no display, so this module
realises the same loop for any browser: frames stream as a
`multipart/x-mixed-replace` PNG stream (the motion-JPEG idiom; our PNG
codec is zero-dependency), and key/mouse events come back over fetch. The
render loop, camera controller, progressive scheduler and perf counters are
the SAME `engine/viewer.py::Viewer` the offline fly-through uses — the
server only adds transport.

    python -m gpu_raytracer serve --gltf scene.gltf --port 8642
    # then open http://localhost:8642/

Endpoints: `/` (interactive page), `/stream` (PNG stream), `/key?k=w`,
`/drag?dx=..&dy=..`, `/resize?w=..&h=..` (the reference's
WindowEvent::Resized), `/stats` (JSON: fps, frame ms, camera).
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>gpu-raytracer</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:0 }
#hud { padding:6px 10px } img { display:block; margin:auto;
image-rendering:pixelated; outline:none }
</style></head><body>
<div id="hud">gpu-raytracer &mdash; WASD move &middot; drag to look &middot;
P path-trace &middot; Esc quit &middot; <span id="stats"></span></div>
<img id="v" src="/stream" tabindex="0">
<script>
const send = (p) => fetch(p, {method: "POST"});
document.addEventListener("keydown", (e) => {
  const k = e.key === " " ? "space" : e.key;
  send("/key?k=" + encodeURIComponent(k));
});
let drag = null;
const img = document.getElementById("v");
img.addEventListener("mousedown", (e) => { drag = [e.clientX, e.clientY]; });
document.addEventListener("mouseup", () => { drag = null; });
document.addEventListener("mousemove", (e) => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  if (dx || dy) send(`/drag?dx=${dx}&dy=${dy}`);
});
setInterval(async () => {
  const s = await (await fetch("/stats")).json();
  document.getElementById("stats").textContent =
    `${s.fps.toFixed(1)} fps  ${s.frame_ms.toFixed(1)} ms  ` +
    `cam ${s.camera.map(v => v.toFixed(1)).join(",")}`;
}, 1000);
let rs = null;   // debounced WindowEvent::Resized -> /resize
window.addEventListener("resize", () => {
  clearTimeout(rs);
  rs = setTimeout(() => {
    const w = Math.max(64, Math.floor(window.innerWidth / 64) * 64);
    const h = Math.max(64, Math.floor((window.innerHeight - 40) / 64) * 64);
    send(`/resize?w=${w}&h=${h}`);
  }, 400);
});
</script></body></html>"""

_BOUNDARY = b"rtframe"


class ViewerServer:
    """Wraps a `Viewer` in a threaded HTTP server (stdlib only)."""

    def __init__(self, viewer, host: str = "127.0.0.1", port: int = 8642,
                 max_fps: float = 30.0):
        self.viewer = viewer
        self.max_fps = max_fps
        self._lock = threading.Lock()     # serialises viewer access
        self._frame_ms = 0.0
        self._fps = 0.0
        # Single-producer present loop: exactly one render loop advances the
        # viewer no matter how many /stream clients connect (a second client
        # must not double-advance progressive/pathtrace state); clients
        # broadcast-read the latest encoded frame.
        self._cond = threading.Condition()
        self._clients = 0
        self._seq = 0
        self._latest: bytes | None = None
        self._producer: threading.Thread | None = None
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                with server._lock:
                    if u.path == "/key":
                        server.viewer.handle_key(q.get("k", [""])[0])
                    elif u.path == "/drag":
                        server.viewer.handle_mouse_drag(
                            float(q.get("dx", ["0"])[0]),
                            float(q.get("dy", ["0"])[0]))
                    elif u.path == "/resize":
                        # WindowEvent::Resized over HTTP
                        # (src/main.rs:246-250)
                        server.viewer.resize(
                            int(q.get("w", ["0"])[0]),
                            int(q.get("h", ["0"])[0]))
                    else:
                        return self._json({"err": "unknown"}, 404)
                self._json({"ok": True})

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/stats":
                    with server._lock:
                        cam = [float(x) for x in
                               server.viewer.controller.position]
                    self._json({"fps": server._fps,
                                "frame_ms": server._frame_ms,
                                "camera": cam})
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary="
                        + _BOUNDARY.decode())
                    self.end_headers()
                    try:
                        server._stream(self.wfile)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._json({"err": "unknown"}, 404)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = None

    def _produce(self) -> None:
        """THE render loop (one per server): progressive tiles advance under
        the lock, the finished framebuffer is encoded once and broadcast to
        every connected /stream client. Parks while no client is connected."""
        min_dt = 1.0 / self.max_fps
        last = None
        pending = None      # device u8 handle of the PREVIOUS frame
        while not self.viewer.should_quit:
            with self._cond:
                if self._clients == 0:
                    last = None                 # rate window restarts
                    pending = None              # pipeline restarts too
                    self._cond.wait(timeout=0.25)
                    continue
            t0 = time.perf_counter()
            if last is not None:                # presented loop-to-loop rate
                self._fps = 1.0 / max(t0 - last, 1e-6)
            last = t0
            with self._lock:
                self.viewer.run_compute()
                self.viewer.perf.update_frame_count()
                # device YUV 4:2:0 handle — encode dispatched, NOT fetched
                # (half the readback bytes of the RGB u8 handle)
                nxt = self.viewer.present_frame_packed()
            # one-frame pipelined present: materialise the PREVIOUS
            # frame's handle while this one computes on device (the
            # swapchain analogue; host-path handles are already ndarrays
            # and fetch as a no-op). The first loop after a connect has
            # nothing older to show — it presents its own frame.
            frame = self.viewer.materialize_frame(
                pending if pending is not None else nxt)
            pending = nxt
            png = encode_png(frame, level=1)    # speed over size
            dt = time.perf_counter() - t0
            self._frame_ms = dt * 1e3
            with self._cond:
                self._seq += 1
                self._latest = png
                self._cond.notify_all()
            if dt < min_dt:
                time.sleep(min_dt - dt)
        with self._cond:                        # release waiting clients
            self._cond.notify_all()

    def _stream(self, wfile) -> None:
        """Present loop for one /stream client: waits for frames from the
        single producer and writes each as a PNG part (the swapchain-present
        analogue). Any number of clients share one render loop."""
        with self._cond:
            self._clients += 1
            if self._producer is None or not self._producer.is_alive():
                self._producer = threading.Thread(target=self._produce,
                                                  daemon=True)
                self._producer.start()
            self._cond.notify_all()
        seen = -1
        try:
            while not self.viewer.should_quit:
                with self._cond:
                    self._cond.wait_for(
                        lambda: self._seq != seen or self.viewer.should_quit,
                        timeout=1.0)
                    if self._seq == seen:
                        continue
                    seen, png = self._seq, self._latest
                if png is None:
                    continue
                wfile.write(b"--" + _BOUNDARY + b"\r\n"
                            b"Content-Type: image/png\r\n"
                            b"Content-Length: " + str(len(png)).encode()
                            + b"\r\n\r\n" + png + b"\r\n")
                wfile.flush()
        finally:
            with self._cond:
                self._clients -= 1

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.viewer.should_quit = True
        self._httpd.shutdown()
        self._httpd.server_close()

    def serve_forever(self) -> None:
        print(f"serving http://{self.host}:{self.port}/  (Esc in page quits)")
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
