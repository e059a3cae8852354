"""HTTP present loop (engine/server.py): the reference's windowed event
loop (src/main.rs:229-293) realised as a browser PNG stream + fetch input."""

import json
import urllib.request

import numpy as np
import pytest

from gpu_raytracer import build_default_scene
from gpu_raytracer.engine.viewer import Viewer
from gpu_raytracer.engine.server import ViewerServer


@pytest.fixture(scope="module")
def server():
    scene = build_default_scene()
    v = Viewer(scene, 64, 64, shadows=False, verbose=False)
    v.run_compute()   # compile outside any HTTP request timeout
    s = ViewerServer(v, port=0, max_fps=60)
    s.start()
    yield s
    s.stop()


def _get(server, path):
    return urllib.request.urlopen(
        f"http://{server.host}:{server.port}{path}", timeout=180)


def test_page_and_stats(server):
    assert b"/stream" in _get(server, "/").read()
    stats = json.loads(_get(server, "/stats").read())
    assert set(stats) == {"fps", "frame_ms", "camera"}
    assert len(stats["camera"]) == 3


def test_key_moves_camera(server):
    z0 = json.loads(_get(server, "/stats").read())["camera"][2]
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}/key?k=w", method="POST")
    assert json.loads(urllib.request.urlopen(req, timeout=180).read())["ok"]
    z1 = json.loads(_get(server, "/stats").read())["camera"][2]
    assert z1 < z0  # default camera looks down -Z; 'w' moves forward


def test_stream_emits_png_frames(server):
    resp = _get(server, "/stream")
    assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
    # read through the first part and check the PNG magic
    data = b""
    while data.count(b"\x89PNG\r\n\x1a\n") < 1 and len(data) < 4_000_000:
        chunk = resp.read(4096)
        if not chunk:
            break
        data += chunk
    assert b"\x89PNG\r\n\x1a\n" in data
    resp.close()


def test_resize_endpoint(server):
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}/resize?w=48&h=32", method="POST")
    assert json.loads(urllib.request.urlopen(req, timeout=180).read())["ok"]
    assert (server.viewer.width, server.viewer.height) == (48, 32)
    server.viewer.run_compute()
    assert server.viewer.framebuffer.shape == (32, 48, 3)


def test_second_stream_client_shares_one_render_loop(server):
    """Two /stream clients must NOT double-advance the viewer: both are fed
    by the single producer loop."""
    a = _get(server, "/stream")
    b = _get(server, "/stream")
    got_a = a.read(2048)
    got_b = b.read(2048)
    assert got_a and got_b
    # exactly one producer thread exists
    import threading
    assert server._producer is not None and server._producer.is_alive()
    assert server._clients == 2
    a.close()
    b.close()
