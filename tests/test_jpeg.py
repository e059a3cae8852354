"""Baseline JPEG decoder tests: PIL is used as the ENCODER + decode oracle
only (the loader itself must stay self-contained — utils/jpeg.py)."""

import io

import numpy as np
import pytest

from gpu_raytracer.utils.jpeg import JpegError, decode_jpeg

PIL = pytest.importorskip("PIL.Image")


def _smooth(w, h, seed=0):
    """Low-frequency test image (JPEG-friendly so tolerances stay tight)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 127 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    g = 127 + 100 * np.cos(xx / 29.0 + 1.0)
    b = 127 + 100 * np.sin((xx + yy) / 31.0)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _encode(img, **kw):
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _oracle(data):
    return np.asarray(PIL.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("subsampling,name", [(0, "4:4:4"), (1, "4:2:2"),
                                              (2, "4:2:0")])
def test_decode_matches_oracle(subsampling, name):
    img = _smooth(130, 94)    # non-multiple-of-MCU on purpose
    data = _encode(img, quality=92, subsampling=subsampling)
    got = decode_jpeg(data)
    assert got.shape == (94, 130, 4)
    assert (got[..., 3] == 255).all()
    ref = _oracle(data)
    # same bitstream, two IDCT/upsample implementations: allow small drift
    diff = np.abs(got[..., :3].astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() < 2.0, f"{name}: mean {diff.mean()}"
    assert np.percentile(diff, 99) <= 12


def test_decode_grayscale():
    img = _smooth(64, 48)[..., 0]
    data = _encode(img, quality=95)
    got = decode_jpeg(data)
    ref = _oracle(data)
    diff = np.abs(got[..., :3].astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() < 2.0


def test_decode_restart_markers():
    cv2 = pytest.importorskip("cv2")
    img = _smooth(128, 96)
    ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 90,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    assert ok
    data = enc.tobytes()
    assert b"\xff\xdd" in data  # DRI segment actually present
    got = decode_jpeg(data)
    ref = _oracle(data)
    diff = np.abs(got[..., :3].astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() < 2.0


@pytest.mark.parametrize("subsampling,name", [(0, "4:4:4"), (2, "4:2:0")])
def test_progressive_decode_matches_oracle(subsampling, name):
    """Progressive (SOF2) JPEGs — spectral selection,
    successive approximation, EOB runs — must decode for real; real asset
    packs contain them (src/gltf_loader.rs:128-163 via the
    `image` crate)."""
    img = _smooth(130, 94, seed=2)     # non-multiple-of-MCU on purpose
    data = _encode(img, quality=90, progressive=True,
                   subsampling=subsampling)
    assert b"\xff\xc2" in data         # really SOF2
    got = decode_jpeg(data)
    assert got.shape == (94, 130, 4)
    ref = _oracle(data)
    diff = np.abs(got[..., :3].astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() < 2.0, f"{name}: mean {diff.mean()}"
    assert np.percentile(diff, 99) <= 12


def test_progressive_grayscale():
    img = _smooth(72, 56)[..., 0]
    data = _encode(img, quality=92, progressive=True)
    got = decode_jpeg(data)
    ref = _oracle(data)
    diff = np.abs(got[..., :3].astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() < 2.0


def test_progressive_restart_markers():
    cv2 = pytest.importorskip("cv2")
    img = _smooth(128, 96, seed=4)
    ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 88,
                            cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    assert ok
    data = enc.tobytes()
    assert b"\xff\xc2" in data and b"\xff\xdd" in data
    got = decode_jpeg(data)
    ref = _oracle(data)
    diff = np.abs(got[..., :3].astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() < 2.0


def test_not_a_jpeg():
    with pytest.raises(JpegError):
        decode_jpeg(b"\x89PNG\r\n\x1a\nnope")


def test_native_scan_matches_python():
    """csrc/libjpeg_scan.so (the C++ entropy loop) must decode bit-
    identically to the Python loop on baseline AND progressive streams,
    with restarts and subsampling."""
    from gpu_raytracer.utils import jpeg as J

    img = _smooth(130, 94, seed=9)
    streams = [
        _encode(img, quality=90, subsampling=2),
        _encode(img, quality=85, progressive=True, subsampling=2),
        _encode(img[..., 0], quality=92, progressive=True),
    ]
    cv2 = None
    try:
        import cv2 as _cv2
        cv2 = _cv2
    except ImportError:
        pass
    if cv2 is not None:
        ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 88,
                                cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
        assert ok
        streams.append(enc.tobytes())
    for i, data in enumerate(streams):
        J.use_native = True
        a = decode_jpeg(data)
        J.use_native = False
        try:
            b = decode_jpeg(data)
        finally:
            J.use_native = True
        np.testing.assert_array_equal(a, b, err_msg=f"stream {i}")


def test_native_scan_speedup():
    """The point of the native loop: a real end-to-end decode speedup on a
    megapixel-class stream (the remaining time is the vectorised IDCT,
    shared by both paths)."""
    import time

    from gpu_raytracer.utils import jpeg as J

    img = _smooth(512, 512, seed=3)
    data = _encode(img, quality=90)

    def best_of(n=3):
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            decode_jpeg(data)
            best = min(best, time.perf_counter() - t0)
        return best

    # best-of-3 with a warmup decode on each path: a single-shot measurement
    # under CI load flaked (one slow native run inverted the ratio)
    J.use_native = True
    decode_jpeg(data)
    t_native = best_of()
    J.use_native = False
    try:
        decode_jpeg(data)
        t_python = best_of()
    finally:
        J.use_native = True
    assert t_python / t_native > 1.3, (t_python, t_native)


def test_overfull_dht_rejected_not_crash():
    """A corrupt DHT whose counts overflow the canonical code space must
    raise JpegError — numpy slicing would silently clamp (garbage decode)
    and the native LUT build formerly memset past its 64 KiB tables
    (process crash)."""
    img = _smooth(32, 32, seed=4)
    data = bytearray(_encode(img))
    # find the first DHT marker and overflow its first length count
    i = data.find(b"\xff\xc4")
    assert i >= 0
    # payload: 2-byte length, 1-byte table class/id, 16 counts, symbols
    data[i + 5] = 255  # counts[0] = 255 one-bit codes: overfull
    with pytest.raises(JpegError):
        decode_jpeg(bytes(data))


def test_native_rejects_overfull_dht_directly():
    """Defense in depth: even if a corrupt table reaches the NATIVE decoder
    (bypassing the Python-side DHT validation), bvh_collapse-style bounds
    checking must reject it with rc -1 instead of memsetting past the
    64 KiB LUTs (formerly a reproducible segfault)."""
    import ctypes

    from gpu_raytracer.utils import jpeg as J

    lib = J._load_native()
    # one component, one block; DHT with counts[0]=255 (overfull)
    tables = np.zeros(2 * 272, np.uint8)
    tables[0] = 255                       # DC counts[0]
    tables[16:272] = 5                    # symbols (arbitrary)
    tables[272] = 255                     # AC counts[0]
    ent = np.zeros(16, np.uint8)
    rst = np.zeros(0, np.int64)
    coef = np.zeros((1, 1, 64), np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    coefp = (ctypes.c_void_p * 1)(coef.ctypes.data)
    gw = np.asarray([1], np.int32)
    ch = np.asarray([1], np.int32)
    cv = np.asarray([1], np.int32)
    rc = lib.jpeg_decode_scan(
        ent.ctypes.data_as(u8p), ent.shape[0],
        rst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 0,
        0, tables.ctypes.data_as(u8p), 1,
        ch.ctypes.data_as(i32p), cv.ctypes.data_as(i32p),
        1, 1, 1, 1, 0, 63, 0, 0, coefp, gw.ctypes.data_as(i32p))
    assert rc == -1
