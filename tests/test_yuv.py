"""YUV 4:2:0 present packing (utils/yuv.py) and the Viewer's packed
present path."""

import numpy as np
import jax.numpy as jnp

from gpu_raytracer import build_default_scene
from gpu_raytracer.utils.image import linear_to_srgb
from gpu_raytracer.utils.yuv import decode_yuv420, encode_yuv420


def test_round_trip_close_on_smooth_content():
    """Smooth gradients survive encode+decode within a few counts (chroma
    is 2x2-averaged, so only chroma EDGES lose information)."""
    H = W = 64
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    # keep the ramp off the sRGB toe (slope 12.92 near 0 makes chroma
    # averaging visibly lossy on near-black gradients — codec behaviour)
    img = 0.2 + 0.6 * np.stack([x / W, y / H, (x + y) / (W + H)], axis=-1)
    packed = np.asarray(encode_yuv420(jnp.asarray(img)))
    assert packed.shape == (H * 3 // 2, W) and packed.dtype == np.uint8
    rgb = decode_yuv420(packed)
    want = (np.clip(linear_to_srgb(img), 0, 1) * 255.0 + 0.5).astype(np.uint8)
    err = np.abs(rgb.astype(int) - want.astype(int))
    # chroma is 2x2-averaged: the steep near-black sRGB ramp at the image
    # corner can move a couple dozen counts in one channel; the body of
    # the frame stays within a count or two
    assert err.mean() < 1.5 and np.percentile(err, 99) <= 8


def test_gray_is_exactish():
    """Achromatic content has constant chroma — subsampling is lossless,
    so gray round-trips to within a count."""
    img = np.full((32, 32, 3), 0.5, np.float32)
    rgb = decode_yuv420(np.asarray(encode_yuv420(jnp.asarray(img))))
    want = int(round(float(linear_to_srgb(np.float64(0.5))) * 255))
    assert np.abs(rgb.astype(int) - want).max() <= 1


def test_viewer_packed_present_matches_u8_present():
    """present_frame_packed on a device path-trace frame decodes to
    (approximately) the same display image as the RGB u8 present; both
    ride materialize_frame."""
    from gpu_raytracer.engine.viewer import Viewer

    v = Viewer(build_default_scene(), 64, 64, shadows=False, verbose=False)
    v.handle_key("p")
    v.run_compute()
    u8 = np.asarray(v.present_frame())
    packed = v.present_frame_packed()
    assert np.asarray(packed).ndim == 2           # device YUV handle
    rgb = v.materialize_frame(packed)
    assert rgb.shape == u8.shape and rgb.dtype == np.uint8
    err = np.abs(rgb.astype(int) - u8.astype(int))
    # luma-exact-ish everywhere; chroma edges may move a few counts
    assert np.median(err) <= 1 and err.mean() < 3.0
