"""Image output: PNG (pure-python zlib encoder) and PPM.

The reference displays frames through a swapchain whose format is sRGB
(Bgra8UnormSrgb preferred, src/renderer.rs:128-133): the
fragment shader's LINEAR output is hardware-encoded with the sRGB transfer
on present. Our display boundary is therefore sRGB too: every u8 quantise
on the way to a sink (PNG/PPM/Tk/HTTP) applies the exact piecewise IEC
61966-2-1 encode by default. Accumulation, parity probes and golden tests
stay linear — pass srgb=False (the intermediate rgba8 storage-texture
write the shader does, lib.rs:86-88, is linear; only the swapchain
converts)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SRGB_CUT = 0.0031308          # linear-domain breakpoint
_SRGB_CUT_ENC = 0.04045        # encoded-domain breakpoint (= 12.92 * cut)


def linear_to_srgb(x, xp=np):
    """Exact piecewise sRGB opto-electronic transfer (IEC 61966-2-1), the
    encode the reference's sRGB swapchain applies in hardware. Works on
    numpy (default) or jax.numpy arrays via `xp`; input is clipped to
    [0, 1] first."""
    x = xp.clip(x, 0.0, 1.0)
    lo = x * 12.92
    # the max() keeps power() off zero/negative lanes that lo covers
    hi = 1.055 * xp.power(xp.maximum(x, _SRGB_CUT), 1.0 / 2.4) - 0.055
    return xp.where(x <= _SRGB_CUT, lo, hi)


def srgb_to_linear(x, xp=np):
    """Inverse of linear_to_srgb (electro-optical transfer)."""
    x = xp.clip(x, 0.0, 1.0)
    lo = x * (1.0 / 12.92)
    hi = xp.power((xp.maximum(x, _SRGB_CUT_ENC) + 0.055) * (1.0 / 1.055),
                  2.4)
    return xp.where(x <= _SRGB_CUT_ENC, lo, hi)


def to_u8(img: np.ndarray, srgb: bool = True) -> np.ndarray:
    """Display quantise: [H,W,3] linear float → u8 (round-to-nearest),
    sRGB-encoded by default (the swapchain boundary). srgb=False keeps the
    raw linear quantise for data/parity output."""
    if srgb and img.dtype != np.uint8:
        img = linear_to_srgb(np.asarray(img, np.float32))
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(img: np.ndarray, level: int = 6, srgb: bool = True) -> bytes:
    """Encode [H,W,3] RGB or [H,W,4] RGBA as PNG bytes. Float input is
    linear and gets the sRGB display encode (srgb=False for raw linear);
    uint8 input is presented as-is (assumed already display-encoded)."""
    if img.dtype != np.uint8:
        img = to_u8(img, srgb=srgb)
    h, w = img.shape[:2]
    color_type = 6 if img.shape[-1] == 4 else 2
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, srgb: bool = True) -> None:
    """Write [H,W,3] float (linear → sRGB-encoded u8 by default) or uint8
    (as-is) to an RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img, srgb=srgb))


def write_ppm(path: str, img: np.ndarray, srgb: bool = True) -> None:
    if img.dtype != np.uint8:
        img = to_u8(img, srgb=srgb)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Per-pixel RMSE, the BASELINE.md fidelity metric."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
