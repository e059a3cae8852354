"""Device-side YUV 4:2:0 present packing.

The reference presents on-GPU through its swapchain — the only
device->host copy is ours, and a remote viewer pays for its bytes. Chroma
subsampling is the standard remote-present answer (every video codec's
input format): luma at full resolution, chroma 2x2-averaged — 1.5
bytes/px, half the fetch, visually lossless for rendered content in
motion.

Encode runs ON DEVICE (jit) on the sRGB-encoded display frame: full-range
BT.601 (JFIF) matrices. The host unpacks to RGB u8 for PPM/PNG sinks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .image import linear_to_srgb


@jax.jit
def encode_yuv420(img) -> jnp.ndarray:
    """Linear [H,W,3] f32 (H, W even) -> packed u8 [H*3//2, W]:
    rows 0..H-1 = Y, then H//2 rows of U, then... U and V ride
    interleaved half-rows: row H + k holds U's row k in columns 0..W//2
    and V's row k in columns W//2..W. sRGB display encode is applied
    before the matrix (chroma averages gamma-encoded values, as JFIF
    does)."""
    H, W = img.shape[0], img.shape[1]
    s = linear_to_srgb(img, xp=jnp) * 255.0
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    sub = lambda c: (c.reshape(H // 2, 2, W // 2, 2).mean((1, 3)))
    u = sub(cb)
    v = sub(cr)
    chroma = jnp.concatenate([u, v], axis=1)            # [H/2, W]
    packed = jnp.concatenate([y, chroma], axis=0)       # [H*3/2, W]
    return (jnp.clip(packed, 0.0, 255.0) + 0.5).astype(jnp.uint8)


def decode_yuv420(packed: np.ndarray) -> np.ndarray:
    """Packed u8 [H*3//2, W] -> display RGB u8 [H,W,3] (host numpy)."""
    packed = np.asarray(packed)
    H = packed.shape[0] * 2 // 3
    W = packed.shape[1]
    y = packed[:H].astype(np.float32)
    u = packed[H:, : W // 2].astype(np.float32) - 128.0
    v = packed[H:, W // 2:].astype(np.float32) - 128.0
    up = lambda c: np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)
    u = up(u)
    v = up(v)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 255.0).astype(np.uint8)
