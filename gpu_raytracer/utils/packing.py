"""Bit-packing helpers matching the reference's PushConstants layout.

The reference squeezes kernel parameters into a 128-byte push-constant block
(shared/src/lib.rs:212-227) with packed tile sizes and flag
bytes (lib.rs:1136-1179). The JAX pipeline has no binding-size limit — launch
parameters travel as jit-static arguments and scalar operands — but the
packing functions are kept, bit-compatible, for scene interchange and parity
tests (the reference unit-tests them, shared/src/lib.rs:1434-1455).
"""

from __future__ import annotations


def pack_tile_size(width: int, height: int) -> int:
    """width in low 16 bits, height in high 16, clamped to u16
    (PushConstants::pack_tile_size, lib.rs:1138-1142)."""
    return (min(width, 65535) & 0xFFFF) | ((min(height, 65535) & 0xFFFF) << 16)


def unpack_tile_size(packed: int) -> tuple[int, int]:
    return packed & 0xFFFF, (packed >> 16) & 0xFFFF


def pack_flags(color_channel: int, current_bounce_depth: int,
               max_bounce_depth: int, wavefront_mode: int) -> int:
    """Byte-packed flags (lib.rs:1154-1159): channel | current<<8 |
    max<<16 | wavefront<<24."""
    return ((color_channel & 0xFF)
            | ((current_bounce_depth & 0xFF) << 8)
            | ((max_bounce_depth & 0xFF) << 16)
            | ((wavefront_mode & 0xFF) << 24))


def color_channel(flags: int) -> int:
    return flags & 0xFF


def current_bounce_depth(flags: int) -> int:
    return (flags >> 8) & 0xFF


def max_bounce_depth(flags: int) -> int:
    return (flags >> 16) & 0xFF


def wavefront_mode(flags: int) -> int:
    return (flags >> 24) & 0xFF


def branchless_u32_if(condition: bool, if_true: int, if_false: int) -> int:
    """The reference's branchless u32 select (shared/src/lib.rs:1318-1326):
    t ^ ((t ^ f) & (cond - 1)) in wrapping u32 arithmetic."""
    c = 1 if condition else 0
    mask = (c - 1) & 0xFFFFFFFF
    return (if_true ^ ((if_true ^ if_false) & mask)) & 0xFFFFFFFF


F32_MAX = 3.4028235e38


def branchless_float_if(condition, if_true, if_false):
    """NaN-safe branchless float select → (value, is_valid), matching the
    reference macro's semantics (shared/src/lib.rs:1294-1316, tests
    lib.rs:1333-1365): NaN arms are clamped to f32::MAX (Rust `min` returns
    the non-NaN operand), a NaN arm yields the OTHER arm regardless of the
    condition, both-NaN yields (f32::MAX, False). Works on scalars and
    jnp/np arrays alike."""
    import jax.numpy as jnp

    mx = jnp.float32(F32_MAX)
    lim = jnp.float32(F32_MAX - 1.0)
    t = jnp.asarray(if_true, jnp.float32)
    f = jnp.asarray(if_false, jnp.float32)
    at = jnp.where(jnp.isnan(t), mx, jnp.minimum(t, mx))
    af = jnp.where(jnp.isnan(f), mx, jnp.minimum(f, mx))
    true_contrib = jnp.where(at < lim, at, af)
    false_contrib = jnp.where(af < lim, af, at)
    res = jnp.where(condition, true_contrib, false_contrib)
    return res, res < lim
