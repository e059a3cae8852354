"""f16 bit-packing helpers.

The reference stores several material/light parameters as IEEE-754 half floats
packed two-per-u32 (`shared/src/lib.rs:53-55,79-80`, packing in
`Material::new` lib.rs:247-312 and `Light::pack_*` lib.rs:482-494) and decodes
them on-device (`shader/src/material.rs:26-38`). We keep the
identical storage format — u32 arrays with (low, high) f16 halves — so parity
tests can compare bit-for-bit, and decode with hardware-exact `jnp.float16`
bitcasts instead of the reference's software decoder (shared/src/lib.rs:448-477).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_f16_pair(low: np.ndarray | float, high: np.ndarray | float) -> np.ndarray:
    """Host-side: pack two f32 values into one u32 as (low f16 | high f16 << 16).

    Mirrors Material::new packing (shared/src/lib.rs:264-273).
    """
    lo = np.asarray(low, dtype=np.float16).view(np.uint16).astype(np.uint32)
    hi = np.asarray(high, dtype=np.float16).view(np.uint16).astype(np.uint32)
    return (lo | (hi << np.uint32(16))).astype(np.uint32)


def unpack_f16_pair_host(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of :func:`pack_f16_pair`, returning f32 pairs."""
    packed = np.asarray(packed, dtype=np.uint32)
    lo = (packed & np.uint32(0xFFFF)).astype(np.uint16).view(np.float16).astype(np.float32)
    hi = ((packed >> np.uint32(16)) & np.uint32(0xFFFF)).astype(np.uint16).view(np.float16).astype(np.float32)
    return lo, hi


def unpack_f16_low(packed: jnp.ndarray) -> jnp.ndarray:
    """Device-side: decode the low 16 bits of a u32 as f16 → f32.

    Equivalent of MaterialEvaluator::metallic / ::ior
    (shader/src/material.rs:26-28,36-38).
    """
    bits = (packed & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    return jax.lax.bitcast_convert_type(bits, jnp.float16).astype(jnp.float32)


def unpack_f16_high(packed: jnp.ndarray) -> jnp.ndarray:
    """Device-side: decode the high 16 bits of a u32 as f16 → f32.

    Equivalent of MaterialEvaluator::roughness / ::transmission
    (shader/src/material.rs:31-33,61-63).
    """
    bits = ((packed >> jnp.uint32(16)) & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    return jax.lax.bitcast_convert_type(bits, jnp.float16).astype(jnp.float32)


def f16_roundtrip(x: jnp.ndarray) -> jnp.ndarray:
    """Round-trip a f32 value through f16 precision, on device.

    The reference routes its light-attenuation factor through hardware f16
    (shader/src/lighting.rs:125-127); this reproduces the
    quantization exactly.
    """
    return x.astype(jnp.float16).astype(jnp.float32)
