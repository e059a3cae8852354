"""f16 packing semantics — parity with the reference's half-packed fields
(shared/src/lib.rs:247-312, shader/src/material.rs:26-38)."""

import numpy as np
import jax.numpy as jnp

from gpu_raytracer.ops.f16 import (
    f16_roundtrip, pack_f16_pair, unpack_f16_high, unpack_f16_low,
    unpack_f16_pair_host,
)


def test_pack_unpack_roundtrip_host():
    lo = np.array([0.0, 1.0, 0.5, 1.5, 0.9, 123.25], np.float32)
    hi = np.array([1.0, 0.1, 2.0, 0.0, 1e-3, 0.33], np.float32)
    packed = pack_f16_pair(lo, hi)
    lo2, hi2 = unpack_f16_pair_host(packed)
    np.testing.assert_array_equal(lo2, lo.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(hi2, hi.astype(np.float16).astype(np.float32))


def test_device_unpack_matches_host():
    vals = np.array([0.0, 0.25, 0.5, 1.0, 1.5, 0.9, 2.4, 65504.0], np.float32)
    packed = pack_f16_pair(vals, vals[::-1].copy())
    lo_d = np.asarray(unpack_f16_low(jnp.asarray(packed)))
    hi_d = np.asarray(unpack_f16_high(jnp.asarray(packed)))
    lo_h, hi_h = unpack_f16_pair_host(packed)
    np.testing.assert_array_equal(lo_d, lo_h)
    np.testing.assert_array_equal(hi_d, hi_h)


def test_pack_layout_low_high():
    # metallic in low 16 bits, roughness in high 16 (Material::new lib.rs:264-268)
    p = int(pack_f16_pair(1.0, 0.5))
    one = np.float16(1.0).view(np.uint16)
    half = np.float16(0.5).view(np.uint16)
    assert (p & 0xFFFF) == int(one)
    assert (p >> 16) == int(half)


def test_f16_roundtrip_quantizes():
    x = jnp.asarray([0.1234567, 1.0, 0.0], jnp.float32)
    got = np.asarray(f16_roundtrip(x))
    want = np.asarray([0.1234567, 1.0, 0.0], np.float32).astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_infinity_packs():
    p = pack_f16_pair(np.inf, 0.0)
    lo, hi = unpack_f16_pair_host(p)
    assert np.isinf(lo) and hi == 0.0
