"""Packing helpers + branchless selects — mirrors the reference's in-source
unit tests (shared/src/lib.rs:1328-1456)."""

import numpy as np
import jax.numpy as jnp

from gpu_raytracer.utils.packing import (
    F32_MAX, branchless_float_if, branchless_u32_if,
    color_channel, current_bounce_depth, max_bounce_depth, wavefront_mode,
    pack_flags, pack_tile_size, unpack_tile_size)


def test_tile_size_roundtrip():
    # PushConstants packing round-trip (lib.rs:1434-1455)
    assert unpack_tile_size(pack_tile_size(128, 128)) == (128, 128)
    assert unpack_tile_size(pack_tile_size(1, 65535)) == (1, 65535)
    assert unpack_tile_size(pack_tile_size(70000, 3)) == (65535, 3)  # clamp


def test_flags_roundtrip():
    f = pack_flags(2, 3, 8, 1)
    assert color_channel(f) == 2
    assert current_bounce_depth(f) == 3
    assert max_bounce_depth(f) == 8
    assert wavefront_mode(f) == 1
    assert pack_flags(0, 0, 0, 0) == 0


def test_branchless_u32_if():
    assert branchless_u32_if(True, 7, 13) == 7
    assert branchless_u32_if(False, 7, 13) == 13
    assert branchless_u32_if(True, 0xFFFFFFFF, 0) == 0xFFFFFFFF
    assert branchless_u32_if(False, 0xFFFFFFFF, 0) == 0


def test_branchless_float_if_trivial():
    # lib.rs:1343-1350
    for cond, t, f, want in [(True, 0.5, -1.0, 0.5), (False, 0.5, -1.0, -1.0),
                             (True, -0.5, 1.0, -0.5), (False, -0.5, 1.0, 1.0)]:
        v, ok = branchless_float_if(cond, t, f)
        assert float(v) == want and bool(ok)


def test_branchless_float_if_nan_poisoning():
    # lib.rs:1353-1365: a NaN arm yields the OTHER arm regardless of the
    # condition; both NaN -> (f32::MAX, False)
    nan = float("nan")
    for cond in (True, False):
        v, ok = branchless_float_if(cond, 0.5, nan)
        assert float(v) == 0.5 and bool(ok)
        v, ok = branchless_float_if(cond, nan, 1.0)
        assert float(v) == 1.0 and bool(ok)
    v, ok = branchless_float_if(False, nan, nan)
    assert float(v) == np.float32(F32_MAX) and not bool(ok)


def test_branchless_float_if_vectorised():
    cond = jnp.asarray([True, False, True])
    t = jnp.asarray([1.0, 2.0, float("nan")])
    f = jnp.asarray([3.0, 4.0, 5.0])
    v, ok = branchless_float_if(cond, t, f)
    np.testing.assert_allclose(np.asarray(v), [1.0, 4.0, 5.0])
    assert np.asarray(ok).all()
