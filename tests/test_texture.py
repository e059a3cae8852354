"""Texture atlas sampling tests (ops/texture.py).

The reference binds texture data but never samples it (bindings are
underscore-named, shader/src/lib.rs:34-35); here sampling is
implemented for real, so these tests are oracle'd against plain NumPy."""

import numpy as np
import jax.numpy as jnp
import pytest

from gpu_raytracer.models.geometry import Textures
from gpu_raytracer.ops.texture import (
    NO_TEXTURE, sample_texture, interpolate_uv, sphere_uv)


def checkerboard(w=8, h=8, a=(255, 0, 0, 255), b=(0, 0, 255, 255)):
    img = np.zeros((h, w, 4), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[(xx + yy) % 2 == 0] = a
    img[(xx + yy) % 2 == 1] = b
    return img


def test_nearest_sampling_texel_centers():
    tex = Textures.from_images([checkerboard()])
    # sample at texel centers: (x+0.5)/8, (y+0.5)/8
    xs, ys = np.meshgrid(np.arange(8), np.arange(8))
    uv = jnp.asarray(np.stack([(xs.ravel() + 0.5) / 8.0,
                               (ys.ravel() + 0.5) / 8.0], axis=-1),
                     jnp.float32)
    idx = jnp.zeros((64,), jnp.uint32)
    rgba = np.asarray(sample_texture(tex, idx, uv, bilinear=False))
    want_red = ((xs.ravel() + ys.ravel()) % 2) == 0
    np.testing.assert_allclose(rgba[want_red, 0], 1.0, atol=1e-6)
    np.testing.assert_allclose(rgba[want_red, 2], 0.0, atol=1e-6)
    np.testing.assert_allclose(rgba[~want_red, 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(rgba[:, 3], 1.0, atol=1e-6)


def test_bilinear_matches_numpy():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(5, 9, 4), dtype=np.uint8)
    tex = Textures.from_images([img])
    uv = rng.uniform(0.02, 0.98, size=(64, 2)).astype(np.float32)
    got = np.asarray(sample_texture(tex, jnp.zeros((64,), jnp.uint32),
                                    jnp.asarray(uv), bilinear=True))

    h, w = img.shape[:2]
    f = img.astype(np.float32) / 255.0
    want = np.zeros((64, 4), np.float32)
    for i, (u, v) in enumerate(uv):
        x = u * w - 0.5
        y = v * h - 0.5
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        def at(xx, yy):
            return f[yy % h, xx % w]
        want[i] = ((at(x0, y0) * (1 - fx) + at(x0 + 1, y0) * fx) * (1 - fy)
                   + (at(x0, y0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1) * fx) * fy)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_repeat_wrap():
    tex = Textures.from_images([checkerboard()])
    idx = jnp.zeros((2,), jnp.uint32)
    inside = sample_texture(tex, idx, jnp.asarray([[0.0625, 0.0625]] * 2),
                            bilinear=False)
    outside = sample_texture(
        tex, idx,
        jnp.asarray([[1.0625, -0.9375]] * 2, jnp.float32), bilinear=False)
    np.testing.assert_allclose(np.asarray(inside), np.asarray(outside),
                               atol=1e-6)


def test_no_texture_is_identity():
    tex = Textures.from_images([checkerboard()])
    idx = jnp.asarray([NO_TEXTURE, 0], dtype=jnp.uint32)
    uv = jnp.asarray([[0.3, 0.7], [0.3, 0.7]], jnp.float32)
    rgba = np.asarray(sample_texture(tex, idx, uv))
    np.testing.assert_allclose(rgba[0], [1, 1, 1, 1], atol=1e-6)


def test_multi_texture_atlas_offsets():
    red = np.full((4, 4, 4), [255, 0, 0, 255], np.uint8)
    green = np.full((2, 6, 4), [0, 255, 0, 255], np.uint8)
    tex = Textures.from_images([red, green])
    uv = jnp.asarray([[0.5, 0.5], [0.5, 0.5]], jnp.float32)
    rgba = np.asarray(sample_texture(tex, jnp.asarray([0, 1], dtype=jnp.uint32),
                                     uv, bilinear=False))
    np.testing.assert_allclose(rgba[0][:3], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(rgba[1][:3], [0, 1, 0], atol=1e-6)


def test_interpolate_uv_barycentric():
    tri_uv = jnp.asarray([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]], jnp.float32)
    idx = jnp.zeros((3,), jnp.int32)
    bu = jnp.asarray([0.0, 1.0, 0.25], jnp.float32)
    bv = jnp.asarray([0.0, 0.0, 0.5], jnp.float32)
    uv = np.asarray(interpolate_uv(tri_uv, idx, bu, bv))
    np.testing.assert_allclose(uv, [[0, 0], [1, 0], [0.25, 0.5]], atol=1e-6)


def test_sphere_uv_poles_and_seam():
    n = jnp.asarray([[0.0, 1.0, 0.0],    # north pole -> v=0
                     [0.0, -1.0, 0.0],   # south pole -> v=1
                     [1.0, 0.0, 0.0],    # +x -> u=0.5
                     [-1.0, 0.0, 0.0]],  # -x -> u in {0,1}
                    jnp.float32)
    uv = np.asarray(sphere_uv(n))
    assert abs(uv[0, 1] - 0.0) < 1e-6
    assert abs(uv[1, 1] - 1.0) < 1e-6
    assert abs(uv[2, 0] - 0.5) < 1e-6
    assert min(abs(uv[3, 0] - 0.0), abs(uv[3, 0] - 1.0)) < 1e-6


def test_textured_triangle_render():
    """End-to-end: a camera-facing textured quad shows the checkerboard."""
    from gpu_raytracer.models.scene import prepare_scene
    from gpu_raytracer.models.geometry import Mesh, Spheres
    from gpu_raytracer.models.material import MaterialBuilder
    from gpu_raytracer.models.light import LightBuilder
    from gpu_raytracer.models.camera import Camera
    from gpu_raytracer.engine.renderer import render_image

    mb = MaterialBuilder()
    ti = np.full(8, 0xFFFFFFFF, np.uint32)
    ti[0] = 0  # base-color slot
    mb.add(albedo=(1.0, 1.0, 1.0), metallic=0.0, roughness=1.0,
           texture_indices=ti)
    lb = LightBuilder()
    lb.add_point((0.0, 0.0, 2.0), (1.0, 1.0, 1.0), 20.0)

    # unit quad at z=-1 spanning [-1,1]^2, uv spanning [0,1]^2
    verts = np.asarray([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1]],
                       np.float32)
    uvs = np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    mesh = Mesh.from_arrays(verts, idx, np.zeros(2, np.uint32), uv=uvs)
    tex = Textures.from_images([checkerboard(8, 8)])
    scene = prepare_scene(Camera.default(), Spheres.from_rows([]), mesh,
                          mb.build(), lb.build(), textures=tex)
    img = render_image(scene, 64, 64)
    # the checker pattern must appear: red-dominant and blue-dominant pixels
    center = img[8:56, 8:56]
    assert (center[..., 0] > 2 * center[..., 2]).any()
    assert (center[..., 2] > 2 * center[..., 0]).any()


def test_wrap_modes():
    """Sampler wrap: REPEAT / CLAMP_TO_EDGE / MIRRORED_REPEAT."""
    grad = np.zeros((1, 4, 4), np.uint8)
    grad[0, :, 0] = [0, 85, 170, 255]   # R ramp across x
    grad[0, :, 3] = 255
    # u=1.125 lands at texel x=4.5: REPEAT -> texel 0, CLAMP -> texel 3,
    # MIRRORED -> texel 3 (folded back)
    for mode, u_out, want_r in ((0, 1.125, 0 / 255),
                                (1, 1.5, 255 / 255),
                                (2, 1.125, 255 / 255)):
        tex = Textures.from_images([grad], wrap=[mode])
        got = np.asarray(sample_texture(tex, jnp.zeros((1,), jnp.uint32),
                                        jnp.asarray([[u_out, 0.5]],
                                                    jnp.float32),
                                        bilinear=False))
        assert abs(got[0, 0] - want_r) < 1e-6, (mode, got[0])


def _oracle_bilinear(img, uv, mode):
    """Standard per-tap-wrap bilinear (the semantics the guard-band atlas
    must reproduce without any per-tap wrap logic)."""
    h, w = img.shape[:2]
    f = img.astype(np.float32) / 255.0

    def wrapc(x, size):
        if mode == 1:
            return np.clip(x, 0, size - 1)
        if mode == 2:
            per = np.mod(x, 2 * size)
            return np.where(per < size, per, 2 * size - 1 - per)
        return np.mod(x, size)

    out = np.zeros((uv.shape[0], 4), np.float32)
    for i, (u, v) in enumerate(uv):
        x = u * w - 0.5
        y = v * h - 0.5
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        at = lambda xx, yy: f[wrapc(yy, h), wrapc(xx, w)]
        out[i] = ((at(x0, y0) * (1 - fx) + at(x0 + 1, y0) * fx) * (1 - fy)
                  + (at(x0, y0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1) * fx) * fy)
    return out


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bilinear_wrap_modes_out_of_range(mode):
    """Bilinear with uv far outside [0,1] under all three wrap modes —
    exercises the guard texels, the guard row, and the MIRRORED_REPEAT
    reflected-period tap-direction flip."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(6, 11, 4), dtype=np.uint8)
    tex = Textures.from_images([img], wrap=[mode])
    uv = rng.uniform(-2.5, 2.5, size=(256, 2)).astype(np.float32)
    got = np.asarray(sample_texture(tex, jnp.zeros((256,), jnp.uint32),
                                    jnp.asarray(uv), bilinear=True))
    want = _oracle_bilinear(img, uv, mode)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bilinear_wide_texture_chunk_seams():
    """Textures wider than one 127-texel atlas chunk: taps crossing chunk
    boundaries must read the duplicated guard lane, not a neighbour row."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size=(3, 300, 4), dtype=np.uint8)
    tex = Textures.from_images([img])
    # focus sampling density near the chunk seams x = 127, 254
    xs = np.concatenate([rng.uniform(126, 129, 200),
                         rng.uniform(253, 256, 200),
                         rng.uniform(0, 300, 100)])
    uv = np.stack([xs / 300.0, rng.uniform(0, 1, xs.shape[0])],
                  axis=-1).astype(np.float32)
    got = np.asarray(sample_texture(tex, jnp.zeros((xs.shape[0],), jnp.uint32),
                                    jnp.asarray(uv), bilinear=True))
    want = _oracle_bilinear(img, uv, 0)
    np.testing.assert_allclose(got, want, atol=1e-5)
