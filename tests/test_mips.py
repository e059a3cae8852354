"""Mip pyramid atlases (models/geometry.py::Textures mips) + per-lane
nearest-mip LOD selection (real-asset texture sets keep their detail;
minification must stop aliasing)."""

import numpy as np
import jax
import jax.numpy as jnp

from gpu_raytracer.models.geometry import Textures, _downsample2x
from gpu_raytracer.ops.texture import sample_texture


def _img(rng, h, w):
    return rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)


def test_pyramid_layout_and_level_content():
    """Level l of the contiguous pyramid contains exactly the l-times
    downsampled image: force each level via a footprint and compare against
    host downsampling."""
    rng = np.random.default_rng(0)
    img = _img(rng, 16, 16)
    tex = Textures.from_images([img], mips=8)
    assert tex.n_levels == 5 and int(tex.levels[0]) == 5
    want = img
    for lvl in range(5):
        w = max(16 >> lvl, 1)
        # texel centres of level lvl; footprint 2^lvl texels/pixel at level0
        uv = (np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                   indexing="xy"), -1)
              .reshape(-1, 2) + 0.5) / w
        lam = jnp.full((uv.shape[0],), float(2 ** lvl) / 16.0)
        got = np.asarray(sample_texture(
            tex, jnp.zeros(uv.shape[0], jnp.uint32),
            jnp.asarray(uv, jnp.float32), lam=lam))
        np.testing.assert_allclose(
            got.reshape(w, w, 4), want.astype(np.float32) / 255.0,
            atol=1e-6)
        want = _downsample2x(want)


def test_lod0_matches_unmipped_atlas():
    rng = np.random.default_rng(1)
    imgs = [_img(rng, 13, 21), _img(rng, 8, 8)]
    plain = Textures.from_images(imgs)
    mipped = Textures.from_images(imgs, mips=6)
    uv = rng.uniform(-0.5, 1.5, (256, 2)).astype(np.float32)
    idx = jnp.asarray(rng.integers(0, 2, 256).astype(np.uint32))
    a = np.asarray(sample_texture(plain, idx, jnp.asarray(uv)))
    b = np.asarray(sample_texture(mipped, idx, jnp.asarray(uv),
                                  lam=jnp.zeros((256,))))
    np.testing.assert_array_equal(a, b)


def test_budget_rows_clamps_finest_level():
    """Over the row budget, the finest level of every texture is dropped:
    the atlas fits and level 0 halves."""
    rng = np.random.default_rng(2)
    imgs = [_img(rng, 256, 256) for _ in range(4)]
    t = Textures.from_images(imgs, mips=9, budget_rows=2000)
    assert t.num_rows <= 2000
    assert int(t.width[0]) < 256  # finest level(s) dropped
    # the resident level 0 is the downsampled source
    want = imgs[0]
    while want.shape[1] > int(t.width[0]):
        want = _downsample2x(want)
    uv = (np.stack(np.meshgrid(np.arange(8), np.arange(8),
                               indexing="xy"), -1).reshape(-1, 2)
          + 0.5) / int(t.width[0]) * (int(t.width[0]) / int(t.width[0]))
    uv = (uv * int(t.width[0]) // 1 + 0.5) / int(t.width[0])  # texel centres
    got = np.asarray(sample_texture(
        t, jnp.zeros(64, jnp.uint32), jnp.asarray(uv, jnp.float32),
        lam=jnp.zeros((64,))))
    w = int(t.width[0])
    ij = (uv * w - 0.5).round().astype(int)
    np.testing.assert_allclose(
        got, want[ij[:, 1], ij[:, 0]].astype(np.float32) / 255.0, atol=1e-6)


def test_16mtexel_scene_keeps_full_detail():
    """The done-criterion scene: >= 16 MTexels of source textures load with
    every level-0 texel (no atlas budget) and render through the main
    path."""
    from gpu_raytracer.engine.renderer import render_image
    from gpu_raytracer.models.material import MaterialBuilder
    from gpu_raytracer.models.geometry import Mesh, Spheres
    from gpu_raytracer.models.light import LightBuilder
    from gpu_raytracer.models.camera import Camera
    from gpu_raytracer.models.scene import prepare_scene

    rng = np.random.default_rng(3)
    # 16 x 1024x1024 = 16.8 MTexels of source data
    imgs = [np.tile(rng.integers(0, 256, (32, 1024, 4), dtype=np.uint8),
                    (32, 1, 1)) for _ in range(16)]
    tex = Textures.from_images(imgs, mips=12)
    assert (np.asarray(tex.width) == 1024).all()
    assert (np.asarray(tex.levels) == 11).all()

    mb = MaterialBuilder()
    for i in range(16):
        ti = np.full(8, 0xFFFFFFFF, np.uint32)
        ti[0] = i
        mb.add(albedo=(1.0, 1.0, 1.0), metallic=0.0, roughness=1.0,
               texture_indices=ti)
    lb = LightBuilder()
    lb.add_point((5, 7, 4), (1, 1, 1), 1.0, float("inf"))
    verts = rng.uniform(-3, 3, (120, 3)).astype(np.float32)
    idx = rng.integers(0, 120, (80, 3)).astype(np.uint32)
    uvs = rng.uniform(0, 4, (120, 2)).astype(np.float32)
    mesh = Mesh.from_arrays(verts, idx,
                            rng.integers(0, 16, 80).astype(np.uint32),
                            uv=uvs)
    scene = prepare_scene(Camera.default(), Spheres.from_rows([]), mesh,
                          mb.build(), lb.build(), textures=tex)
    img = render_image(scene, 32, 32)
    assert np.isfinite(img).all() and img.max() > 0.0


def _kernel_vs_xla(trilinear):
    """A mip-enabled textured frame through the GPU kernel branch
    (interpreted) and through the XLA branch: both feed the same hit
    record to the same footprint and sampler."""
    from kernel_branch import kernel_branch
    from gpu_raytracer.engine.renderer import render_chunk
    from gpu_raytracer.ops.packet_trace import tiled_pixel_order
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(2000, seed=1, textured=True)
    assert scene.textures.n_levels > 1  # procgen builds mips by default
    W = H = 64
    px, py = tiled_pixel_order(W, H, tile=64)
    px, py = jnp.asarray(px), jnp.asarray(py)
    kw = dict(shadows=True, use_bvh=True, leaf_size=8, trilinear=trilinear)
    want = np.asarray(render_chunk(scene, px, py, W, H, **kw))
    with kernel_branch():
        got = np.asarray(render_chunk(scene, px, py, W, H, **kw))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_kernel_mip_parity_end_to_end():
    _kernel_vs_xla(trilinear=False)


def test_minification_uses_coarser_level():
    """A distant textured wall must sample a coarser level: encode the level
    in the texture content (level 0 red-ish, deeper levels converge to the
    mean) and check the far render picks the averaged color, not aliased
    texels."""
    rng = np.random.default_rng(5)
    # checker at level 0 -> mid-gray at deep levels
    base = np.zeros((64, 64, 4), np.uint8)
    base[::2, ::2] = 255
    base[1::2, 1::2] = 255
    base[..., 3] = 255
    tex = Textures.from_images([base], mips=7)
    # huge footprint -> deepest level -> every channel near the mean (127ish)
    got = np.asarray(sample_texture(
        tex, jnp.zeros(4, jnp.uint32),
        jnp.asarray(rng.uniform(0, 1, (4, 2)), jnp.float32),
        lam=jnp.full((4,), 10.0)))
    assert np.all(np.abs(got[:, :3] - 0.5) < 0.02)
    # tiny footprint -> level 0 -> exact 0/255 texels survive
    got0 = np.asarray(sample_texture(
        tex, jnp.zeros(2, jnp.uint32),
        jnp.asarray([[1 / 128.0, 1 / 128.0], [3 / 128.0, 1 / 128.0]],
                    jnp.float32),
        lam=jnp.zeros((2,))))
    np.testing.assert_allclose(got0[0, :3], 1.0, atol=1e-6)
    np.testing.assert_allclose(got0[1, :3], 0.0, atol=1e-6)


def test_budget_drops_largest_chains_first():
    """The budget clamp is a PER-TEXTURE detail allocation —
    the most row-expensive chain pays first, small maps keep level 0."""
    rng = np.random.default_rng(7)
    imgs = [_img(rng, 512, 512)] + [_img(rng, 32, 32) for _ in range(3)]
    full = Textures.from_images(imgs, mips=10)
    need = full.num_rows
    t = Textures.from_images(imgs, mips=10, budget_rows=need - 500)
    assert t.num_rows <= need - 500
    assert int(t.width[0]) < 512           # the big one paid
    for i in (1, 2, 3):
        assert int(t.width[i]) == 32       # small maps stay sharp
        assert int(t.levels[i]) >= 1


def test_trilinear_continuous_across_level_boundary():
    """Optional trilinear filtering must remove the
    nearest-mip jump at level boundaries. Sweep the footprint through the
    level-0/1 boundary: nearest jumps, trilinear moves smoothly and is
    monotone between the two levels' values."""
    base = np.zeros((64, 64, 4), np.uint8)
    base[::2, ::2] = 255
    base[1::2, 1::2] = 255
    base[..., 3] = 255
    tex = Textures.from_images([base], mips=7)
    uv = jnp.asarray([[0.37, 0.53]], jnp.float32)
    idx = jnp.zeros(1, jnp.uint32)
    # footprints from 0.5/64 (lod 0) to 4/64 (lod 2): nearest flips at
    # sqrt(0.5) and sqrt(2) texels, trilinear blends
    lams = np.linspace(0.6 / 64.0, 3.0 / 64.0, 25).astype(np.float32)
    near = np.stack([np.asarray(sample_texture(
        tex, idx, uv, lam=jnp.full((1,), float(l))))[0] for l in lams])
    tri = np.stack([np.asarray(sample_texture(
        tex, idx, uv, lam=jnp.full((1,), float(l)), trilinear=True))[0]
        for l in lams])
    jumps_near = np.abs(np.diff(near[:, 0]))
    jumps_tri = np.abs(np.diff(tri[:, 0]))
    assert jumps_near.max() > 0.04          # nearest really bands
    assert jumps_tri.max() < jumps_near.max() * 0.5   # trilinear smooths
    # endpoints agree with the pure levels
    np.testing.assert_allclose(tri[0], near[0], atol=1e-6)


def test_trilinear_kernel_matches_xla():
    """Trilinear on: the kernel branch matches the XLA pipeline (same
    footprint, same two-level lerp)."""
    _kernel_vs_xla(trilinear=True)


def test_trilinear_quality_cost_psnr():
    """Quantify the filtering quality ladder: against the full-res (level-0
    bilinear) reference at moderate minification, trilinear must not be
    dramatically worse than nearest (both are approximations; trilinear
    trades a little blur for no banding)."""
    rng = np.random.default_rng(11)
    base = _img(rng, 128, 128)
    tex = Textures.from_images([base], mips=8)
    n = 512
    uv = jnp.asarray(rng.uniform(0.05, 0.95, (n, 2)), jnp.float32)
    idx = jnp.zeros(n, jnp.uint32)
    lam = jnp.full((n,), 1.5 / 128.0)       # between levels 0 and 1
    ref = np.asarray(sample_texture(tex, idx, uv, lam=jnp.zeros((n,))))
    near = np.asarray(sample_texture(tex, idx, uv, lam=lam))
    tri = np.asarray(sample_texture(tex, idx, uv, lam=lam, trilinear=True))

    def psnr(a, b):
        mse = np.mean((a - b) ** 2)
        return 10.0 * np.log10(1.0 / max(mse, 1e-12))

    p_near, p_tri = psnr(near, ref), psnr(tri, ref)
    # both within a sane band of the full-res reference; trilinear not
    # catastrophically blurrier than nearest (tolerate ~3 dB)
    assert p_near > 15.0 and p_tri > 15.0
    assert p_tri > p_near - 3.0
