"""GLB writer round-trip tests (run BASELINE config 4
through the ACTUAL glTF loader — the writer exists so the loader can be
exercised at scale with zero egress)."""

import numpy as np
import pytest

from gpu_raytracer import RaytracerConfig, build_default_scene, render_image
from gpu_raytracer.models.gltf import load_gltf, scene_from_gltf
from gpu_raytracer.models.gltf_export import export_glb
from gpu_raytracer.utils.image import rmse
from gpu_raytracer.utils.procgen import (courtyard_source_images,
                                             make_courtyard_scene)


def test_courtyard_glb_roundtrip_textured(tmp_path):
    """Textured courtyard → .glb → scene_from_gltf: materials/lights
    round-trip bit-exactly (f16 idempotence), geometry survives the
    loader's dedup, and the rendered images match."""
    config = RaytracerConfig()
    scene = make_courtyard_scene(2000, seed=1, textured=True, config=config)
    p = str(tmp_path / "courtyard.glb")
    export_glb(scene, p, images=courtyard_source_images(1))

    loaded = load_gltf(p)
    assert not loaded.image_warnings
    assert len(loaded.images) == 3
    assert loaded.triangles.shape[0] == scene.mesh.num_triangles
    assert len(loaded.cameras) == 1
    got = scene_from_gltf(p, config=config)

    # material table: bit-exact round trip, same order
    m0, m1 = scene.materials, got.materials
    np.testing.assert_array_equal(np.asarray(m0.metallic_roughness_f16),
                                  np.asarray(m1.metallic_roughness_f16))
    np.testing.assert_array_equal(np.asarray(m0.ior_transmission_f16),
                                  np.asarray(m1.ior_transmission_f16))
    np.testing.assert_allclose(np.asarray(m0.albedo), np.asarray(m1.albedo))
    np.testing.assert_array_equal(np.asarray(m0.texture_indices),
                                  np.asarray(m1.texture_indices))
    np.testing.assert_array_equal(np.asarray(m0.material_type),
                                  np.asarray(m1.material_type))
    # lights: packed fields bit-exact
    l0, l1 = scene.lights, got.lights
    np.testing.assert_array_equal(np.asarray(l0.light_type),
                                  np.asarray(l1.light_type))
    np.testing.assert_allclose(np.asarray(l0.position),
                               np.asarray(l1.position), atol=1e-6)
    # the builder keeps raw directions, the loader normalizes — compare
    # normalized (shading normalizes at use either way)
    d0 = np.asarray(l0.direction, np.float64)
    d1 = np.asarray(l1.direction, np.float64)
    n0 = np.where(np.linalg.norm(d0, axis=1, keepdims=True) > 0,
                  d0 / np.maximum(np.linalg.norm(d0, axis=1, keepdims=True),
                                  1e-12), 0.0)
    n1 = np.where(np.linalg.norm(d1, axis=1, keepdims=True) > 0,
                  d1 / np.maximum(np.linalg.norm(d1, axis=1, keepdims=True),
                                  1e-12), 0.0)
    np.testing.assert_allclose(n0, n1, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(l0.range_packed),
                                  np.asarray(l1.range_packed))
    np.testing.assert_allclose(np.asarray(l0.intensity),
                               np.asarray(l1.intensity))
    # camera
    np.testing.assert_allclose(np.asarray(scene.camera.position),
                               np.asarray(got.camera.position), atol=1e-6)
    np.testing.assert_allclose(np.asarray(scene.camera.direction),
                               np.asarray(got.camera.direction), atol=1e-6)
    np.testing.assert_allclose(float(scene.camera.fov),
                               float(got.camera.fov), atol=1e-5)
    # texture atlas identical (same images through the same packer)
    np.testing.assert_array_equal(np.asarray(scene.textures.data_u32),
                                  np.asarray(got.textures.data_u32))

    # canonical triangle order (models/scene.py::_canonical_tri_order):
    # the round trip permutes the triangle sequence, but both scenes sort
    # to the same content order before the BVH build, so the leaf-expanded
    # tables — and therefore every exact-t tie-break — are BIT-identical.
    np.testing.assert_array_equal(np.asarray(scene.tri_v0),
                                  np.asarray(got.tri_v0))
    np.testing.assert_array_equal(np.asarray(scene.tri_e1),
                                  np.asarray(got.tri_e1))
    np.testing.assert_array_equal(np.asarray(scene.tri_e2),
                                  np.asarray(got.tri_e2))
    np.testing.assert_array_equal(np.asarray(scene.tri_mat),
                                  np.asarray(got.tri_mat))
    np.testing.assert_array_equal(np.asarray(scene.tri_uv),
                                  np.asarray(got.tri_uv))

    # camera and lights round-trip bit-exactly too (idempotent f64
    # normalisation across builder/writer/loader — Camera.create,
    # prepare_scene, gltf._normalize share the rule), so the render
    # through the loaded scene is IDENTICAL to the procedural scene
    for k in ("position", "direction", "up", "fov"):
        np.testing.assert_array_equal(np.asarray(getattr(scene.camera, k)),
                                      np.asarray(getattr(got.camera, k)),
                                      err_msg=k)
    a = render_image(scene, 96, 64, shadows=True)
    b = render_image(got, 96, 64, shadows=True)
    assert np.abs(a - b).max() == 0.0


def test_default_scene_glb_roundtrip(tmp_path):
    """The reference demo scene's mesh/materials/light survive the writer →
    reader loop (spheres have no glTF encoding and are dropped)."""
    scene = build_default_scene()
    p = str(tmp_path / "default.glb")
    export_glb(scene, p)
    loaded = load_gltf(p)
    assert loaded.triangles.shape[0] == scene.mesh.num_triangles
    got = scene_from_gltf(p)
    np.testing.assert_array_equal(
        np.asarray(scene.materials.metallic_roughness_f16),
        np.asarray(got.materials.metallic_roughness_f16))
    np.testing.assert_array_equal(
        np.asarray(scene.materials.ior_transmission_f16),
        np.asarray(got.materials.ior_transmission_f16))
    np.testing.assert_allclose(np.asarray(scene.materials.emission),
                               np.asarray(got.materials.emission))
    assert int(np.asarray(got.lights.light_type).shape[0]) == 1


def test_export_missing_images_raises(tmp_path):
    scene = make_courtyard_scene(500, seed=0, textured=True)
    with pytest.raises(ValueError, match="source images"):
        export_glb(scene, str(tmp_path / "x.glb"))


def test_material_zoo_roundtrip(tmp_path):
    """Every exported material field survives the writer → reader loop:
    spec-gloss workflow, volume/specular extensions, spot lights."""
    import numpy as np

    from gpu_raytracer.models.camera import Camera
    from gpu_raytracer.models.geometry import Mesh, Spheres
    from gpu_raytracer.models.light import LightBuilder
    from gpu_raytracer.models.material import MaterialBuilder
    from gpu_raytracer.models.scene import prepare_scene

    mb = MaterialBuilder()
    mb.add(albedo=(0.8, 0.2, 0.1), metallic=0.3, roughness=0.7,
           emission=(0.1, 0.2, 0.3), ior=1.45, transmission=0.6,
           specular_factor=0.5, specular_color=(0.9, 0.8, 0.7),
           thickness_factor=0.25, attenuation_distance=3.5,
           attenuation_color=(0.5, 0.6, 0.7))
    mb.add_specular_glossiness((0.3, 0.4, 0.5), (0.6, 0.5, 0.4), 0.8)
    mb.add_glass((0.2, 0.3, 0.8), 1.52, 0.9)
    # a quad per material so every material is referenced
    verts, idx, mats = [], [], []
    for m in range(3):
        base = len(verts)
        verts += [[m * 3.0, 0, 0], [m * 3.0 + 1, 0, 0], [m * 3.0, 1, 0],
                  [m * 3.0 + 1, 1, 0]]
        idx += [[base, base + 1, base + 2], [base + 1, base + 3, base + 2]]
        mats += [m, m]
    mesh = Mesh.from_arrays(np.asarray(verts, np.float32),
                            np.asarray(idx, np.uint32),
                            np.asarray(mats, np.uint32))
    lb = LightBuilder()
    lb.add_spot((1.0, 5.0, 2.0), (0.1, -1.0, 0.0), (1.0, 0.8, 0.6), 3.0,
                12.0, 0.2, 0.6)
    lb.add_directional((0.0, -1.0, -0.3), (0.9, 0.9, 1.0), 1.2)
    scene = prepare_scene(Camera.create((0, 1, 8), (0, 0, -1), fov=50.0),
                          Spheres.from_rows([]), mesh, mb.build(),
                          lb.build())
    p = str(tmp_path / "zoo.glb")
    export_glb(scene, p)
    got = scene_from_gltf(p)
    m0, m1 = scene.materials, got.materials
    for f in ("metallic_roughness_f16", "ior_transmission_f16",
              "material_type", "texture_indices"):
        np.testing.assert_array_equal(np.asarray(getattr(m0, f)),
                                      np.asarray(getattr(m1, f)), err_msg=f)
    for f in ("albedo", "emission", "specular_factor", "specular_color",
              "thickness_factor", "attenuation_distance",
              "attenuation_color"):
        np.testing.assert_allclose(np.asarray(getattr(m0, f)),
                                   np.asarray(getattr(m1, f)), atol=1e-6,
                                   err_msg=f)
    # diffuse/glossiness are authoritative only in the spec-gloss workflow
    # (MR rows hold a 1-roughness convenience value that round-trips at f16
    # precision and is never shaded from)
    sg = np.asarray(m0.material_type) == 1
    for f in ("diffuse_factor", "glossiness_factor"):
        np.testing.assert_allclose(np.asarray(getattr(m0, f))[sg],
                                   np.asarray(getattr(m1, f))[sg],
                                   atol=1e-6, err_msg=f)
    l0, l1 = scene.lights, got.lights
    np.testing.assert_array_equal(np.asarray(l0.light_type),
                                  np.asarray(l1.light_type))
    np.testing.assert_array_equal(np.asarray(l0.range_packed),
                                  np.asarray(l1.range_packed))
    np.testing.assert_array_equal(np.asarray(l0.cone_angles_packed),
                                  np.asarray(l1.cone_angles_packed))


def test_cli_export_roundtrip(tmp_path):
    """`python -m gpu_raytracer export` writes a loadable .glb."""
    from gpu_raytracer.__main__ import main

    out = str(tmp_path / "demo.glb")
    main(["export", "--demo", "-o", out])
    got = scene_from_gltf(out)
    assert got.mesh.num_triangles == 2    # the demo scene's triangles
    out2 = str(tmp_path / "court.glb")
    main(["export", "--courtyard", "500", "--textured", "-o", out2])
    got2 = scene_from_gltf(out2)
    assert got2.textures.count == 3


def test_courtyard_glb_roundtrip_large_textures(tmp_path):
    """texture_size threads through to the source set (floor s, boxes s/2 —
    bench uses 4096 = 25.2 MTexel, past the >=16-MTexel criterion);
    the exported GLB round-trips to the identical mip atlas."""
    config = RaytracerConfig()
    scene = make_courtyard_scene(1000, seed=1, textured=True, config=config,
                                 texture_size=512)
    imgs = courtyard_source_images(1, texture_size=512)
    assert [i.shape[0] for i in imgs] == [512, 256, 256]
    p = str(tmp_path / "courtyard_big.glb")
    export_glb(scene, p, images=imgs)
    got = scene_from_gltf(p, config=config)
    np.testing.assert_array_equal(np.asarray(scene.textures.width),
                                  np.asarray(got.textures.width))
    np.testing.assert_array_equal(np.asarray(scene.textures.levels),
                                  np.asarray(got.textures.levels))
    np.testing.assert_array_equal(np.asarray(scene.textures.data_u32),
                                  np.asarray(got.textures.data_u32))
