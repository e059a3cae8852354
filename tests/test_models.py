"""Scene data-model tests: builders, packing, dedup, default scene."""

import numpy as np

from gpu_raytracer import build_default_scene, dedup_triangles, memory_stats
from gpu_raytracer.models.material import MaterialBuilder, NO_TEXTURE
from gpu_raytracer.models.light import LightBuilder
from gpu_raytracer.ops.f16 import unpack_f16_pair_host


def test_material_constructors_match_reference_semantics():
    """Material::diffuse/metallic/glass/emissive (shared/src/lib.rs:314-332)."""
    mb = MaterialBuilder()
    mb.add_diffuse((0.8, 0.3, 0.3))
    mb.add_metallic((0.8, 0.8, 0.2), 0.1)
    mb.add_glass((0.2, 0.3, 0.8), 1.5, 0.9)
    mb.add_emissive((1.0, 1.0, 1.0), (0.5, 0.5, 1.0))
    m = mb.build()

    met, rough = unpack_f16_pair_host(np.asarray(m.metallic_roughness_f16))
    ior, trans = unpack_f16_pair_host(np.asarray(m.ior_transmission_f16))
    np.testing.assert_allclose(met, [0.0, 1.0, 0.0, 0.0])
    np.testing.assert_allclose(rough, np.float32(np.float16([1.0, 0.1, 0.0, 1.0])))
    np.testing.assert_allclose(ior, [1.5, 1.5, 1.5, 1.5])
    np.testing.assert_allclose(trans, np.float32(np.float16([0.0, 0.0, 0.9, 0.0])))
    # glossiness defaults to 1 - f16(roughness) — derived from the
    # QUANTISED roughness so a GLB round trip (which re-derives it from
    # the decoded f16) reproduces it bit-exactly
    np.testing.assert_allclose(
        np.asarray(m.glossiness_factor),
        1.0 - np.float32(np.float16([1.0, 0.1, 0.0, 1.0])), atol=1e-7)
    np.testing.assert_allclose(np.asarray(m.diffuse_factor)[0], [0.8, 0.3, 0.3])
    assert (np.asarray(m.texture_indices) == NO_TEXTURE).all()
    assert (np.asarray(m.material_type) == 0).all()


def test_specular_glossiness_material_type():
    mb = MaterialBuilder()
    mb.add_specular_glossiness((0.5, 0.5, 0.5), (1.0, 0.9, 0.8), 0.7)
    m = mb.build()
    assert int(np.asarray(m.material_type)[0]) == 1
    np.testing.assert_allclose(np.asarray(m.glossiness_factor)[0], 0.7)


def test_light_builder_types():
    lb = LightBuilder()
    lb.add_directional((0, -1, 0), (1, 1, 1), 2.0)
    lb.add_point((1, 2, 3), (1, 0, 0), 1.0, 10.0)
    lb.add_spot((0, 5, 0), (0, -1, 0), (1, 1, 1), 3.0, 20.0, 0.2, 0.5)
    L = lb.build()
    assert list(np.asarray(L.light_type)) == [0, 1, 2]
    rng, _ = unpack_f16_pair_host(np.asarray(L.range_packed))
    assert np.isinf(rng[0]) and rng[1] == 10.0 and rng[2] == 20.0
    inner, outer = unpack_f16_pair_host(np.asarray(L.cone_angles_packed))
    np.testing.assert_allclose([inner[2], outer[2]],
                               np.float32(np.float16([0.2, 0.5])))


def test_dedup_triangles_shared_vertices():
    """TriangleLegacy::to_indexed semantics (shared/src/lib.rs:688-749):
    bit-identical positions collapse to one vertex."""
    tris = np.array([
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
        [[1, 0, 0], [0, 1, 0], [1, 1, 0]],  # shares 2 vertices with tri 0
    ], np.float32)
    v, idx, mat = dedup_triangles(tris, np.array([0, 1], np.uint32))
    assert v.shape == (4, 3)
    assert idx.shape == (2, 3)
    # first-appearance ordering
    np.testing.assert_array_equal(v[idx[0]], tris[0])
    np.testing.assert_array_equal(v[idx[1]], tris[1])


def test_default_scene_shapes(default_scene):
    s = default_scene
    assert s.spheres.count == 6
    assert s.mesh.num_triangles == 2
    assert s.mesh.num_vertices == 6  # 2 disjoint triangles, no shared verts
    assert s.materials.count == 4
    assert s.lights.count == 1
    stats = memory_stats(s)
    assert stats["total_bytes"] > 0
    assert stats["triangles"] == 2


def test_camera_controller_semantics(default_scene):
    """input.rs:49-97: yaw on XZ, clamped pitch, WASD moves."""
    from gpu_raytracer import CameraController

    cc = CameraController(default_scene.camera)
    p0 = cc.position.copy()
    cc.move(forward=1.0)
    np.testing.assert_allclose(cc.position, p0 + np.array([0, 0, -1]) * 0.1, atol=1e-6)
    cc.move(strafe=1.0)  # right = dir × up = (-1,0,0)... check unit length
    assert abs(np.linalg.norm(cc.direction) - 1.0) < 1e-6
    cc.rotate(100.0, 0.0)
    assert abs(np.linalg.norm(cc.direction) - 1.0) < 1e-6
    # pitch clamp
    for _ in range(100):
        cc.rotate(0.0, -1000.0)
    assert cc.direction[1] <= 0.995


def test_courtyard_scene_is_a_real_workload():
    """Guard against benchmark-scene degeneration: at the bench scale the
    box grid must NOT merge into a solid wall around the camera (which once
    made every camera ray terminate ~5cm in and the benchmark trivial)."""
    import jax.numpy as jnp
    from gpu_raytracer.utils.procgen import make_courtyard_scene
    from gpu_raytracer.ops.camera_rays import generate_rays
    from gpu_raytracer.ops.trace import trace

    scene = make_courtyard_scene(100_000, seed=0)
    W, H = 32, 18
    py, px = np.mgrid[0:H, 0:W]
    o, d = generate_rays(scene.camera, W, H,
                         jnp.asarray(px.reshape(-1).astype(np.int32)),
                         jnp.asarray(py.reshape(-1).astype(np.int32)))
    h = trace(scene, o, d)
    t = np.asarray(h.t)[np.asarray(h.hit)]
    mats = np.unique(np.asarray(h.material_id)[np.asarray(h.hit)])
    assert t.max() / max(t.min(), 1e-3) > 20      # depth variety
    assert len(mats) >= 3                         # material variety
