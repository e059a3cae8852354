"""The frame pipeline (engine/renderer.py::render_chunk) through the GPU
kernel branch of ops/trace.py — the traversal kernel interpreted — against
the XLA branch, over the scene features a frame can carry."""

import numpy as np
import jax.numpy as jnp
import pytest

from kernel_branch import kernel_branch
from gpu_raytracer.engine.renderer import render_chunk
from gpu_raytracer.ops.packet_trace import tiled_pixel_order

W, H = 48, 32


def _scene(feature):
    from gpu_raytracer import build_default_scene
    from gpu_raytracer.utils.procgen import make_courtyard_scene

    if feature in ("spheres", "spheres_shadowed"):
        return build_default_scene()
    if feature == "many_lights":
        return make_courtyard_scene(1500, seed=3, lights=64)
    if feature in ("mips", "trilinear"):
        return make_courtyard_scene(1500, seed=1, textured=True)
    return make_courtyard_scene(1500, seed=2)


@pytest.mark.parametrize("feature", ["plain", "shadows", "many_lights",
                                     "spheres", "spheres_shadowed", "sky",
                                     "mips", "trilinear"])
def test_frame_kernel_branch_matches_xla(feature):
    scene = _scene(feature)
    px, py = tiled_pixel_order(W, H, tile=16)
    px, py = jnp.asarray(px), jnp.asarray(py)
    kw = dict(shadows=feature in ("shadows", "many_lights",
                                  "spheres_shadowed", "mips", "trilinear"),
              leaf_size=scene.bvh.max_leaf,
              sky=(0.1, 0.2, 0.3) if feature == "sky" else (0.0, 0.0, 0.0),
              trilinear=feature == "trilinear")
    want = np.asarray(render_chunk(scene, px, py, W, H, **kw))
    with kernel_branch():
        got = np.asarray(render_chunk(scene, px, py, W, H, **kw))
    assert np.isfinite(got).all() and want.max() > 0.0
    np.testing.assert_allclose(got, want, atol=1e-5)
