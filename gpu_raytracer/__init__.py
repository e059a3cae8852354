"""gpu_raytracer — a ray-tracing engine in JAX/XLA/Pallas for NVIDIA GPUs.

A framework with the capabilities of the Rust/wgpu reference
`kije/gpu_raytracer`, re-architected around
JAX: wavefront ray batches over a pytree-of-SoA scene in device memory, a
Pallas BVH traversal kernel, fused single-pass 3-channel shading,
`shard_map` multi-device sharding. See SURVEY.md for the reference analysis and layer map.
"""

from .config import RaytracerConfig, DEFAULT_CONFIG
from .models.camera import Camera, CameraController
from .models.scene import Scene, prepare_scene, build_default_scene, memory_stats
from .models.geometry import Mesh, Spheres, Textures, dedup_triangles
from .models.material import Materials, MaterialBuilder
from .models.light import Lights, LightBuilder
from .models.bvh import Bvh, build_bvh
from .models.gltf import (GltfLoader, load_gltf, scene_from_gltf,
                          scene_from_gltf_or_default)
from .engine.renderer import Renderer, render_image, render_chunk
from .engine.pathtracer import PathTracer, render_pathtraced
from .engine.viewer import Viewer

__version__ = "0.1.0"

__all__ = [
    "RaytracerConfig", "DEFAULT_CONFIG",
    "Camera", "CameraController",
    "Scene", "prepare_scene", "build_default_scene", "memory_stats",
    "Mesh", "Spheres", "Textures", "dedup_triangles",
    "Materials", "MaterialBuilder", "Lights", "LightBuilder",
    "Bvh", "build_bvh",
    "GltfLoader", "load_gltf", "scene_from_gltf", "scene_from_gltf_or_default",
    "Renderer", "render_image", "render_chunk",
    "PathTracer", "render_pathtraced", "Viewer",
]
