"""Engine configuration.

A re-design of the reference's compile-time constant block
(`shared/src/lib.rs:17-35`, struct `RaytracerConfig`) promoted
to a real runtime dataclass + CLI, per SURVEY.md §5 ("config").

The reference hard-codes everything; we keep its *values* as defaults so that
parity tests agree, but every field is overridable at runtime.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class RaytracerConfig:
    # --- values mirrored from shared/src/lib.rs:20-34 ---
    tile_size: int = 128                 # TILE_SIZE
    camera_move_speed: float = 0.1       # CAMERA_MOVE_SPEED
    camera_rotate_sensitivity: float = 0.005  # CAMERA_ROTATE_SENSITIVITY
    min_ray_distance: float = 1e-5       # MIN_RAY_DISTANCE
    performance_stats_interval: int = 60  # PERFORMANCE_STATS_INTERVAL (frames)
    camera_pitch_clamp: float = 0.99     # CAMERA_PITCH_CLAMP

    # --- engine knobs (no reference equivalent: wgpu limits don't apply) ---
    # Most rays traced per device dispatch: a frame or path-trace pool up
    # to this size runs as one program, larger ones in chunks of it. 2^22
    # keeps a 1080p frame or a 2048² path-trace pool whole: on an H100
    # (80GB HBM3, 400 W limit) the whole 1080p shadowed frame rendered in
    # 2.8 ms against 4.1 ms in 128k-ray chunks, and a whole 1024² path-trace
    # sample in 10.6 ms against 424 ms.
    ray_batch_size: int = 1 << 22
    # BVH traversal stack depth (reference uses 64, shader/src/bvh.rs:35-38).
    bvh_stack_depth: int = 64
    # Max triangles referenced by one BVH leaf (static unroll bound on
    # device).
    bvh_leaf_size: int = 8
    # Wavefront path tracing.
    max_bounce_depth: int = 4            # PushConstants::new default (shared/src/lib.rs:1088)
    russian_roulette_start: int = 2      # rays ENTERING this bounce depth
                                         # are rouletted (PBRT start-of-
                                         # bounce semantics)
    # Samples traced per PathTracer.step() in ONE pooled wavefront: >1 makes
    # the pool spp-times larger, amortising launch/sort overhead and packing
    # same-pixel bounce rays into denser traversal packets
    # (engine/pathtracer.py::_sample_chunk).
    pathtrace_samples_per_step: int = 1
    # Bounce texture-LOD bias (ray-cone style): depth-d wavefront pools
    # sample the mip pyramid at level bias*d (clamped per texture; depth 0 —
    # directly visible surfaces — always samples level 0 / full sharpness).
    # The prefiltered texel is the physically better estimate for a widened
    # secondary ray cone. 0.0 = off (level 0 everywhere).
    bounce_lod_bias: float = 0.0
    # Texture mip pyramid: max levels built at scene load (1 = off). With
    # mips on, samplers pick a per-lane nearest mip from the primary hit
    # footprint, so minification stops aliasing.
    texture_mips: int = 8
    # SBVH-style chopped spatial splits in the host builder: duplicates
    # straddling triangle references across leaves with clipped bounds,
    # cutting node overlap on content with large spanning triangles. Costs
    # build time + up to ~35% more leaf-table slots; off by default.
    bvh_spatial_splits: bool = False
    # Trilinear mip filtering (two-level lerp) in the texture sampler:
    # kills nearest-mip level-boundary banding at the cost of a second
    # fetch per map. Off by default.
    texture_trilinear: bool = False
    # Rendering precision for the compute path.
    dtype: str = "float32"

    def replace(self, **kw) -> "RaytracerConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RaytracerConfig()


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Register every config field as a CLI flag (--tile-size etc.)."""
    for f in dataclasses.fields(RaytracerConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=f.default)
        else:
            parser.add_argument(flag, type=type(f.default), default=f.default)


def config_from_args(args: argparse.Namespace) -> RaytracerConfig:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(RaytracerConfig)
          if hasattr(args, f.name)}
    return RaytracerConfig(**kw)
