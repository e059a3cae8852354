"""Device mesh construction for multi-device rendering.

The reference is strictly single-GPU (SURVEY.md §2.4); this is the scaling
layer it never had: a 1-D `jax.sharding.Mesh` over which ray batches (data
parallel) and/or scene geometry (model parallel) are sharded with
`shard_map`; XLA hands the combine collectives to NCCL on GPUs.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (RAY_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ray_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(RAY_AXIS))
