"""Pytree dataclass helper.

Every scene/engine data structure in this framework is a frozen dataclass
registered as a JAX pytree, so whole scenes can be `jax.device_put`, donated,
sharded, and passed through `jit` boundaries as first-class values — the
replacement for the reference's hand-packed GPU storage buffers
(`src/buffers.rs:157-271`).
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls=None, *, meta_fields: tuple[str, ...] = ()):
    """Decorator: frozen dataclass registered as a JAX pytree.

    ``meta_fields`` are static (hashed into the jit cache key) — use for
    Python-level config, never for arrays.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        )
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=tuple(meta_fields)
        )
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)
