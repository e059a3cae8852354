"""The disk-cached courtyard atlas build (utils/procgen.py::
courtyard_textures) must restore bit-exactly and respect the env
override / disable switch."""

import os

import numpy as np
import pytest

from gpu_raytracer.utils.procgen import courtyard_textures


def _fields(tex):
    import dataclasses
    return {f.name: np.asarray(getattr(tex, f.name))
            for f in dataclasses.fields(type(tex)) if f.name != "n_levels"}


def test_cache_round_trip_bit_exact(tmp_path, monkeypatch):
    monkeypatch.setenv("GPU_RAYTRACER_CACHE", str(tmp_path))
    a = courtyard_textures(3, 1024, mips=4, budget_rows=4096)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".npz"
    b = courtyard_textures(3, 1024, mips=4, budget_rows=4096)
    assert a.n_levels == b.n_levels
    for k, v in _fields(a).items():
        np.testing.assert_array_equal(v, _fields(b)[k], err_msg=k)


def test_cache_key_separates_params(tmp_path, monkeypatch):
    monkeypatch.setenv("GPU_RAYTRACER_CACHE", str(tmp_path))
    courtyard_textures(3, 1024, mips=4, budget_rows=4096)
    courtyard_textures(4, 1024, mips=4, budget_rows=4096)
    assert len(list(tmp_path.iterdir())) == 2


def test_cache_disabled_and_small_sizes_skip(tmp_path, monkeypatch):
    monkeypatch.setenv("GPU_RAYTRACER_CACHE", "")
    courtyard_textures(3, 1024, mips=4, budget_rows=4096)
    monkeypatch.setenv("GPU_RAYTRACER_CACHE", str(tmp_path))
    courtyard_textures(3, 128, mips=4, budget_rows=4096)   # below threshold
    assert list(tmp_path.iterdir()) == []


def test_corrupt_cache_falls_back_to_build(tmp_path, monkeypatch):
    monkeypatch.setenv("GPU_RAYTRACER_CACHE", str(tmp_path))
    a = courtyard_textures(3, 1024, mips=4, budget_rows=4096)
    (f,) = tmp_path.iterdir()
    f.write_bytes(b"not an npz")
    b = courtyard_textures(3, 1024, mips=4, budget_rows=4096)
    for k, v in _fields(a).items():
        np.testing.assert_array_equal(v, _fields(b)[k], err_msg=k)
