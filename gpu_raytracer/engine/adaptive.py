"""Adaptive progressive path tracing: variance-guided sample allocation.

The reference's progressive machinery spends every frame's budget
uniformly (one tile pass per dispatch, src/compute.rs
tile scheduling); its wavefront design has no error feedback at all.
This engine re-allocates each step's fixed traversal budget (K tiles x
4096 lanes — static shapes, so ONE compiled program serves every step)
to the 64x64 tiles with the highest estimated error of the mean:

    score(tile) = mean over pixels of  sqrt(Var[mean]) / (mean + 0.05)

with Var[mean] = (E[l^2] - E[l]^2) / n from per-pixel luminance moment
accumulators. The first ceil(T/K) steps sweep tiles round-robin (every
pixel needs a variance seed); from then on each step is a `lax.top_k`
over the T tile scores. Selection, coordinate gather, pool trace and
the scatter-add back into the accumulators all run inside one jit with
the three accumulators donated — the same single-dispatch discipline as
engine/pathtracer._step_whole_frame.

Estimator: each pixel's value is the plain mean of its own samples
(accum / count) — sample counts vary per pixel but every sample is an
unbiased radiance estimate, so the per-pixel mean stays unbiased
regardless of WHICH tiles were refined (the selection depends only on
other samples' values, not the new sample's). The QMC stream is not
used here: adaptive selection makes a pixel's sample indices an
irregular subset, which forfeits lattice stratification — the pool runs
the independent threefry stream instead (sampler design notes:
ops/sampler.py).

Works on whole 64x64 tiles (width/height must be multiples of 64, like
the BASELINE config-3 1024x1024 target): tiles are contiguous
4096-pixel blocks of the tile-major accumulator, so a selected tile is
one coherent traversal packet and its scatter rows are a broadcasted
iota — no per-pixel index tables.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.scene import Scene
from .pathtracer import PathTracer, _sample_chunk

TILE = 64
TILE_PX = TILE * TILE  # 4096


@partial(jax.jit,
         static_argnames=("K", "T", "width", "height", "channel",
                          "max_depth", "rr_start", "shadows", "leaf_size",
                          "use_bvh", "antialias", "adaptive_from"),
         donate_argnums=(1, 2, 3))
def _adaptive_step(scene: Scene, accum, accum_sq, counts, key, g, px_t,
                   py_t, *, K: int, T: int, width: int, height: int,
                   channel: int, max_depth: int, rr_start: int,
                   shadows: bool, leaf_size: int, use_bvh: bool,
                   antialias: bool, adaptive_from: int):
    """One adaptive step as ONE compiled program (accumulators donated).

    g is the traced step counter; steps < adaptive_from sweep tiles
    round-robin (variance seeding), later steps take the top-K error
    tiles. Returns (accum, accum_sq, counts, per-depth actives)."""
    n = jnp.maximum(counts.astype(jnp.float32), 1.0)
    lum = accum.mean(axis=-1)                       # [C] summed luminance
    mean = lum / n
    var = jnp.maximum(accum_sq / n - mean * mean, 0.0)
    score_px = jnp.sqrt(var / n) / (mean + 0.05)    # rel. error of the mean
    score_tile = score_px.reshape(T, TILE_PX).mean(axis=-1)
    # n < 2 makes the sample variance identically zero (first measured
    # failure mode: after a 1-pass warmup every score ties at 0, top_k
    # picks the same first K tiles forever and the rest plateau at 1-spp
    # noise — MSE stuck 36x above uniform). Score unseeded tiles +inf...
    n_tile = counts.reshape(T, TILE_PX)[:, 0].astype(jnp.float32)
    score_tile = jnp.where(n_tile < 2.0, jnp.float32(1e9), score_tile)

    # ...and reserve a quarter of every adaptive step for a round-robin
    # sweep: variance estimates UNDERSTATE error wherever a rare path
    # hasn't been sampled yet (a glass caustic a 2-spp tile never saw),
    # so pure top-k can starve tiles on a wrong estimate; the sweep
    # bounds every tile's revisit interval. Duplicate selections are
    # fine — scatter-add accumulates per occurrence.
    K_RR = 0 if K == 1 else max(1, K // 4)   # K=1: degenerate, pure top-k
    K_TK = K - K_RR
    sel_warm = (g * K + jnp.arange(K, dtype=jnp.int32)) % T
    rr = (g * K_RR + jnp.arange(K_RR, dtype=jnp.int32)) % T
    _, tk = jax.lax.top_k(score_tile, K_TK)
    sel = jnp.where(g >= adaptive_from,
                    jnp.concatenate([rr, tk.astype(jnp.int32)]), sel_warm)

    rows = (sel[:, None] * TILE_PX
            + jnp.arange(TILE_PX, dtype=jnp.int32)[None, :]).reshape(-1)
    px = px_t[rows]
    py = py_t[rows]
    skey = jax.random.fold_in(key, g)
    jitter = (jax.random.uniform(skey, (rows.shape[0], 2))
              if antialias else None)
    contrib, depth_counts = _sample_chunk(
        scene, px, py, width, height, skey, channel, max_depth, rr_start,
        shadows, leaf_size, use_bvh, jitter, None, spp=1)
    accum = accum.at[rows].add(contrib)
    accum_sq = accum_sq.at[rows].add(contrib.mean(axis=-1) ** 2)
    counts = counts.at[rows].add(1)
    return accum, accum_sq, counts, depth_counts


class AdaptivePathTracer(PathTracer):
    """PathTracer whose step() refines the K highest-error tiles.

    `samples` reports the AVERAGE spp (total samples / pixels) so the
    Viewer/denoiser heuristics keep working; per-pixel counts live in
    `self.counts`.
    """

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RaytracerConfig = DEFAULT_CONFIG,
                 tiles_per_step: int = 16, **kw):
        if width % TILE or height % TILE:
            raise ValueError(
                f"adaptive sampling works on whole {TILE}x{TILE} tiles: "
                f"{width}x{height} is not a multiple of {TILE}")
        kw.setdefault("sampler", "rng")  # see module docstring
        super().__init__(scene, width, height, config=config, **kw)
        self.T = (width // TILE) * (height // TILE)
        self.K = max(1, min(int(tiles_per_step), self.T))
        # TWO full sweeps before the error signal takes over: the sample
        # variance needs n >= 2 per pixel to be nonzero at all
        self.adaptive_from = 2 * (-(-self.T // self.K))   # ceil
        self.accum_sq = jnp.zeros((height * width,), jnp.float32)
        self.counts = jnp.zeros((height * width,), jnp.int32)
        self._steps = 0

    @property
    def samples(self) -> float:
        if self._steps == 0:
            return 0
        return float(self._steps * self.K * TILE_PX) / self.accum.shape[0]

    @samples.setter
    def samples(self, v):   # PathTracer.__init__/reset assign 0
        if not getattr(self, "K", 0) or not v:
            self._steps = 0
        else:  # average spp -> step count
            self._steps = int(round(float(v) * self.accum.shape[0]
                                    / (self.K * TILE_PX)))

    def reset(self) -> None:
        super().reset()
        self.accum_sq = jnp.zeros_like(self.accum_sq)
        self.counts = jnp.zeros_like(self.counts)
        self._steps = 0

    def _n_total(self) -> "jnp.ndarray":
        n = self.counts.astype(jnp.float32)
        if self._count_base is not None:
            n = n + self._count_base
        return n

    def set_camera(self, camera, temporal: bool = False) -> None:
        """Temporal warp folds the reprojected history into the adaptive
        accumulators: counts <- round(n0) and accum_sq <- n0 * mean_lum²
        (the history's own variance is unknown, so it seeds at zero —
        an underestimate the reserved round-robin sweep corrects)."""
        super().set_camera(camera, temporal=temporal)
        if temporal and self._count_base is not None:
            n0 = self._count_base
            self.counts = jnp.round(n0).astype(jnp.int32)
            mean_lum = (self.accum.mean(axis=-1)
                        / jnp.maximum(n0, 1.0))
            self.accum_sq = n0 * mean_lum * mean_lum
            self._count_base = None     # adaptive reads self.counts
            self._steps = 0

    def step(self) -> None:
        from ..ops.wavefront import RGB_CHANNEL

        self._last_counts = None
        self._last_seed = self._steps
        chan = RGB_CHANNEL if self.spectral else 1
        (self.accum, self.accum_sq, self.counts,
         self._last_counts) = _adaptive_step(
            self.scene, self.accum, self.accum_sq, self.counts, self.key,
            jnp.int32(self._steps), self._px, self._py,
            K=self.K, T=self.T, width=self.width, height=self.height,
            channel=chan, max_depth=self.config.max_bounce_depth,
            rr_start=self.config.russian_roulette_start,
            shadows=self.shadows, leaf_size=self.config.bvh_leaf_size,
            use_bvh=self.use_bvh, antialias=self.antialias,
            adaptive_from=self.adaptive_from)
        self._steps += 1
        self.perf.update_frame_count()

    def image(self) -> np.ndarray:
        n = np.maximum(np.asarray(self.counts), 1)[:, None]
        flat = np.asarray(self.accum) / n
        fb = np.zeros((self.height, self.width, 3), np.float32)
        fb[self._py_host, self._px_host] = flat
        return fb

    def _inv_n(self):
        # the à-trous/image jits broadcast (accum * inv_samples): a [C,1]
        # per-pixel inverse count works in place of the uniform scalar
        return (1.0 / jnp.maximum(self.counts.astype(jnp.float32), 1.0)
                )[:, None]

    def save_checkpoint(self, path: str) -> None:
        np.savez_compressed(
            path,
            accum=np.asarray(self.accum),
            accum_sq=np.asarray(self.accum_sq),
            counts=np.asarray(self.counts),
            samples=self._steps,
            width=self.width,
            height=self.height,
            camera_position=np.asarray(self.scene.camera.position),
            camera_direction=np.asarray(self.scene.camera.direction),
            camera_up=np.asarray(self.scene.camera.up),
            camera_fov=np.asarray(self.scene.camera.fov),
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        assert (int(data["width"]) == self.width
                and int(data["height"]) == self.height), \
            "checkpoint resolution mismatch"
        self.accum = jnp.asarray(data["accum"])
        self.accum_sq = jnp.asarray(data["accum_sq"])
        self.counts = jnp.asarray(data["counts"])
        self._steps = int(data["samples"])
