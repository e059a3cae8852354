"""Performance observability.

The reference's timing dashboards re-expressed for JAX: frame FPS every N
frames (src/renderer.rs:857-893), per-frame buffer-update vs
compute timing (`TimingBreakdown`, renderer.rs:50-70), per-tile accumulation
with P50/P95/P99 percentiles and the completion summary
(src/compute.rs:253-363). The Mrays/s derivation keeps the
reference's definition: 1 tile = 128×128 px × 3 channels = 49,152 primary
rays (SURVEY.md §6). Unlike the reference — which measures only command
*submission* (acknowledged in compute.rs:77) — timings here block on device
completion, so they are true execution times.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

RAYS_PER_TILE = 128 * 128 * 3  # shared/src/lib.rs:21 + 3 channel passes


def percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(len(sorted_vals) * p), len(sorted_vals) - 1)
    return sorted_vals[idx]


@dataclass
class TimingBreakdown:
    """Per-frame phase timing (renderer.rs:50-70)."""

    scene_update_ms: float = 0.0
    compute_ms: float = 0.0
    total_frame_ms: float = 0.0


@dataclass
class ProgressiveTiming:
    """Accumulates per-tile times across a progressive pass
    (renderer.rs:81-90, summary compute.rs:319-363)."""

    tile_times_ms: list = field(default_factory=list)
    start_time: float = field(default_factory=time.perf_counter)
    rays_per_tile: int = RAYS_PER_TILE

    def record_tile(self, ms: float) -> None:
        self.tile_times_ms.append(ms)

    def summary(self) -> dict:
        ts = sorted(self.tile_times_ms)
        total_s = time.perf_counter() - self.start_time
        n = len(ts)
        tiles_per_s = n / total_s if total_s > 0 else 0.0
        return {
            "tiles": n,
            "total_s": total_s,
            "tiles_per_s": tiles_per_s,
            "mrays_per_s": tiles_per_s * self.rays_per_tile / 1e6,
            "p50_ms": percentile(ts, 0.50),
            "p95_ms": percentile(ts, 0.95),
            "p99_ms": percentile(ts, 0.99),
        }

    def print_summary(self) -> None:
        s = self.summary()
        print(f"=== Progressive pass complete: {s['tiles']} tiles in "
              f"{s['total_s']:.2f}s ({s['tiles_per_s']:.1f} tiles/s, "
              f"{s['mrays_per_s']:.1f} Mrays/s) ===")
        print(f"    tile times p50={s['p50_ms']:.2f}ms "
              f"p95={s['p95_ms']:.2f}ms p99={s['p99_ms']:.2f}ms")


class PerformanceState:
    """Frame counter + FPS print every `interval` frames
    (renderer.rs:857-893)."""

    def __init__(self, interval: int = 60, verbose: bool = True):
        self.interval = interval
        self.verbose = verbose
        self.frame_count = 0
        self._window_start = time.perf_counter()
        self.last_fps = 0.0

    def update_frame_count(self) -> None:
        self.frame_count += 1
        if self.frame_count % self.interval == 0:
            now = time.perf_counter()
            dt = now - self._window_start
            self.last_fps = self.interval / dt if dt > 0 else 0.0
            self._window_start = now
            if self.verbose:
                print(f"FPS: {self.last_fps:.1f} "
                      f"({1000.0 / max(self.last_fps, 1e-9):.2f} ms/frame)")


class Timer:
    """Context manager measuring wall ms, blocking on a device value."""

    def __init__(self):
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1000.0
        return False


class DeviceProfiler:
    """jax.profiler wrapper: captures an XLA device trace viewable in
    TensorBoard or Perfetto — the device-timeline upgrade over the
    reference's host-side wall-clock instrumentation (SURVEY.md §5
    "No GPU timestamps").

        with DeviceProfiler("/tmp/rt_trace"):
            renderer.render_device()
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        import jax

        jax.profiler.start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        import jax

        jax.profiler.stop_trace()
        return False
