"""Progressive tile scheduler + perf machinery tests."""

import numpy as np

from gpu_raytracer.engine.perf import (
    PerformanceState, ProgressiveTiming, percentile,
)
from gpu_raytracer.engine.progressive import ProgressiveState, TileHelper


def test_tile_count_ceil_div():
    assert TileHelper.calculate_tile_count(1920, 1080, 128) == (15, 9)
    assert TileHelper.calculate_tile_count(128, 128, 128) == (1, 1)
    assert TileHelper.calculate_tile_count(129, 1, 128) == (2, 1)


def test_tiles_per_frame_schedule():
    """shared/src/lib.rs:1195-1203 case arms, including the max(1)."""
    assert TileHelper.calculate_tiles_per_frame(0) == 1
    assert TileHelper.calculate_tiles_per_frame(10) == 10
    assert TileHelper.calculate_tiles_per_frame(16) == 16
    assert TileHelper.calculate_tiles_per_frame(17) == 2
    assert TileHelper.calculate_tiles_per_frame(64) == 8
    assert TileHelper.calculate_tiles_per_frame(65) == 2
    assert TileHelper.calculate_tiles_per_frame(256) == 8
    assert TileHelper.calculate_tiles_per_frame(257) == 4
    assert TileHelper.calculate_tiles_per_frame(1024) == 16
    assert TileHelper.calculate_tiles_per_frame(4000) == 1


def test_progressive_state_cursor():
    ps = ProgressiveState(512, 512)  # 4x4 = 16 tiles -> all in one frame
    assert ps.total_tiles == 16
    tiles = ps.next_tiles()
    assert tiles == list(range(16))
    assert ps.complete
    assert ps.next_tiles() == []
    ps.trigger_recompute()
    assert not ps.complete
    assert ps.current_tile == 0


def test_tile_rect_clamps_edges():
    ps = ProgressiveState(300, 200)  # tiles_x=3, tiles_y=2
    assert ps.tile_rect(0, 300, 200) == (0, 0, 128, 128)
    assert ps.tile_rect(2, 300, 200) == (256, 0, 44, 128)
    assert ps.tile_rect(5, 300, 200) == (256, 128, 44, 72)


def test_percentiles_and_summary():
    t = ProgressiveTiming()
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        t.record_tile(v)
    s = t.summary()
    assert s["tiles"] == 5
    assert s["p50_ms"] == 3.0
    assert s["p99_ms"] == 100.0
    assert s["mrays_per_s"] >= 0
    assert percentile([], 0.5) == 0.0


def test_performance_state_counts():
    ps = PerformanceState(interval=2, verbose=False)
    ps.update_frame_count()
    ps.update_frame_count()
    assert ps.frame_count == 2
    assert ps.last_fps > 0
