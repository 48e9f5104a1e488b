"""Region-streamed scene construction (BASELINE.json config 5).

The reference uploads whole-scene buffers once at startup plus incremental
dirty ranges (StagingRamp); scenes larger than host build time or device
transfer patience stream region by region instead. `terrain_regions`
generates a world in X-slab regions on the host, and `stream_into_engine`
applies them to the device-resident arrays through the engine's edit path
(`VoxelRT.insert_voxels`), the one the interactive editor uses; the
renderer can draw between regions, so a large world fades in while staying
interactive. A numpy copy of `zig_vulkan_tpu.io.streaming`.

Streaming is about construction and transfer pacing, not capacity: the
sparse arrays of a 1024^3-voxel scene fit the card outright. Capacity
streaming (brick residency eviction) is roadmap.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from ..core.grid import BrickGrid
from ..io import terrain as terrain_mod


def terrain_regions(grid: BrickGrid, seed: int = 420, scale: float = 4.0,
                    ocean_level: int = 20, region_x: int = 64
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (xyz int32[N,3], materials uint8[N]) per X-slab region.

    Same algorithm as io.terrain.generate (reference terrain.zig:80-109)
    but emitted incrementally per slab.
    """
    perlin = terrain_mod.PerlinNoise(seed)
    vx, vy, vz = grid.static.voxel_dims
    terrain_max_height = vy * 0.5
    ocean_level = min(int(ocean_level), vy)

    for x0 in range(0, vx, region_x):
        x1 = min(vx, x0 + region_x)
        xs, zs = np.meshgrid(np.arange(x0, x1), np.arange(vz), indexing="ij")
        points = np.stack(
            [xs * (scale / vx), np.zeros_like(xs, dtype=np.float64),
             zs * (scale / vz)], axis=-1)
        heights = (np.minimum(perlin.smooth_noise(points), 1.0)
                   * terrain_max_height).astype(np.int64)
        col_top = np.maximum(heights, ocean_level)
        col_bot = heights // 2
        counts = np.maximum(col_top - col_bot, 0)
        total = int(counts.sum())
        if total == 0:
            continue
        cx = np.repeat(xs.ravel(), counts.ravel())
        cz = np.repeat(zs.ravel(), counts.ravel())
        ch = np.repeat(heights.ravel(), counts.ravel())
        cb = np.repeat(col_bot.ravel(), counts.ravel())
        offs = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(counts.ravel())[:-1]]), counts.ravel())
        cy = cb + offs
        solid = cy < ch
        hl = 1.0 + 2.4 * (cy / terrain_max_height)
        band = np.clip(np.floor(
            hl + terrain_mod._rolls(seed, cx, cy, cz) * 0.5), 0, 3).astype(np.int64)
        pick = np.round(
            terrain_mod._rolls(seed ^ 0x5BD1E995, cx, cy, cz)).astype(np.int64)
        base = np.asarray([0, 1, 3, 5], dtype=np.int64)[band]
        mat = np.where((band > 0) & solid, base + pick, 0).astype(np.uint8)
        xyz = np.stack([cx, cy, cz], axis=-1).astype(np.int32)
        yield xyz, mat


def stream_into_engine(engine, regions: Iterator[Tuple[np.ndarray, np.ndarray]],
                       draw_between: bool = False,
                       max_batch: int = 262144,
                       progress: Optional[Callable[[int], None]] = None) -> int:
    """Apply regions through the engine's edit path, at most `max_batch`
    voxels per `insert_voxels` call.

    Returns total voxels streamed. With draw_between=True a frame is drawn
    after each region (the interactive fade-in behavior); the engine then
    keeps its records and refreshes them after every batch.
    """
    total = 0
    for xyz, mat in regions:
        for i in range(0, xyz.shape[0], max_batch):
            engine.insert_voxels(xyz[i:i + max_batch], mat[i:i + max_batch])
            total += min(max_batch, xyz.shape[0] - i)
        if draw_between:
            engine.render()
        if progress is not None:
            progress(total)
    return total
