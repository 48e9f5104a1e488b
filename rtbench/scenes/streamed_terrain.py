"""Scene generator `streamed_terrain`: the reference app's perlin terrain
streamed into an empty grid in x-slabs (this repo's BASELINE config 5, as
`zig_vulkan_tpu_torch/benchmarks/configs.py:build_config5` builds it with
`io/streaming.py`), made with the reference's frozen copy of the port's
scene code.

The configuration's "scene" entry is `default_scene`'s without the model,
plus "region_x" (the slab's width in voxels, `terrain_regions`'
`region_x`) and "max_batch" (the most voxels a batch inserts,
`stream_into_engine`'s `max_batch`). `regions` is a copy of the port's
`io/streaming.py:terrain_regions` over `rtbench.ref.io.terrain`'s noise and
rolls; `build` writes its slabs, batch by batch in `stream_into_engine`'s
order, into a `rtbench.ref` `BrickGrid`, so the file holds the streamed
brick layout: a cell's brick index grows with the slab and batch that first
wrote it.

Within a batch the engine's insert (`core/grid.py:apply_edits`,
`csrc/edit.cu`) numbers the new bricks and their material windows in cell
order, and `BrickGrid.insert_batch` numbers them in order of first
appearance; each batch therefore goes in sorted by cell (the terrain gives
each voxel once, so the order changes nothing else), and the arrays equal
those `build_config5` streams, array for array.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from rtbench.ref.config import GridConfig
from rtbench.ref.core.grid import BrickGrid, grid_at
from rtbench.ref.core.materials import terrain_materials
from rtbench.ref.io import terrain


def regions(static, seed: int, scale: float, ocean_level: int,
            region_x: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (xyz int64[N, 3], materials uint8[N]) of each x-slab of
    `region_x` voxels, in x order (`terrain_regions`, voxel for voxel)."""
    perlin = terrain.PerlinNoise(seed)
    vx, vy, vz = static.voxel_dims
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
        counts = np.maximum(col_top - col_bot, 0).ravel()
        total = int(counts.sum())
        if total == 0:
            continue
        cx = np.repeat(xs.ravel(), counts)
        cz = np.repeat(zs.ravel(), counts)
        ch = np.repeat(heights.ravel(), counts)
        cb = np.repeat(col_bot.ravel(), counts)
        offs = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        cy = cb + offs
        solid = cy < ch
        hl = 1.0 + 2.4 * (cy / terrain_max_height)
        band = np.clip(np.floor(
            hl + terrain._rolls(seed, cx, cy, cz) * 0.5), 0, 3).astype(np.int64)
        pick = np.round(terrain._rolls(seed ^ 0x5BD1E995, cx, cy, cz)
                        ).astype(np.int64)
        base = np.asarray([0, 1, 3, 5], dtype=np.int64)[band]
        mat = np.where((band > 0) & solid, base + pick, 0).astype(np.uint8)
        yield np.stack([cx, cy, cz], axis=-1), mat


def batches(static, scene: dict) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield the (xyz, materials) batches of the stream in order: each slab
    cut into runs of at most `max_batch` voxels."""
    step = int(scene["max_batch"])
    for xyz, mat in regions(static, scene["terrain_seed"],
                            scene["terrain_noise_scale"],
                            scene["ocean_level"], int(scene["region_x"])):
        for i in range(0, len(xyz), step):
            yield xyz[i:i + step], mat[i:i + step]


def build(scene: dict):
    """(grid, materials) of the reference package for a configuration's
    "scene" entry."""
    if scene["materials"] != "terrain_materials":
        raise ValueError(f"unknown material table {scene['materials']!r}")
    if scene.get("model") is not None:
        raise ValueError(f"the streamed world has no model: {scene['model']!r}")
    grid = BrickGrid(*scene["grid_dims"], GridConfig(
        min_point=tuple(scene["min_point"]), scale=scene["scale"]))
    materials = terrain_materials()
    grid.attach_materials(materials)
    vy = grid.static.voxel_dims[1]
    for xyz, mat in batches(grid.static, scene):
        x, y, z = xyz.T
        order = np.argsort(grid_at(grid.static, x, (vy - 1) - y, z),
                           kind="stable")
        grid.insert_batch(x[order], y[order], z[order], mat[order])
    return grid, materials
