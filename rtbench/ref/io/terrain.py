"""Procedural Perlin terrain generation.

Frozen copy of `zig_vulkan_tpu_torch/io/terrain.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

Re-implements the reference's CPU terrain pipeline (reference:
src/modules/voxel_rt/terrain/terrain.zig + terrain/perlin.zig) as vectorized
numpy: the reference spawns N worker threads over X-slabs inserting voxels
one at a time through mutex/atomic-guarded grid state (terrain.zig:113-127);
here whole columns are computed as arrays and pushed through
`BrickGrid.insert_batch`, which preserves the same resulting scene arrays
without any threading.

Algorithm parity (terrain.zig:80-109):
- column height = min(smooth_noise(p), 1) * (voxel_dim_y/2) with
  p = (x, 0, z) * (scale / voxel_dim);
- solid voxels fill y in [height/2, height) with a height-banded material:
  band value = lerp(1, 3.4, y / terrain_max_height) + rand * 0.5, floored to
  {water, grass, dirt, rock}, each band picking one of its two material
  variants at random (terrain.zig:23-39);
- ocean fill: water (material 0) for y in [height, ocean_level).

The reference's material randomness comes from a stateful PRNG shared across
worker threads (terrain.zig:101-103) — inherently non-deterministic under
thread interleaving. We replace it with position-seeded counter hashes, so
terrain is fully deterministic for a given seed (a strict improvement with
the same statistics).

The Perlin noise itself is the "Ray Tracing: The Next Week" generator
(perlin.zig:1-3): xor of three shuffled permutation tables indexing a table
of random f64s, trilinear-smoothstep filtered (perlin.zig:63-147).
"""

from __future__ import annotations

import numpy as np

from ..core.grid import BrickGrid

POINT_COUNT = 256  # permutation table size (terrain.zig:15)


class PerlinNoise:
    """RTNW perlin noise (reference perlin.zig:8-148), vectorized.

    Tables are drawn from numpy's PCG64 instead of Zig's Xoshiro256++ —
    terrain content for a given seed differs from the reference but the
    noise statistics and the filtering math are identical.
    """

    def __init__(self, seed: int, point_count: int = POINT_COUNT):
        rng = np.random.default_rng(seed)
        self.point_count = point_count
        self.rand_float = rng.random(point_count)  # f64, like NoiseFloat
        self.perm_x = rng.permutation(point_count).astype(np.int64)
        self.perm_y = rng.permutation(point_count).astype(np.int64)
        self.perm_z = rng.permutation(point_count).astype(np.int64)

    def noise(self, points: np.ndarray) -> np.ndarray:
        """Unfiltered hash noise (perlin.zig:63-78). points: f[..., 3]."""
        m = self.point_count - 1
        i = (4.0 * points[..., 0]).astype(np.int64) & m
        j = (4.0 * points[..., 2]).astype(np.int64) & m
        k = (4.0 * points[..., 1]).astype(np.int64) & m
        return self.rand_float[self.perm_x[i] ^ self.perm_y[j] ^ self.perm_z[k]]

    def smooth_noise(self, points: np.ndarray) -> np.ndarray:
        """Trilinear-smoothstep filtered noise (perlin.zig:80-147)."""
        m = self.point_count - 1
        p = np.asarray(points, dtype=np.float64)
        i = np.floor(p[..., 0]).astype(np.int64)
        j = np.floor(p[..., 1]).astype(np.int64)
        k = np.floor(p[..., 2]).astype(np.int64)

        u = p[..., 0] - np.floor(p[..., 0])
        v = p[..., 1] - np.floor(p[..., 1])
        w = p[..., 2] - np.floor(p[..., 2])
        u = u * u * (3.0 - 2.0 * u)
        v = v * v * (3.0 - 2.0 * v)
        w = w * w * (3.0 - 2.0 * w)

        accum = np.zeros(p.shape[:-1], dtype=np.float64)
        for di in (0, 1):
            fu = di * u + (1 - di) * (1.0 - u)
            px = self.perm_x[(i + di) & m]
            for dj in (0, 1):
                fv = dj * v + (1 - dj) * (1.0 - v)
                py = self.perm_y[(j + dj) & m]
                for dk in (0, 1):
                    fw = dk * w + (1 - dk) * (1.0 - w)
                    pz = self.perm_z[(k + dk) & m]
                    c = self.rand_float[px ^ py ^ pz]
                    accum += fu * fv * fw * c
        return accum


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """Deterministic integer hash (lowbias32) for material rolls."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return x


def _rolls(seed: int, xs, ys, zs) -> np.ndarray:
    """Position-seeded uniform [0,1) rolls replacing the shared PRNG."""
    key = (
        xs.astype(np.uint32)
        + ys.astype(np.uint32) * np.uint32(73856093)
        + zs.astype(np.uint32) * np.uint32(19349663)
        + np.uint32(seed & 0xFFFFFFFF)
    )
    return _hash_u32(key).astype(np.float64) / 4294967296.0


def generate(grid: BrickGrid, seed: int = 420, scale: float = 4.0,
             ocean_level: int = 20) -> None:
    """Populate `grid` with perlin terrain (reference terrain.zig:43-128).

    Defaults match the reference app invocation (main.zig:120):
    seed 420, noise scale 4, ocean level 20.
    """
    perlin = PerlinNoise(seed)
    vx, vy, vz = grid.static.voxel_dims
    terrain_max_height = vy * 0.5
    ocean_level = min(int(ocean_level), vy)  # clamp for small test grids

    xs, zs = np.meshgrid(np.arange(vx), np.arange(vz), indexing="ij")
    points = np.stack(
        [
            xs.astype(np.float64) * (scale / vx),
            np.zeros_like(xs, dtype=np.float64),
            zs.astype(np.float64) * (scale / vz),
        ],
        axis=-1,
    )
    heights = (np.minimum(perlin.smooth_noise(points), 1.0)
               * terrain_max_height).astype(np.int64)  # (vx, vz)

    # expand columns into voxel lists: solid band [height/2, height) plus
    # ocean fill [height, ocean_level)
    col_top = np.maximum(heights, ocean_level)
    col_bot = heights // 2
    counts = np.maximum(col_top - col_bot, 0)
    total = int(counts.sum())
    if total == 0:
        return

    col_x = np.repeat(xs.ravel(), counts.ravel())
    col_z = np.repeat(zs.ravel(), counts.ravel())
    col_h = np.repeat(heights.ravel(), counts.ravel())
    col_b = np.repeat(col_bot.ravel(), counts.ravel())
    # per-voxel y via cumulative offsets within each column
    offsets = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(counts.ravel())[:-1]]), counts.ravel()
    )
    col_y = col_b + offsets

    solid = col_y < col_h
    # material banding (terrain.zig:100-103)
    height_lerp = 1.0 + (3.4 - 1.0) * (col_y / terrain_max_height)
    roll_band = _rolls(seed, col_x, col_y, col_z)
    material_value = np.floor(height_lerp + roll_band * 0.5).astype(np.int64)
    material_value = np.clip(material_value, 0, 3)
    # band -> material index (terrain.zig:23-39): water=0, grass=1+round(r),
    # dirt=3+round(r), rock=5+round(r)
    roll_pick = np.round(_rolls(seed ^ 0x5BD1E995, col_x, col_y, col_z)).astype(np.int64)
    band_base = np.asarray([0, 1, 3, 5], dtype=np.int64)[material_value]
    band_has_variants = material_value > 0
    mat = np.where(band_has_variants, band_base + roll_pick, 0)
    mat = np.where(solid, mat, 0).astype(np.uint8)  # ocean fill = water (0)

    grid.insert_batch(col_x, col_y, col_z, mat)
