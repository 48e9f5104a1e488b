"""Scene assembly — the framework's "model zoo".

Builds renderable scenes the way the reference application does
(reference: src/main.zig:77-120): a brick grid, a material table seeded with
the 8 terrain materials plus .vox-palette-derived materials, an optional
.vox model inserted at an offset, and procedural perlin terrain.

`default_scene()` reproduces the reference's default workload:
128x64x128 bricks (= 512x256x512 voxels), min_point (-32,-16,-32),
scale 0.5 (main.zig:77-81), terrain seed 420 / noise scale 4 / ocean 20
(main.zig:120), model at offset (+200, +50, +150) with the .vox y/z axis
swap (main.zig:109-117). A numpy copy of `zig_vulkan_tpu.models.scenes`;
the scenes it builds are bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import GridConfig
from ..core.grid import BrickGrid
from ..core.materials import (
    NUM_TERRAIN_MATERIALS,
    MaterialTable,
    fill_from_vox_palette,
    terrain_materials,
)
from ..io import terrain as terrain_mod
from ..io import vox as vox_mod


@dataclasses.dataclass
class Scene:
    grid: BrickGrid
    materials: MaterialTable


def demo_model(size: int = 24) -> vox_mod.Vox:
    """A procedural .vox stand-in (hollow sphere + pillars) used when no
    model file is supplied; exercises the same insert path as a real model."""
    coords = []
    c = size / 2.0
    r = size * 0.45
    for x in range(size):
        for y in range(size):
            for z in range(size):
                d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
                if r - 1.5 <= d <= r:
                    coords.append((x, y, z, (x + y + z) % 254 + 1))
    for x, y in ((2, 2), (2, size - 3), (size - 3, 2), (size - 3, size - 3)):
        for z in range(size):
            coords.append((x, y, z, 42))
    arr = np.asarray(coords, dtype=np.uint8)
    return vox_mod.Vox(
        version_number=150,
        num_models=1,
        sizes=[(size, size, size)],
        models=[arr],
        palette=vox_mod.default_palette(),
    )


def insert_vox_model(grid: BrickGrid, model: vox_mod.Vox,
                     offset: Tuple[int, int, int] = (200, 50, 150),
                     material_offset: int = NUM_TERRAIN_MATERIALS,
                     model_index: int = 0) -> None:
    """Insert a model's voxels (reference main.zig:109-117: grid x,y,z =
    vox x, z, y — .vox gravity axis is z — plus the fixed offset; material
    index = color_index + number of terrain materials). `model_index`
    selects among PACK'd models (the reference always uses model 0)."""
    xyzi = model.models[model_index]
    x = xyzi[:, 0].astype(np.int64) + offset[0]
    y = xyzi[:, 2].astype(np.int64) + offset[1]
    z = xyzi[:, 1].astype(np.int64) + offset[2]
    mats = (xyzi[:, 3].astype(np.int64) + material_offset).astype(np.uint8)
    # voxels falling outside the grid are dropped (the reference would hit a
    # debug assert, Grid.zig:130-132; clipping is friendlier for small grids)
    vx, vy, vz = grid.static.voxel_dims
    keep = ((x >= 0) & (x < vx) & (y >= 0) & (y < vy) & (z >= 0) & (z < vz))
    grid.insert_batch(x[keep], y[keep], z[keep], mats[keep])


def default_scene(vox_path: Optional[str] = None,
                  dims: Tuple[int, int, int] = (128, 64, 128),
                  with_terrain: bool = True,
                  with_model: bool = True,
                  terrain_seed: int = 420) -> Scene:
    """The reference app's startup scene (main.zig:77-120)."""
    grid = BrickGrid(
        *dims,
        GridConfig(min_point=(-32.0, -16.0, -32.0), scale=0.5, workers_count=4),
    )
    materials = terrain_materials()

    if with_model:
        model = vox_mod.load(vox_path) if vox_path else demo_model()
        fill_from_vox_palette(materials, model.palette)
        grid.attach_materials(materials)
        insert_vox_model(grid, model)
    else:
        grid.attach_materials(materials)
    if with_terrain:
        terrain_mod.generate(grid, seed=terrain_seed, scale=4.0, ocean_level=20)
    return Scene(grid=grid, materials=materials)


SCENE_CACHE_VERSION = 3  # bump when default_scene() or GridArrays change


def cached_default_scene(cache_path: str,
                         version: int = SCENE_CACHE_VERSION) -> Scene:
    """default_scene() with a host-side .npz cache (io.scene_io's format,
    shared with `zig_vulkan_tpu.models.scenes.cached_default_scene`, so
    either package reads the other's cache). Rebuilds on a miss, a version
    mismatch or an unreadable file, and never fails on a cache-write
    error."""
    import os
    import sys
    import zipfile

    from ..io import scene_io

    if os.path.exists(cache_path):
        try:
            with np.load(cache_path) as z:
                ver = int(z["cache_version"]) if "cache_version" in z.files else 0
            if ver == version:
                grid, materials = scene_io.load_scene(cache_path)
                return Scene(grid=grid, materials=materials)
            print(f"# scene cache stale (v{ver} != v{version}); rebuilding",
                  file=sys.stderr)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            print(f"# scene cache unreadable ({e!r}); rebuilding",
                  file=sys.stderr)
    sc = default_scene()
    try:
        scene_io.save_scene(cache_path, sc.grid.static, sc.grid.arrays,
                            sc.materials, cache_version=np.int64(version))
    except OSError as e:
        print(f"# scene cache write failed ({e!r}); continuing",
              file=sys.stderr)
    return sc


def flat_test_scene(dim: int = 16, fill_material: int = 1,
                    scale: float = 1.0) -> Scene:
    """A small dense slab scene for oracle/parity tests (BASELINE config 1)."""
    grid = BrickGrid(dim, dim, dim, GridConfig(min_point=(0.0, 0.0, 0.0), scale=scale))
    materials = terrain_materials()
    grid.attach_materials(materials)
    vx, vy, vz = grid.static.voxel_dims
    xs, zs = np.meshgrid(np.arange(vx), np.arange(vz), indexing="ij")
    # a 4-voxel-thick floor slab plus a centered cube
    for y in range(4):
        grid.insert_batch(
            xs.ravel(), np.full(xs.size, y), zs.ravel(),
            np.full(xs.size, fill_material, dtype=np.uint8),
        )
    c0, c1 = vx // 2 - 4, vx // 2 + 4
    cx, cy, cz = np.meshgrid(
        np.arange(c0, c1), np.arange(8, 16), np.arange(c0, c1), indexing="ij"
    )
    grid.insert_batch(
        cx.ravel(), cy.ravel(), cz.ravel(),
        np.full(cx.size, 5, dtype=np.uint8),
    )
    return Scene(grid=grid, materials=materials)
