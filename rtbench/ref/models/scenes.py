"""Scene assembly — the framework's "model zoo".

Frozen copy of `zig_vulkan_tpu_torch/models/scenes.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

Keeps what the benchmark's scene generator (`rtbench/scenes/
default_scene.py`) reaches: the demo model (`demo_model`) and its insertion
with the .vox y/z axis swap (`insert_vox_model`, main.zig:109-117). A numpy
copy of `zig_vulkan_tpu.models.scenes`; the scenes it builds are
bit-identical to the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.grid import BrickGrid
from ..core.materials import NUM_TERRAIN_MATERIALS
from ..io import vox as vox_mod


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


SCENE_CACHE_VERSION = 3  # bump when default_scene() or GridArrays change

