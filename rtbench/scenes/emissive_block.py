"""Scene generator `emissive_block`: the world of `default_scene` with an
emissive material and a block of it at the top centre of the voxel grid
(this repo's BASELINE config 4, as `zig_vulkan_tpu_torch/benchmarks/
configs.py:build_config4` builds it), made with the reference's frozen copy
of the port's scene code.

The configuration's "scene" entry is `default_scene`'s, plus "emissive"
(the material's table index, type, albedo and strength) and "block", which
names the block's layout: "build_config4", an 8x4x8-voxel block with x in
[vx/2 - 4, vx/2 + 4), y in [vy - 8, vy - 4) and z in [vz/2 - 4, vz/2 + 4)
of the grid's voxel dims (vx, vy, vz), inserted after the terrain.
"""

import numpy as np

from rtbench import spec
from rtbench.ref.core.materials import MAT_EMISSIVE

MATERIAL_TYPES = {"MAT_EMISSIVE": MAT_EMISSIVE}


def block_voxels(static) -> np.ndarray:
    """int64[256, 3]: the block's voxels (x, y, z) in the grid of `static`
    (`BrickGrid.insert_batch`'s coordinates, Y up), x slowest."""
    vx, vy, vz = static.voxel_dims
    xs, ys, zs = np.meshgrid(
        np.arange(max(0, vx // 2 - 4), vx // 2 + 4),
        np.arange(max(0, vy - 8), max(1, vy - 4)),
        np.arange(max(0, vz // 2 - 4), vz // 2 + 4), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=-1)


def build(scene: dict):
    """(grid, materials) of the reference package for a configuration's
    "scene" entry."""
    if scene["block"] != "build_config4":
        raise ValueError(f"unknown block layout {scene['block']!r}")
    em = scene["emissive"]
    if em["type"] not in MATERIAL_TYPES:
        raise ValueError(f"unknown material type {em['type']!r}")
    grid, materials = spec.plugin("scenes", "default_scene").build(scene)
    materials.set(int(em["index"]), MATERIAL_TYPES[em["type"]],
                  tuple(em["albedo"]), float(em["strength"]))
    xyz = block_voxels(grid.static)
    grid.insert_batch(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                      np.full(len(xyz), int(em["index"]), dtype=np.uint8))
    return grid, materials
