"""The cell's world, made by the benchmark and cached inside the checkout.

The scene is built by the generator the configuration names
(`rtbench/scenes/<generator>.py`, with the reference's frozen copy of the
port's scene code) and written once, in the scene file format both the port
(`zig_vulkan_tpu_torch.io.scene_io.load_scene`) and the reference read, to
`.rtbench_cache/` at the root of the checkout under a name fixed by the
scene's settings. Only a checkout's first run builds it; every later run
loads the file. The program and the reference read the same file: neither
takes a scene the other made.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from . import spec
from .spec import ROOT

CACHE_DIR = ROOT / ".rtbench_cache"
FORMAT = 1  # bump when what the file holds changes


def cache_path(scene: dict) -> Path:
    key = json.dumps({"format": FORMAT, **scene}, sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return CACHE_DIR / f"scene_{scene['generator']}_{digest}.npz"


def build(scene: dict):
    """(grid, materials) of the reference package for `scene`, a
    configuration's "scene" entry, by its generator
    (`rtbench/scenes/<generator>.py`)."""
    return spec.plugin("scenes", scene["generator"]).build(scene)


def cached(scene: dict) -> Path:
    """The scene file of `scene`, built and written on a miss."""
    from .ref.io import scene_io

    path = cache_path(scene)
    if not path.exists():
        grid, materials = build(scene)
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        part = path.with_name(path.stem + ".part.npz")
        scene_io.save_scene(str(part), grid.static, grid.arrays, materials,
                            rtbench_format=np.int64(FORMAT))
        os.replace(part, path)
    return path


def load_reference(path: Path):
    """(grid, materials) of the reference package from a scene file."""
    from .ref.io import scene_io

    return scene_io.load_scene(str(path))


def occupied(static, arrays, xyz: np.ndarray) -> np.ndarray:
    """bool[N]: which voxels int[N, 3] (x, y, z) hold a voxel in the host
    arrays of a reference grid (the grid's addressing, Y flipped)."""
    from .ref.config import BRICK_WORDS
    from .ref.core.grid import grid_at, voxel_at

    x, y, z = (xyz[:, i].astype(np.int64) for i in range(3))
    fy = (static.voxel_dims[1] - 1) - y
    cell = grid_at(static, x, fy, z)
    statuses = np.asarray(arrays.statuses, dtype=np.uint32)
    loaded = ((statuses[cell // 32] >> (cell % 32).astype(np.uint32))
              & 1).astype(bool)
    brick = np.asarray(arrays.indices, dtype=np.uint32)[cell].astype(np.int64)
    brick = np.where(loaded, brick, 0)
    nth = voxel_at(x, fy, z)
    words = np.asarray(arrays.occupancy, dtype=np.uint32)
    occ = ((words[brick * BRICK_WORDS + nth // 32]
            >> (nth % 32).astype(np.uint32)) & 1).astype(bool)
    return loaded & occ
