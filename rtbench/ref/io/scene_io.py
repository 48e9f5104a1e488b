"""Scene checkpoint / resume.

Frozen copy of `zig_vulkan_tpu_torch/io/scene_io.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

Superset feature (SURVEY.md §5.4: the reference has no save/load; its
closest analog is .vox import): the brickmap arrays and the material table
serialize to one .npz, so edit sessions and streamed scenes survive
restarts.

The file format is `zig_vulkan_tpu.io.scene_io`'s, key for key and dtype
for dtype (uint32 statuses / indices / occupancy / start_indices /
diel_mask / counters, uint8 material bytes, float32 brick_ir, float64
geometry), so a scene saved by either package loads in the other. The
port's device arrays are int32 bit views (`GridArrays.to_device`); they go
back to uint32 by the same bit view.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import GridConfig
from ..core.grid import BrickGrid, GridArrays, GridStatic
from ..core.materials import MaterialTable


def _host(a, dtype) -> np.ndarray:
    """A scene field on the host in the file's dtype: torch tensors are
    copied over, and the int32 bit views read back as uint32."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.asarray(a)
    if dtype == np.uint32 and a.dtype == np.int32:
        return a.view(np.uint32)
    return a.astype(dtype, copy=False)


def save_scene(path: str, static: GridStatic, arrays: GridArrays,
               materials: MaterialTable, **extra) -> None:
    """Write `arrays` (host numpy or device torch) and `materials` to
    `path`. `extra`: additional arrays stored alongside the scene (e.g. the
    scene-cache version tag), so callers need not rewrite the compressed
    file to append a key."""
    u32 = np.uint32
    np.savez_compressed(
        path,
        **extra,
        dim_x=static.dim_x, dim_y=static.dim_y, dim_z=static.dim_z,
        brick_alloc=static.brick_alloc,
        # float64 so GridStatic's Python floats round-trip exactly
        min_point=np.asarray(static.min_point, dtype=np.float64),
        scale=np.float64(static.scale),
        base_t=np.float64(static.base_t),
        statuses=_host(arrays.statuses, u32),
        indices=_host(arrays.indices, u32),
        occupancy=_host(arrays.occupancy, u32),
        start_indices=_host(arrays.start_indices, u32),
        material_indices=_host(arrays.material_indices, np.uint8),
        active_bricks=u32(_host(arrays.active_bricks, u32)),
        material_cursor=u32(_host(arrays.material_cursor, u32)),
        diel_mask=_host(arrays.diel_mask, u32),
        brick_ir=_host(arrays.brick_ir, np.float32),
        mat_type=materials.mtype,
        mat_albedo=materials.albedo,
        mat_type_data=materials.type_data,
    )


def load_scene(path: str) -> Tuple[BrickGrid, MaterialTable]:
    """Restore a scene saved with `save_scene` (by either package) into a
    host BrickGrid; `VoxelRT(grid, ...)` or `VoxelRT.flush_grid(grid)`
    takes it to the device."""
    with np.load(path) as z:
        grid = BrickGrid(
            int(z["dim_x"]), int(z["dim_y"]), int(z["dim_z"]),
            GridConfig(
                brick_alloc=int(z["brick_alloc"]),
                min_point=tuple(float(v) for v in z["min_point"]),
                scale=float(z["scale"]),
                base_t=float(z["base_t"]),
            ),
        )
        grid.arrays = GridArrays(
            statuses=z["statuses"],
            indices=z["indices"],
            occupancy=z["occupancy"],
            start_indices=z["start_indices"],
            material_indices=z["material_indices"],
            active_bricks=np.uint32(z["active_bricks"]),
            material_cursor=np.uint32(z["material_cursor"]),
            diel_mask=(z["diel_mask"] if "diel_mask" in z
                       else np.zeros_like(z["occupancy"])),
            brick_ir=(z["brick_ir"] if "brick_ir" in z
                      else np.full(z["start_indices"].shape, np.nan,
                                   np.float32)),
        )
        materials = MaterialTable(
            mtype=z["mat_type"].copy(),
            albedo=z["mat_albedo"].copy(),
            type_data=z["mat_type_data"].copy(),
        )
    # re-register the material classification so host inserts after a load
    # keep maintaining diel_mask/brick_ir (the same-dielectric skip)
    grid.attach_materials(materials)
    return grid, materials
