"""Material table.

Frozen copy of `zig_vulkan_tpu_torch/core/materials.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

Re-implements the reference's GPU material buffer (reference:
src/modules/voxel_rt/gpu_types.zig:16-32 — `Material {type, albedo_rgb,
type_data}`) as a structure of arrays: the device copy
(ops.trace.materials_to_device) stacks the fields into one f32[5, 256]
table, one row per field, so the per-bounce material lookup (ops.lookup)
gathers single words.

`type_data` semantics (gpu_types.zig:29-31): unused for lambertian, fuzz for
metal, index of refraction for dielectric.

Includes the 8 built-in terrain materials (terrain/terrain.zig:130-196) and
the .vox palette -> material derivation used by the reference app
(main.zig:87-106: dielectric ior=1.52 if alpha < 0.8 else lambertian).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_NONE = 3
# superset feature (BASELINE.json config 4): emissive voxels; type_data is
# the emission strength multiplier. The reference has no emissive type.
MAT_EMISSIVE = 4

MATERIAL_TABLE_SIZE = 256

_F32 = np.float32


@dataclasses.dataclass
class MaterialTable:
    """SoA material table (256 entries, like the reference's buffer)."""

    mtype: np.ndarray      # (256,) int32
    albedo: np.ndarray     # (256, 3) f32
    type_data: np.ndarray  # (256,) f32

    @staticmethod
    def empty() -> "MaterialTable":
        return MaterialTable(
            mtype=np.zeros(MATERIAL_TABLE_SIZE, dtype=np.int32),
            albedo=np.zeros((MATERIAL_TABLE_SIZE, 3), dtype=_F32),
            type_data=np.zeros(MATERIAL_TABLE_SIZE, dtype=_F32),
        )

    def set(self, index: int, mtype: int, albedo, type_data: float = 0.0) -> None:
        self.mtype[index] = mtype
        self.albedo[index] = np.asarray(albedo, dtype=_F32)
        self.type_data[index] = _F32(type_data)


# The 8 built-in terrain materials (reference terrain/terrain.zig:130-196):
# water (dielectric ior=1.333), grass x2, dirt x2, rock x2, iron (metal).
_TERRAIN_MATERIALS = [
    (MAT_DIELECTRIC, (0.117, 0.45, 0.85), 1.333),   # water
    (MAT_LAMBERTIAN, (0.0, 0.6, 0.0), 0.0),         # grass 1
    (MAT_LAMBERTIAN, (0.0, 0.5019, 0.0), 0.0),      # grass 2
    (MAT_LAMBERTIAN, (0.301, 0.149, 0.0), 0.0),     # dirt 1
    (MAT_LAMBERTIAN, (0.4, 0.2, 0.0), 0.0),         # dirt 2
    (MAT_LAMBERTIAN, (0.275, 0.275, 0.275), 0.0),   # rock 1
    (MAT_LAMBERTIAN, (0.225, 0.225, 0.225), 0.0),   # rock 2
    (MAT_METAL, (0.6, 0.337, 0.282), 0.45),         # iron
]

NUM_TERRAIN_MATERIALS = len(_TERRAIN_MATERIALS)


def terrain_materials() -> MaterialTable:
    """Material table pre-filled with the 8 terrain materials at [0..8)."""
    table = MaterialTable.empty()
    for i, (mtype, albedo, data) in enumerate(_TERRAIN_MATERIALS):
        table.set(i, mtype, albedo, data)
    return table


def fill_from_vox_palette(table: MaterialTable, rgba: np.ndarray,
                          offset: int = NUM_TERRAIN_MATERIALS) -> MaterialTable:
    """Derive materials from a .vox RGBA palette (reference main.zig:93-106).

    Palette entries [0 .. 256-offset) land at table slots [offset .. 256):
    alpha < 0.8 -> dielectric with ior 1.52, else lambertian; albedo = rgb/255.
    """
    count = MATERIAL_TABLE_SIZE - offset
    rgba = np.asarray(rgba, dtype=np.uint8)[:count]
    alpha = rgba[:, 3].astype(_F32) / _F32(255.0)
    is_dielectric = alpha < _F32(0.8)
    table.mtype[offset:offset + count] = np.where(
        is_dielectric, MAT_DIELECTRIC, MAT_LAMBERTIAN
    ).astype(np.int32)
    table.albedo[offset:offset + count] = rgba[:, :3].astype(_F32) / _F32(255.0)
    table.type_data[offset:offset + count] = np.where(
        is_dielectric, _F32(1.52), _F32(0.0)
    )
    return table
