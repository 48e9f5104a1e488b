"""Sparse brick-map voxel grid (the scene database).

Frozen copy of `zig_vulkan_tpu_torch/core/grid.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

A host-side numpy copy of `zig_vulkan_tpu.core.grid` (the reference's
brickmap, brick/Grid.zig + the device layout of brick/State.zig:133-156):

- `statuses`   uint32[ceil(cells/32)] — 1 bit per grid cell ("loaded"),
  bit i%32 of word i/32 (State.zig:86-107);
- `indices`    uint32[cells] — cell -> brick slot (State.zig:109);
- `occupancy`  uint32[brick_alloc * 2] — 64 voxel bits per brick, voxel
  bit v of brick b = bit v%32 of word b*2 + v/32;
- `start_indices` uint32[brick_alloc] — packed {u31 material window start,
  1 bit type}, sentinel 0xFFFFFFFF (State.zig:111-127);
- `material_indices` uint8[brick_alloc * 64] — per-voxel material bytes in
  bump-allocated 64-entry windows (brick/MaterialAllocator.zig:34-43).

Grid cell index = x + dim_x * (z + dim_z * y) (Grid.zig:206-211); voxel bit
within a brick = bx + 4 * (bz + 4 * by) (Grid.zig:198-203); `insert` flips Y
(Grid.zig:135).

`BrickGrid` builds scenes with vectorized batch inserts, bit for bit as the
reference builder does. `GridArrays.to_device` is the one converter from
host arrays to torch tensors; it also takes arrays built by
`zig_vulkan_tpu.core.grid.BrickGrid`. The reference edits its scene
through `BrickGrid.insert_batch` and `remove_batch`; `dense_materials`
decodes a scene for comparisons.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import (
    BRICK_BITS,
    BRICK_DIMENSION,
    BRICK_WORDS,
    GridConfig,
)

UNSET_START_INDEX = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class GridStatic:
    """Trace-time constants of a grid (the reference's uniform
    `BrickGridState` (State.zig:60-79) + specialization constants).

    Hashable, so it can key caches.
    """

    dim_x: int
    dim_y: int
    dim_z: int
    brick_alloc: int
    min_point: Tuple[float, float, float]
    scale: float
    base_t: float  # kept for uniform parity; the kernel never reads it

    @property
    def dims(self) -> Tuple[int, int, int]:
        return (self.dim_x, self.dim_y, self.dim_z)

    @property
    def voxel_dims(self) -> Tuple[int, int, int]:
        return (
            self.dim_x * BRICK_DIMENSION,
            self.dim_y * BRICK_DIMENSION,
            self.dim_z * BRICK_DIMENSION,
        )

    @property
    def cells(self) -> int:
        return self.dim_x * self.dim_y * self.dim_z

    @property
    def max_point(self) -> Tuple[float, float, float]:
        return (
            self.min_point[0] + self.dim_x * self.scale,
            self.min_point[1] + self.dim_y * self.scale,
            self.min_point[2] + self.dim_z * self.scale,
        )

    @property
    def voxel_scale(self) -> float:
        return self.scale / BRICK_DIMENSION


@dataclasses.dataclass
class GridArrays:
    """The scene arrays: numpy on the host, torch tensors after `to_device`.

    The first five mirror the reference's GPU buffers (State.zig:133-156).
    `diel_mask`/`brick_ir` are derived acceleration data maintained
    incrementally alongside them: per-brick bits marking dielectric voxels
    and the brick's dielectric index of refraction (NaN if the brick has no
    dielectric, or has voxels with conflicting ir — see ops.trace). They
    let the traversal evaluate the same-material skip rule
    (brick_raytracer.comp:427) from registers instead of per-voxel gathers.
    """

    statuses: np.ndarray           # uint32[ceil(cells/32)]
    indices: np.ndarray            # uint32[cells]
    occupancy: np.ndarray          # uint32[brick_alloc * BRICK_WORDS]
    start_indices: np.ndarray      # uint32[brick_alloc]
    material_indices: np.ndarray   # uint8[brick_alloc * BRICK_BITS]
    active_bricks: np.ndarray      # uint32[] scalar
    material_cursor: np.ndarray    # uint32[] scalar (MaterialAllocator cursor)
    diel_mask: np.ndarray          # uint32[brick_alloc * BRICK_WORDS]
    brick_ir: np.ndarray           # f32[brick_alloc] (NaN = none/conflict)

    _U32_FIELDS = ("statuses", "indices", "occupancy", "start_indices",
                   "active_bricks", "material_cursor", "diel_mask")

    def to_device(self, device) -> "GridArrays":
        """Copy the arrays to `device` as torch tensors.

        torch supports uint32 only in part, so every uint32 field goes over
        as int32 through `ndarray.view(np.int32)`: a bit view, no value
        conversion (the empty-cell sentinel 0xFFFFFFFF becomes -1, bit 31 of
        an occupancy word becomes the sign bit). `material_indices` stays
        uint8 and `brick_ir` float32.

        Only attributes are read, so the function also converts arrays
        built by the JAX package's `BrickGrid`:
        `GridArrays.to_device(reference_grid.arrays, device)`.
        """

        def u32_bits(a):
            a = np.array(np.asarray(a), dtype=np.uint32)
            return torch.from_numpy(a.view(np.int32)).to(device)

        fields = {name: u32_bits(getattr(self, name))
                  for name in GridArrays._U32_FIELDS}
        fields["material_indices"] = torch.from_numpy(np.array(
            np.asarray(self.material_indices), dtype=np.uint8)).to(device)
        fields["brick_ir"] = torch.from_numpy(np.array(
            np.asarray(self.brick_ir), dtype=np.float32)).to(device)
        return GridArrays(**fields)


def grid_at(static: GridStatic, x, y, z):
    """Grid cell index from voxel coords (reference Grid.zig:206-211)."""
    gx = x // BRICK_DIMENSION
    gy = y // BRICK_DIMENSION
    gz = z // BRICK_DIMENSION
    return gx + static.dim_x * (gz + static.dim_z * gy)


def voxel_at(x, y, z):
    """Voxel bit within a brick (reference Grid.zig:198-203)."""
    bx = x % BRICK_DIMENSION
    by = y % BRICK_DIMENSION
    bz = z % BRICK_DIMENSION
    return bx + BRICK_DIMENSION * (bz + BRICK_DIMENSION * by)


class BrickGrid:
    """Host-side scene builder (reference brick/Grid.zig).

    Arrays live in numpy; `self.device_arrays(device)` copies them to
    torch tensors.
    """

    def __init__(self, dim_x: int, dim_y: int, dim_z: int,
                 config: GridConfig = GridConfig()):
        assert dim_x * dim_y * dim_z > 0
        brick_count = dim_x * dim_y * dim_z
        brick_alloc = config.brick_alloc if config.brick_alloc is not None else brick_count

        self.static = GridStatic(
            dim_x=dim_x,
            dim_y=dim_y,
            dim_z=dim_z,
            brick_alloc=brick_alloc,
            min_point=tuple(float(v) for v in config.min_point),
            scale=float(config.scale),
            base_t=float(config.base_t),
        )
        self.arrays = GridArrays(
            statuses=np.zeros((brick_count + 31) // 32, dtype=np.uint32),
            indices=np.zeros(brick_count, dtype=np.uint32),
            occupancy=np.zeros(brick_alloc * BRICK_WORDS, dtype=np.uint32),
            start_indices=np.full(brick_alloc, UNSET_START_INDEX, dtype=np.uint32),
            material_indices=np.zeros(brick_alloc * BRICK_BITS, dtype=np.uint8),
            active_bricks=np.uint32(0),
            material_cursor=np.uint32(0),
            diel_mask=np.zeros(brick_alloc * BRICK_WORDS, dtype=np.uint32),
            brick_ir=np.full(brick_alloc, np.nan, dtype=np.float32),
        )
        # material classification used to maintain diel_mask/brick_ir; set
        # via attach_materials (defaults: no dielectrics)
        self._mat_is_diel = np.zeros(256, dtype=bool)
        self._mat_ir = np.zeros(256, dtype=np.float32)

    def attach_materials(self, materials) -> None:
        """Register the material table used to classify dielectric voxels
        for the diel_mask/brick_ir acceleration data. Call before inserts
        (models.scenes does this automatically)."""
        from .materials import MAT_DIELECTRIC

        self._mat_is_diel = materials.mtype == MAT_DIELECTRIC
        self._mat_ir = materials.type_data.astype(np.float32)

    # -- single-voxel API (reference Grid.zig:129-194) -------------------------

    # -- vectorized batch insert ------------------------------------------------
    def insert_batch(self, x, y, z, material_index) -> None:
        """Insert many voxels at once; equivalent to sequential `insert` calls.

        Brick slots and material windows are bump-allocated in order of first
        appearance, mirroring the reference's atomic fetchAdd allocation
        (Grid.zig:141-148, MaterialAllocator.zig:34-43). Duplicate voxels keep
        the material of the LAST occurrence, like sequential inserts.
        """
        st = self.static
        a = self.arrays
        x = np.asarray(x, dtype=np.int64)
        y = np.asarray(y, dtype=np.int64)
        z = np.asarray(z, dtype=np.int64)
        material_index = np.asarray(material_index, dtype=np.uint8)
        if x.size == 0:
            return
        vx, vy, vz = st.voxel_dims
        if (x.min() < 0 or x.max() >= vx or y.min() < 0 or y.max() >= vy
                or z.min() < 0 or z.max() >= vz):
            raise IndexError("voxel out of grid bounds")

        # Y flip for intuitive coordinates (Grid.zig:135)
        fy = (vy - 1) - y

        cell = grid_at(st, x, fy, z)
        nth_bit = voxel_at(x, fy, z)

        # --- allocate brick slots for cells seen for the first time ---
        loaded = (a.statuses[cell // 32] >> (cell % 32).astype(np.uint32)) & 1
        uniq_cells, first_pos = np.unique(cell, return_index=True)
        # order of first appearance, to mirror sequential allocation order
        order = np.argsort(first_pos, kind="stable")
        uniq_cells = uniq_cells[order]
        uniq_loaded = (a.statuses[uniq_cells // 32] >> (uniq_cells % 32).astype(np.uint32)) & 1
        new_cells = uniq_cells[uniq_loaded == 0]
        n_new = new_cells.size
        if int(a.active_bricks) + n_new > st.brick_alloc:
            raise MemoryError("brick allocation exhausted")
        new_brick_ids = (int(a.active_bricks) + np.arange(n_new)).astype(np.uint32)
        a.indices[new_cells] = new_brick_ids
        np.bitwise_or.at(
            a.statuses, new_cells // 32,
            (np.uint32(1) << (new_cells % 32).astype(np.uint32)),
        )
        a.active_bricks = np.uint32(int(a.active_bricks) + n_new)

        # --- material windows for bricks that lack one ---
        brick = a.indices[cell].astype(np.int64)
        needs_window = a.start_indices[brick] == UNSET_START_INDEX
        uniq_bricks, first_b = np.unique(brick[needs_window], return_index=True)
        uniq_bricks = uniq_bricks[np.argsort(first_b, kind="stable")]
        n_windows = uniq_bricks.size
        if int(a.material_cursor) + n_windows * BRICK_BITS > a.material_indices.size:
            raise MemoryError("material window allocation exhausted")
        window_starts = (int(a.material_cursor)
                         + np.arange(n_windows) * BRICK_BITS).astype(np.uint32)
        # type bit (bit 31) = voxel_start_index (0), so the raw packed value
        # is just the window start (State.zig:117-120)
        a.start_indices[uniq_bricks] = window_starts
        a.material_cursor = np.uint32(int(a.material_cursor) + n_windows * BRICK_BITS)

        # --- material bytes (last writer wins, like sequential inserts) ---
        start_value = (a.start_indices[brick] & np.uint32(0x7FFFFFFF)).astype(np.int64)
        a.material_indices[start_value + nth_bit] = material_index

        # --- occupancy bits ---
        word = brick * BRICK_WORDS + nth_bit // 32
        bit = np.uint32(1) << (nth_bit % 32).astype(np.uint32)
        np.bitwise_or.at(a.occupancy, word, bit)

        # --- dielectric mask + per-brick ir maintenance ---
        is_d = self._mat_is_diel[material_index]
        if is_d.any():
            np.bitwise_or.at(a.diel_mask, word[is_d], bit[is_d])
            ir = self._mat_ir[material_index[is_d]]
            b_d = brick[is_d]
            prev = a.brick_ir[b_d]
            # NaN (unset) adopts the ir; conflicting ir poisons to NaN via a
            # second pass below
            a.brick_ir[b_d] = np.where(np.isnan(prev), ir, prev)
            conflict = ~np.isnan(a.brick_ir[b_d]) & (a.brick_ir[b_d] != ir)
            if conflict.any():
                a.brick_ir[b_d[conflict]] = np.nan
        # non-dielectric overwrites clear stale mask bits for those voxels
        not_d = ~is_d
        if not_d.any():
            np.bitwise_and.at(a.diel_mask, word[not_d], ~bit[not_d])

    def remove_batch(self, x, y, z) -> None:
        """Clear voxels (superset feature: the reference only inserts;
        BASELINE.json config 3 exercises insert/remove). Occupancy bits
        only, as `zig_vulkan_tpu.core.grid.BrickGrid.remove_batch`: bricks
        are never freed."""
        st = self.static
        a = self.arrays
        x = np.asarray(x, dtype=np.int64)
        y = np.asarray(y, dtype=np.int64)
        z = np.asarray(z, dtype=np.int64)
        fy = (st.voxel_dims[1] - 1) - y
        cell = grid_at(st, x, fy, z)
        nth_bit = voxel_at(x, fy, z)
        loaded = (a.statuses[cell // 32] >> (cell % 32).astype(np.uint32)) & 1
        keep = loaded == 1
        if not keep.any():
            return
        brick = a.indices[cell[keep]].astype(np.int64)
        word = brick * BRICK_WORDS + nth_bit[keep] // 32
        np.bitwise_and.at(
            a.occupancy, word,
            ~(np.uint32(1) << (nth_bit[keep] % 32).astype(np.uint32)),
        )


def _bits_at(words, index):
    """bool: bit index%32 of words[index//32]."""
    return ((words[index // 32] >> (index % 32).to(torch.int32)) & 1) == 1


def dense_materials(static: GridStatic, arrays: GridArrays):
    """The scene as a dense int16[vx, vy, vz] tensor of material indices
    (-1 = empty), indexed by the insert coordinates
    (zig_vulkan_tpu/core/grid.py:594-628).

    Independent of brick slot numbering, so it compares scenes built in
    different orders. Decodes on the device the tensors live on; host
    (numpy) arrays are decoded on the CPU."""
    if isinstance(arrays.statuses, np.ndarray):
        arrays = arrays.to_device("cpu")
    dev = arrays.statuses.device
    vx, vy, vz = static.voxel_dims
    x = torch.arange(vx, device=dev).view(vx, 1, 1)
    y = torch.arange(vy, device=dev).view(1, vy, 1)
    z = torch.arange(vz, device=dev).view(1, 1, vz)
    fy = (vy - 1) - y
    cell = grid_at(static, x, fy, z)
    nth = voxel_at(x, fy, z)
    loaded = _bits_at(arrays.statuses, cell)
    brick = arrays.indices[cell].to(torch.int64)
    solid = loaded & _bits_at(arrays.occupancy, brick * 64 + nth)
    start = (arrays.start_indices[brick.clamp(0, static.brick_alloc - 1)]
             & 0x7FFFFFFF).to(torch.int64)
    mats = arrays.material_indices
    midx = mats[(start + nth).clamp(0, mats.numel() - 1)].to(torch.int16)
    return torch.where(solid, midx, torch.full_like(midx, -1))
