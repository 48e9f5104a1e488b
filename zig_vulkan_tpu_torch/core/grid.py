"""Sparse brick-map voxel grid (the scene database).

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
`zig_vulkan_tpu.core.grid.BrickGrid`. `apply_edits` and `remove_edits`
edit the torch arrays where they live (the engine's per-frame voxel
edits); `dense_materials` decodes a scene for comparisons.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import (
    BRICK_BITS,
    BRICK_DIMENSION,
    BRICK_WORDS,
    GridConfig,
)
from ..utils.device import resolve_device

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
    def insert(self, x: int, y: int, z: int, material_index: int) -> None:
        self.insert_batch(
            np.asarray([x]), np.asarray([y]), np.asarray([z]),
            np.asarray([material_index], dtype=np.uint8),
        )

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

    def rebuild_dielectric_masks(self) -> None:
        """Recompute diel_mask/brick_ir from material_indices + occupancy
        (used after external builds, e.g. the native builder)."""
        a = self.arrays
        a.diel_mask[:] = 0
        a.brick_ir[:] = np.nan
        active = int(a.active_bricks)
        if active == 0:
            return
        slots = np.arange(active * BRICK_BITS)
        bricks = slots // BRICK_BITS
        starts = (a.start_indices[bricks] & np.uint32(0x7FFFFFFF)).astype(np.int64)
        addr = starts + (slots % BRICK_BITS)
        occ_w = bricks * BRICK_WORDS + (slots % BRICK_BITS) // 32
        occ_b = ((a.occupancy[occ_w] >> ((slots % BRICK_BITS) % 32).astype(np.uint32))
                 & 1) == 1
        mats = a.material_indices[np.clip(addr, 0, a.material_indices.size - 1)]
        is_d = self._mat_is_diel[mats] & occ_b
        word = bricks * BRICK_WORDS + (slots % BRICK_BITS) // 32
        bit = np.uint32(1) << ((slots % BRICK_BITS) % 32).astype(np.uint32)
        np.bitwise_or.at(a.diel_mask, word[is_d], bit[is_d])
        d_bricks = bricks[is_d]
        d_ir = self._mat_ir[mats[is_d]]
        if d_bricks.size == 0:
            return
        # first-write wins; conflicts poison to NaN
        order = np.argsort(d_bricks, kind="stable")
        db, di = d_bricks[order], d_ir[order]
        first = np.concatenate([[True], db[1:] != db[:-1]])
        a.brick_ir[db[first]] = di[first]
        conflict = ~first & (di != a.brick_ir[db])
        if conflict.any():
            a.brick_ir[db[conflict]] = np.nan

    # -- device transfer --------------------------------------------------------
    def device_arrays(self, device=None) -> GridArrays:
        """Copy the scene arrays to `device` (the current CUDA device by
        default; raises `utils.device.NoCudaDevice` where there is none:
        the CPU is taken only when asked for) as `GridArrays.to_device`
        does (zig_vulkan_tpu/core/grid.py:376 on the default JAX
        device)."""
        return self.arrays.to_device(resolve_device(
            "cuda" if device is None else device))

    # -- queries (for tests / host logic) --------------------------------------
    def voxel_material(self, x: int, y: int, z: int) -> Optional[int]:
        """Material index at a voxel, or None if empty."""
        st = self.static
        a = self.arrays
        fy = (st.voxel_dims[1] - 1) - y
        cell = int(grid_at(st, np.int64(x), np.int64(fy), np.int64(z)))
        if not (a.statuses[cell // 32] >> np.uint32(cell % 32)) & 1:
            return None
        brick = int(a.indices[cell])
        nth = int(voxel_at(np.int64(x), np.int64(fy), np.int64(z)))
        occ = a.occupancy[brick * BRICK_WORDS + nth // 32]
        if not (occ >> np.uint32(nth % 32)) & 1:
            return None
        start = int(a.start_indices[brick] & np.uint32(0x7FFFFFFF))
        return int(a.material_indices[start + nth])


# -- device-side edits (torch) --------------------------------------------------
#
# The torch counterparts of zig_vulkan_tpu.core.grid.apply_edits /
# remove_edits: the reference's edit path (Grid.insert -> dirty ranges ->
# staging upload, VoxelRT.zig:107-172) as scatter updates on the device
# arrays. The arrays are the int32 bit views of GridArrays.to_device; every
# word update below is a bitwise OR / AND-NOT of per-word masks, and a mask
# is built by summing distinct bits into zero (a sum of distinct bits is
# their OR, and no partial sum leaves int32), so bit 31 needs no care.
#
# Edits update the arrays in place (the JAX package donates them), read
# nothing back to the host and make no tensor whose shape depends on the
# data: every lane stays, and masks choose what each lane writes. torch has
# no `mode="drop"`, so a lane that writes nothing adds 0 at a clamped index
# (`_put`), as the JAX package's scatter-adds do. An edit can therefore be
# captured in a CUDA graph (engine.step.EditStep).

def _voxel_cells(static: GridStatic, xyz):
    """(cell, voxel bit) int64[N] of int[N, 3] voxel coordinates, Y flipped
    (Grid.zig:135, :198-211)."""
    xyz = xyz.to(torch.int64)
    fy = (static.voxel_dims[1] - 1) - xyz[:, 1]
    return (grid_at(static, xyz[:, 0], fy, xyz[:, 2]),
            voxel_at(xyz[:, 0], fy, xyz[:, 2]))


def _bits_at(words, index):
    """bool: bit index%32 of words[index//32]."""
    return ((words[index // 32] >> (index % 32).to(torch.int32)) & 1) == 1


def _bit(n):
    """int32 word with bit n (0..31) set; bit 31 is the sign bit."""
    return torch.ones_like(n, dtype=torch.int32) << n.to(torch.int32)


def _run_starts(key):
    """bool: lane i starts a run of equal keys (key sorted)."""
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    return first


def _run_ends(key):
    """bool: lane i ends a run of equal keys (key sorted)."""
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]
    return last


def _run_or(run_start, bits, take):
    """Per run, the OR of `bits` over the lanes `take`, on every lane of the
    run. The taken bits of a run must be distinct."""
    run = torch.cumsum(run_start.to(torch.int64), 0) - 1
    acc = torch.zeros_like(bits)
    acc.index_add_(0, run, torch.where(take, bits, torch.zeros_like(bits)))
    return acc[run]


def _by_word_bit(word_key, nbit):
    """Stable lane order by (word, bit): the reference's
    lexsort((bit, word_key)) as one int64 key."""
    key = word_key * 32 + nbit
    order = torch.argsort(key, stable=True)
    return order, key[order]


def _put(dst, index, new, live):
    """dst[index[i]] = new[i] on the `live` lanes, whose targets are
    distinct, as a scatter-add of new - old; every other lane adds 0 at
    index 0. Integer adds wrap, so the result is exact for every integer
    dtype (the JAX package's `mode="drop"` scatter-adds)."""
    idx = torch.where(live, index, torch.zeros_like(index))
    old = dst[idx]
    dst.index_add_(0, idx, torch.where(live, new - old, torch.zeros_like(old)))


def apply_edits(static: GridStatic, arrays: GridArrays, xyz, material_index,
                valid, mat_is_diel=None, mat_ir=None) -> GridArrays:
    """Insert a batch of voxels into device-resident arrays
    (zig_vulkan_tpu/core/grid.py:393-543).

    Args:
      arrays: GridArrays of torch tensors (GridArrays.to_device); updated
        in place, `active_bricks` and `material_cursor` included.
      xyz: int[N, 3] voxel coordinates; material_index: uint8[N];
      valid: bool[N], False lanes are ignored (the engine pads batches).
      mat_is_diel, mat_ir: optional bool[256] / f32[256] material
        classification that maintains diel_mask/brick_ir; without them the
        edited voxels count as non-dielectric there.

    Returns `arrays`.

    Brick slots are numbered in cell order, material windows in the same
    rank order (stable sorts, so the arrays equal the reference's bit for
    bit). A voxel given twice in one batch takes its last lane's material
    and dielectric bit, as sequential inserts would; the reference leaves
    that unspecified. Bricks whose lanes bring different ir end up NaN.
    The caller keeps the brick count within `brick_alloc` (the engine's
    capacity guard); a brick past it is counted and its cell marked, as
    in the reference, and its voxels set no bit; their material bytes go,
    as there, through a clamped index into the last brick's window.
    """
    a = arrays
    dev = a.statuses.device
    cells, alloc = static.cells, static.brick_alloc
    n = xyz.shape[0]
    if n == 0:
        return a
    cell, nth = _voxel_cells(static, xyz)

    # lanes sorted by cell; invalid lanes sort last as their own run
    sort_key = torch.where(valid, cell, torch.full_like(cell, cells))
    order = torch.argsort(sort_key, stable=True)
    s_cell, s_valid, s_nth = sort_key[order], valid[order], nth[order]
    s_mat = material_index.to(torch.uint8)[order]
    safe_cell = s_cell.clamp(0, cells - 1)

    loaded = _bits_at(a.statuses, safe_cell)
    is_first = _run_starts(s_cell)
    allocates = is_first & ~loaded & s_valid
    alloc_i = allocates.to(torch.int32)
    rank = torch.cumsum(alloc_i, 0, dtype=torch.int32) - alloc_i
    n_new = alloc_i.sum(dtype=torch.int32)
    new_brick_id = a.active_bricks + rank

    # brick slot per lane: loaded cells keep theirs; the lanes of a newly
    # allocated cell take its first lane's fresh id (slot n takes the
    # writes of the lanes that allocate nothing)
    seg = torch.cumsum(is_first.to(torch.int64), 0) - 1
    seg_new_id = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    seg_new_id[torch.where(allocates, seg, torch.full_like(seg, n))] = (
        new_brick_id)
    brick = torch.where(loaded, a.indices[safe_cell], seg_new_id[seg])
    brick = torch.where(s_valid, brick, torch.zeros_like(brick)).to(torch.int64)

    # cell -> brick index and status bit of the allocating lanes (distinct
    # cells whose bits are clear: the sum is the OR)
    _put(a.indices, safe_cell, new_brick_id, allocates)
    a.statuses.index_add_(0, safe_cell // 32, torch.where(
        allocates, _bit(safe_cell % 32), torch.zeros_like(alloc_i)))

    # material windows for the new bricks, bump-allocated in rank order
    # (MaterialAllocator.zig:34-43)
    start_new = a.material_cursor + rank * BRICK_BITS
    fits = allocates & (new_brick_id < alloc)
    _put(a.start_indices, new_brick_id.to(torch.int64).clamp(0, alloc - 1),
         start_new, fits)
    a.material_cursor.add_(n_new * BRICK_BITS)
    a.active_bricks.add_(n_new)

    start_val = a.start_indices[brick.clamp(0, alloc - 1)] & 0x7FFFFFFF
    mat_addr = start_val.to(torch.int64) + s_nth

    # one representative lane per voxel: the last of its (word, bit) run
    word = brick * BRICK_WORDS + s_nth // 32
    word_key = torch.where(s_valid, word,
                           torch.full_like(word, alloc * BRICK_WORDS))
    wb, key = _by_word_bit(word_key, s_nth % 32)
    w_s, v_s = word_key[wb], s_valid[wb]
    b_s = _bit(s_nth[wb] % 32)
    take = v_s & _run_ends(key)
    m_s = s_mat[wb]
    b_sorted = brick[wb]

    # material bytes: distinct voxels of the bricks below the last have
    # distinct addresses
    addr = mat_addr[wb]
    in_range = addr < a.material_indices.numel()
    _put(a.material_indices, addr, m_s, take & (b_sorted < alloc - 1)
         & in_range)
    # the last brick's window also takes the bytes of the bricks past
    # brick_alloc (their index clamps to it, as in the reference); at each
    # address the valid lane last in cell order writes, as the reference's
    # scatter does
    clamped = v_s & (b_sorted >= alloc - 1) & in_range
    slot = s_nth[wb]
    last = torch.full((BRICK_BITS,), -1, dtype=wb.dtype, device=dev)
    last.scatter_reduce_(0, slot, torch.where(clamped, wb, -1), "amax")
    _put(a.material_indices, addr, m_s, clamped & (last[slot] == wb))

    # occupancy and dielectric bits: one read-modify-write per touched word
    if mat_is_diel is not None:
        lane_diel = mat_is_diel[m_s.to(torch.int64)]
        lane_ir = mat_ir[m_s.to(torch.int64)]
    else:
        lane_diel = torch.zeros_like(v_s)
        lane_ir = torch.zeros(n, dtype=torch.float32, device=dev)
    word_start = _run_starts(w_s)
    occ_or = _run_or(word_start, b_s, take)
    diel_or = _run_or(word_start, b_s, take & lane_diel)
    diel_clear = _run_or(word_start, b_s, take & ~lane_diel)
    rmw = word_start & v_s & (w_s < a.occupancy.numel())
    w = w_s.clamp(0, a.occupancy.numel() - 1)
    _put(a.occupancy, w, a.occupancy[w] | occ_or, rmw)
    _put(a.diel_mask, w, (a.diel_mask[w] | diel_or) & ~diel_clear, rmw)

    # per-brick ir: a NaN (unset) brick adopts the lanes' ir, a differing
    # ir poisons it to NaN (brick_raytracer.comp:427 then skips nothing)
    safe_b = b_sorted.clamp(0, alloc - 1)
    prev = a.brick_ir[safe_b]
    nan = torch.full_like(prev, float("nan"))
    new_ir = torch.where(torch.isnan(prev), lane_ir,
                         torch.where(prev != lane_ir, nan, prev))
    carries = take & lane_diel
    inf = torch.full_like(prev, float("inf"))
    val = torch.where(torch.isnan(new_ir), inf, new_ir)
    brick_start = _run_starts(w_s // BRICK_WORDS)
    run = torch.cumsum(brick_start.to(torch.int64), 0) - 1
    lo = inf.clone().scatter_reduce_(0, run, torch.where(carries, val, inf),
                                     "amin")
    hi = (-inf).scatter_reduce_(0, run, torch.where(carries, val, -inf),
                                "amax")
    lo, hi = lo[run], hi[run]
    merged = torch.where((lo == hi) & torch.isfinite(lo), lo, nan)
    put = brick_start & v_s & (hi > -inf) & (b_sorted < alloc)
    # a float delta is not exact (NaN, inf), so every lane that writes no
    # brick of its own repeats the first writing lane's write (or, where
    # no lane writes, brick 0's own value back to brick 0)
    first = torch.argmax(put.to(torch.int32)).view(1)
    some = put.any()
    target = torch.where(some, torch.where(put, safe_b, safe_b[first]), 0)
    value = torch.where(some, torch.where(put, merged, merged[first]),
                        a.brick_ir[0])
    a.brick_ir[target] = value
    return a


def remove_edits(static: GridStatic, arrays: GridArrays, xyz,
                 valid) -> GridArrays:
    """Clear a batch of voxels in device-resident arrays
    (zig_vulkan_tpu/core/grid.py:546-591): occupancy and dielectric bits
    only. Bricks are never freed, so statuses, indices, windows and the
    skip field stay as they are. Updates the arrays in place and returns
    them."""
    a = arrays
    cells, alloc = static.cells, static.brick_alloc
    cell, nth = _voxel_cells(static, xyz)
    safe_cell = cell.clamp(0, cells - 1)
    act = valid & _bits_at(a.statuses, safe_cell)
    word = a.indices[safe_cell].to(torch.int64) * BRICK_WORDS + nth // 32
    word_key = torch.where(act, word, torch.full_like(word, alloc * BRICK_WORDS))
    order, key = _by_word_bit(word_key, nth % 32)
    w_s, v_s = word_key[order], act[order]
    word_start = _run_starts(w_s)
    clear = _run_or(word_start, _bit(nth[order] % 32),
                    v_s & _run_starts(key))
    rmw = word_start & v_s
    w = w_s.clamp(0, a.occupancy.numel() - 1)
    _put(a.occupancy, w, a.occupancy[w] & ~clear, rmw)
    _put(a.diel_mask, w, a.diel_mask[w] & ~clear, rmw)
    return a


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
