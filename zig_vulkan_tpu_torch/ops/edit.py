"""The voxel edits over the engine's edit buffer: the wrappers over
csrc/edit.cu.

An edit buffer (`engine.step.EditStep`'s) is int32[4 * size + 1]: the
lanes' voxel coordinates ([size, 3]), their materials ([size]) and the
count of live lanes; `pack` writes it on the host, `lanes` reads it.
`insert` and `remove` run one batch on the scene's arrays in place and,
given the cached records `(tables, dist)` (lane 3 of `tables` holds
`dist`, as the engine keeps them), bring those up to date: an insert
rebuilds the conservative skip field into `dist` and lane 3 of every
record, and each edit writes the rows of its touched cells anew.

For a buffer on the CPU they take the plain body: `core.grid.apply_edits`
/ `remove_edits` and `ops.trace.refresh_tables_after_insert` /
`refresh_tables_after_remove`, op by op. For a buffer on a CUDA device they
launch csrc/edit.cu, for every padded size, or raise: one launch an insert
(its lane work in one block), three more for its field and rows, one a
removal with its rows. The field's launches sit between the two
`edit_field` device marks; the last rewrites `dist` and lane 3 only where a
cell's distance changed, which leaves the records as a whole rewrite
would. The results equal the plain body's bit for bit
(tests/test_torch_edit_kernels.py). Each returns the route it took: True
where it launched the kernels, False where it ran the plain body.
`insert.launches` and `remove.launches` count the kernels launched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..config import BRICK_BITS, BRICK_WORDS
from ..core.grid import (GridArrays, GridStatic, apply_edits, grid_at,
                         remove_edits)
from ..utils import profiling
from . import trace

# cells of one field block (csrc/edit.cu FIELD_TILE): a grid's lines are
# at most this long
FIELD_TILE = 4096
# lanes of one buffer, at most: lane and slot numbers stay well within
# the kernels' 32-bit indices
MAX_LANES = 1 << 24
FIELD_LAUNCHES = 3


def buffer_length(size: int) -> int:
    """int32 words of the edit buffer of `size` lanes."""
    return 4 * size + 1


def pack(size: int, xyz: np.ndarray, mats=None) -> np.ndarray:
    """The edit buffer of a batch (int32[n, 3] voxels, uint8[n] materials
    or None) in `size` lanes, on the host; the lanes from n on are zeros."""
    n = xyz.shape[0]
    host = np.zeros(buffer_length(size), dtype=np.int32)
    host[:3 * n] = xyz.reshape(-1)
    if mats is not None:
        host[3 * size:3 * size + n] = mats
    host[4 * size] = n
    return host


def lanes(buf):
    """(xyz int32[size, 3], materials int32[size], live bool[size]) as
    views and device ops over an edit buffer `buf`."""
    s = (buf.numel() - 1) // 4
    live = torch.arange(s, device=buf.device) < buf[4 * s]
    return buf[:3 * s].view(s, 3), buf[3 * s:4 * s], live


def lane_cells(static: GridStatic, xyz):
    """Grid cell ids (Y flipped, Grid.zig:135/:206-211), int64[size], of a
    buffer's coordinates."""
    x, y, z = (xyz[:, i].to(torch.int64) for i in range(3))
    return grid_at(static, x, (static.voxel_dims[1] - 1) - y, z)


def insert(static: GridStatic, arrays: GridArrays, buf, mat_is_diel,
           mat_ir, records=None) -> bool:
    """Insert the live lanes of edit buffer `buf` into `arrays`
    (`core.grid.apply_edits` with the classification `mat_is_diel`,
    `mat_ir`, bool[256] / f32[256] or both None); with `records`, the
    cached `(tables, dist)`, rebuild the conservative field into `dist` and
    lane 3 of `tables` and write the touched cells' rows
    (`ops.trace.refresh_tables_after_insert`). True where it launched the
    kernels, False where it ran the plain body."""
    if buf.device.type == "cpu":
        insert_plain(static, arrays, buf, mat_is_diel, mat_ir, records)
        return False
    dev = buf.device
    _need(dev.type == "cuda", f"unsupported device {dev}")
    args = _launch_args("insert", static, arrays, buf, mat_is_diel, mat_ir,
                        records)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _build.library()
        _build.check(lib.zvt_edit_insert(ctypes.byref(args), stream),
                     "zvt_edit_insert")
        insert.launches += 1
        if records is not None:
            profiling.device_mark("edit_field", dev)
            _build.check(lib.zvt_edit_field(ctypes.byref(args), stream),
                         "zvt_edit_field")
            profiling.device_mark("edit_field", dev)
            insert.launches += FIELD_LAUNCHES
    return True


insert.launches = 0


def remove(static: GridStatic, arrays: GridArrays, buf,
           records=None) -> bool:
    """Clear the live lanes of edit buffer `buf` from `arrays`
    (`core.grid.remove_edits`); with `records`, the cached `(tables,
    dist)`, write the touched cells' rows with the cached field
    (`ops.trace.refresh_tables_after_remove`). True where it launched the
    kernel, False where it ran the plain body."""
    if buf.device.type == "cpu":
        remove_plain(static, arrays, buf, records)
        return False
    dev = buf.device
    _need(dev.type == "cuda", f"unsupported device {dev}")
    args = _launch_args("remove", static, arrays, buf, None, None, records)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_build.library().zvt_edit_remove(ctypes.byref(args),
                                                      stream),
                     "zvt_edit_remove")
    remove.launches += 1
    return True


remove.launches = 0


def insert_plain(static: GridStatic, arrays: GridArrays, buf, mat_is_diel,
                 mat_ir, records=None) -> None:
    """`insert`'s plain body, op by op on any device: the CPU's route and
    the kernels' twin."""
    xyz, mats, live = lanes(buf)
    apply_edits(static, arrays, xyz, mats, live, mat_is_diel, mat_ir)
    if records is not None:
        tables, dist = records
        trace.refresh_tables_after_insert(
            static, arrays, tables, lane_cells(static, xyz), live, dist=dist)


def remove_plain(static: GridStatic, arrays: GridArrays, buf,
                 records=None) -> None:
    """`remove`'s plain body, op by op on any device."""
    xyz, _, live = lanes(buf)
    remove_edits(static, arrays, xyz, live)
    if records is not None:
        tables, dist = records
        trace.refresh_tables_after_remove(
            static, arrays, tables, dist, lane_cells(static, xyz), live)


def scratch_words(cells: int, size: int) -> int:
    """int32 words of an insert's scratch (csrc/edit.cu `Scratch`): the
    summary, touched, fresh and word-slot bitmaps, per-lane and per-slot
    tables, and the field between its passes."""
    words = (cells + 31) // 32
    return ((words + 31) // 32 + 3 * words + size * (BRICK_BITS + 5)
            + (cells + 3) // 4)


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"ops.edit: {what}")


def _tensor(name, t, dev, dtype, numel=None):
    _need(torch.is_tensor(t), f"{name} must be a tensor")
    _need(t.device == dev, f"{name} must be on {dev}, not {t.device}")
    _need(t.dtype == dtype, f"{name} must be {dtype}, not {t.dtype}")
    _need(t.is_contiguous(), f"{name} must be contiguous")
    if numel is not None:
        _need(t.numel() == numel,
              f"{name} must hold {numel} values, not {t.numel()}")
    return t


def _launch_args(op, static, arrays, buf, mat_is_diel, mat_ir, records):
    """The checked `EditArgs` of an edit: every tensor on `buf`'s device,
    of the dtype and length the plain body reads, and contiguous; for an
    insert, its scratch (allocated here, on the current stream: a graph's
    capture takes it from its pool)."""
    dev = buf.device
    cells, alloc = static.cells, static.brick_alloc
    words = alloc * BRICK_WORDS
    size = (buf.numel() - 1) // 4
    _need(buf.dim() == 1 and size >= 1 and buf.numel() == buffer_length(size),
          "the edit buffer must be int32[4 * size + 1]")
    _need(size <= MAX_LANES, f"at most {MAX_LANES} lanes a buffer")
    _need(max(static.dims) <= FIELD_TILE,
          f"grid dimensions of at most {FIELD_TILE} cells")
    _need(alloc >= 1 and cells < 2 ** 31, "a grid of fewer than 2**31 cells")
    a = arrays
    i32 = torch.int32
    held = dict(
        buf=_tensor("buf", buf, dev, i32),
        statuses=_tensor("statuses", a.statuses, dev, i32, (cells + 31) // 32),
        indices=_tensor("indices", a.indices, dev, i32, cells),
        occupancy=_tensor("occupancy", a.occupancy, dev, i32, words),
        start_indices=_tensor("start_indices", a.start_indices, dev, i32,
                              alloc),
        material_indices=_tensor("material_indices", a.material_indices,
                                 dev, torch.uint8),
        active_bricks=_tensor("active_bricks", a.active_bricks, dev, i32, 1),
        material_cursor=_tensor("material_cursor", a.material_cursor, dev,
                                i32, 1),
        diel_mask=_tensor("diel_mask", a.diel_mask, dev, i32, words),
        brick_ir=_tensor("brick_ir", a.brick_ir, dev, torch.float32, alloc))
    _need((mat_is_diel is None) == (mat_ir is None),
          "mat_is_diel and mat_ir go together")
    if mat_is_diel is not None:
        held["mat_is_diel"] = _tensor("mat_is_diel", mat_is_diel, dev,
                                      torch.bool, 256)
        held["mat_ir"] = _tensor("mat_ir", mat_ir, dev, torch.float32, 256)
    if records is not None:
        tables, dist = records
        held["tables"] = _tensor("tables", tables, dev, i32, cells * 8)
        _need(tables.dim() == 2 and tables.data_ptr() % 16 == 0,
              "tables must be int32[cells, 8], 16-byte aligned")
        held["dist"] = _tensor("dist", dist, dev, i32, cells)
    if op == "insert":
        held["scratch"] = torch.empty(scratch_words(cells, size), dtype=i32,
                                      device=dev)
    args = _build.EditArgs(
        size=size, material_bytes=a.material_indices.numel(), cells=cells,
        brick_alloc=alloc,
        **{name: t.data_ptr() for name, t in held.items()})
    args.dims[:] = static.dims
    # the tensors stay alive with the args until the launches are enqueued
    args.held = held
    return args
