"""Small-table lookups: the wrapper over kernel B.

The torch counterpart of `zig_vulkan_tpu.ops.lookup.table_lookup`: for each
int32 index, the values of a few float32 tables of one length. The frame
uses it once per bounce level to resolve the material albedo r, g, b,
mtype and type_data of every lane (ops.trace._ray_color_soa).

For tensors on the CPU the wrapper runs the plain torch version. For CUDA
tensors it launches kernel B (csrc/lookup.cu) or raises.
"""

from __future__ import annotations

import torch

from .. import _build

# the tables sit in one block's shared memory (48 KiB without opt-in)
MAX_TABLE_BYTES = 48 * 1024


def _table_lookup_plain(tables, idx):
    """f32[T, N]: tables[t, idx]; 0 where idx is outside [0, size), as the
    Pallas kernel's row select gives."""
    size = tables.shape[1]
    ok = (idx >= 0) & (idx < size)
    vals = tables[:, torch.where(ok, idx, torch.zeros_like(idx)).long()]
    return torch.where(ok, vals, torch.zeros_like(vals))


def table_lookup(tables, idx):
    """Look `idx` (int32[N]) up in `tables` (f32[T, size], one table per
    row). Returns a tuple of T f32[N] tensors."""
    if tables.dim() != 2 or idx.dim() != 1:
        raise ValueError("table_lookup: tables must be [T, size], idx [N]")
    if tables.device.type == "cpu":
        out = _table_lookup_plain(tables, idx)
    elif tables.device.type == "cuda":
        out = _launch(tables, idx)
    else:
        raise ValueError(f"table_lookup: unsupported device {tables.device}")
    return tuple(out.unbind(0))


table_lookup.launches = 0


def _launch(tables, idx):
    dev = tables.device
    if tables.dtype != torch.float32 or not tables.is_contiguous():
        raise ValueError("table_lookup: tables must be contiguous float32")
    if idx.device != dev or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"table_lookup: idx must be contiguous int32 on {dev}")
    n_tables, size = tables.shape
    if tables.numel() * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"table_lookup: tables of {tables.numel() * 4} bytes "
                         f"exceed the {MAX_TABLE_BYTES}-byte shared-memory "
                         f"stage")
    n = idx.shape[0]
    out = torch.empty((n_tables, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out  # nothing to launch
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.zvt_table_lookup(tables.data_ptr(), n_tables, size,
                                      idx.data_ptr(), n, out.data_ptr(),
                                      stream)
    _build.check(status, "zvt_table_lookup")
    table_lookup.launches += 1
    return out
