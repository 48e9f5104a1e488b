"""Small-table lookups: the wrapper over kernel B.

Frozen copy of `zig_vulkan_tpu_torch/ops/lookup.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

The torch counterpart of `zig_vulkan_tpu.ops.lookup.table_lookup`: for each
int32 index, the values of a few float32 tables of one length. The frame
uses it once per bounce level to resolve the material albedo r, g, b,
mtype and type_data of every lane (ops.trace._ray_color_soa).

For tensors on the CPU the wrapper runs the plain torch version. For CUDA
tensors it launches kernel B (csrc/lookup.cu) or raises.
"""

from __future__ import annotations

import torch


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
    return tuple(_table_lookup_plain(tables, idx).unbind(0))
