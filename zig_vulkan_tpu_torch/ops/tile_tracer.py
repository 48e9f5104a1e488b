"""First-hit traversal entry point: the wrapper over kernel A.

`grid_hit_tiles` keeps the name and the result dict of
`zig_vulkan_tpu.ops.tile_tracer.grid_hit_tiles`, but it has no tiles: the
TPU kernel marched 8x128 ray tiles region by region through VMEM-resident
record blocks, while kernel A (csrc/traverse.cu) runs one CUDA thread per
ray over the per-cell records of `ops.trace.build_trace_tables`. The
region tables, the region vote and the phase budget do not exist here; every
lane retires within `max_steps`, so there is no `unfinished` output and no
retrace.

For tensors on the CPU the wrapper runs the plain torch version,
`ops.trace._grid_hit_soa`. For CUDA tensors it launches kernel A or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.grid import GridStatic
from .trace import _grid_hit_soa, trace_constants

_RAY_FIELDS = ("ox", "oy", "oz", "dx", "dy", "dz")
_OUT_FIELDS = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")


def grid_hit_tiles(static: GridStatic, tables, material_indices,
                   ox, oy, oz, dx, dy, dz, active, ray_key=None,
                   max_steps: int = 768):
    """First voxel hit for a wavefront of rays.

    Args:
      tables: int32[cells, 8] records (ops.trace.build_trace_tables).
      material_indices: uint8[brick_alloc * 64] material bytes.
      ox..dz: f32[N] ray origins and normalized directions.
      active: bool[N] lanes to trace.
      ray_key: optional f32[N] dielectric key (the ir of a refracted ray,
        NaN otherwise); None skips nothing.

    Returns dict(found bool, t, px, py, pz, nx, ny, nz f32, index int32),
    each of shape [N].
    """
    rays = (ox, oy, oz, dx, dy, dz)
    if tables.device.type == "cpu":
        return _grid_hit_soa(static, tables, material_indices, *rays, active,
                             ray_key=ray_key, max_steps=max_steps)
    if tables.device.type != "cuda":
        raise ValueError(f"grid_hit_tiles: unsupported device {tables.device}")
    return _launch(static, tables, material_indices, rays, active, ray_key,
                   max_steps)


grid_hit_tiles.launches = 0


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"grid_hit_tiles: {name} must be {dtype}{list(shape)} on {device}, "
            f"got {t.dtype}{list(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"grid_hit_tiles: {name} must be contiguous")


def _launch(static, tables, material_indices, rays, active, ray_key,
            max_steps):
    dev = tables.device
    n = rays[0].shape[0]
    _check("tables", tables, torch.int32, (static.cells, 8), dev)
    _check("material_indices", material_indices, torch.uint8,
           tuple(material_indices.shape), dev)
    if material_indices.dim() != 1 or material_indices.numel() == 0:
        raise ValueError("grid_hit_tiles: material_indices must be 1-D, "
                         "non-empty")
    for name, a in zip(_RAY_FIELDS, rays):
        _check(name, a, torch.float32, (n,), dev)
    _check("active", active, torch.bool, (n,), dev)
    if ray_key is not None:
        _check("ray_key", ray_key, torch.float32, (n,), dev)

    k = trace_constants(static)
    p = _build.TraceParams()
    p.g0[:] = [float(v) for v in k["g0"]]
    p.g1[:] = [float(v) for v in k["g1"]]
    p.scale = float(k["scale"])
    p.voxel_scale = float(k["voxel_scale"])
    p.park = float(k["park"])
    p.enter_eps = float(k["enter_eps"])
    p.t_off = float(k["t_off"])
    p.dims[:] = list(static.dims)
    p.cells = static.cells
    p.mat_cap = material_indices.numel() - 1
    p.max_steps = int(max_steps)
    p.n = n

    out = {name: torch.empty(n, dtype=torch.float32, device=dev)
           for name in _OUT_FIELDS}
    out["found"] = torch.empty(n, dtype=torch.bool, device=dev)
    out["index"] = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.zvt_traverse(
            p, tables.data_ptr(), material_indices.data_ptr(),
            *(a.data_ptr() for a in rays),
            None if ray_key is None else ray_key.data_ptr(),
            active.data_ptr(),
            *(out[name].data_ptr() for name in _OUT_FIELDS), stream)
    _build.check(status, "zvt_traverse")
    grid_hit_tiles.launches += 1
    return out
