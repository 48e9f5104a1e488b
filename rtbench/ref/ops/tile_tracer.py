"""First-hit traversal entry point: the wrapper over kernel A.

Frozen copy of `zig_vulkan_tpu_torch/ops/tile_tracer.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

`grid_hit_tiles` keeps the name and the result dict of
`zig_vulkan_tpu.ops.tile_tracer.grid_hit_tiles`, but it has no tiles: the
TPU kernel marched 8x128 ray tiles region by region through VMEM-resident
record blocks, while kernel A (csrc/traverse.cu) runs one CUDA thread per
ray over the per-cell records of `ops.trace.build_trace_tables`. The
region tables, the region vote and the phase budget do not exist here; every
lane retires within `max_steps`, so there is no `unfinished` output and no
retrace.

The TPU kernel's builds map onto kernel A's compile-time variants:

- the default builds (sequential/concurrent serve, with or without the
  dielectric key) -> the default variant (the key is a run-time pointer);
- `shadow=True` (the sun-shadow probe) -> the shadow variant: a thread that
  records a hit traces its own sun ray toward the lane's target and writes
  `occluded`;
- `stats=True` -> the stats variant: `n_step` per lane. The TPU kernel's
  other counter, `n_phase`, counts region parks; a per-ray kernel has none;
- `sparse_roam=True` (roaming through regions of a sprayed scene) changes
  only the TPU kernel's park schedule, not its answer: kernel A computes
  that answer on any scene.

Kernel A has one build more than the TPU kernel: `use_skip=False`, the
exact cell-by-cell DDA of `zig_vulkan_tpu.ops.trace.grid_hit(
use_skip=False)` (an XLA wavefront in the JAX package, where the Pallas
kernel always skips), as the `NO_SKIP` variant of each build above
("exact", "exact+shadow", "exact+stats", "exact+shadow+stats").

For tensors on the CPU the wrapper runs the plain torch version,
`grid_hit_plain`. For CUDA tensors it launches kernel A or raises.
"""

from __future__ import annotations

import torch

from ..core.grid import GridStatic
from .trace import _grid_hit_soa, shadow_dirs

_RAY_FIELDS = ("ox", "oy", "oz", "dx", "dy", "dz")
_OUT_FIELDS = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")

# region edge lengths in grid cells (y, z, x) of the TPU kernel's region
# blocks (zig_vulkan_tpu/ops/tile_tracer.py:98); the engine's roamability
# report counts regions of this size
REGION_CELLS = (4, 16, 16)


_BUILDS = ("default", "shadow", "stats", "shadow+stats", "exact",
           "exact+shadow", "exact+stats", "exact+shadow+stats")


def grid_hit_plain(static: GridStatic, tables, material_indices,
                   ox, oy, oz, dx, dy, dz, active, ray_key=None,
                   max_steps: int = 768, shadow_targets=None,
                   stats: bool = False, use_skip: bool = True):
    """The plain torch version of every build of kernel A: the traversal
    twin `ops.trace._grid_hit_soa`, run a second time for the sun rays of
    the lanes that hit when `shadow_targets` is given."""
    out = _grid_hit_soa(static, tables, material_indices, ox, oy, oz,
                        dx, dy, dz, active, ray_key=ray_key,
                        max_steps=max_steps, stats=stats, use_skip=use_skip)
    if shadow_targets is not None:
        sdx, sdy, sdz = shadow_dirs(out, shadow_targets)
        sh = _grid_hit_soa(static, tables, material_indices, out["px"],
                           out["py"], out["pz"], sdx, sdy, sdz,
                           active & out["found"], max_steps=max_steps,
                           use_skip=use_skip)
        out["occluded"] = sh["found"]
    return out


def grid_hit_tiles(static: GridStatic, tables, material_indices,
                   ox, oy, oz, dx, dy, dz, active, ray_key=None,
                   max_steps: int = 768, shadow_targets=None,
                   stats: bool = False, use_skip: bool = True):
    """First voxel hit for a wavefront of rays.

    Args:
      tables: int32[cells, 8] records (ops.trace.build_trace_tables).
      material_indices: uint8[brick_alloc * 64] material bytes.
      ox..dz: f32[N] ray origins and normalized directions.
      active: bool[N] lanes to trace.
      ray_key: optional f32[N] dielectric key (the ir of a refracted ray,
        NaN otherwise); None skips nothing.
      shadow_targets: optional (tx, ty, tz) f32[N] sun targets
        (ops.trace.sun_targets): each lane that hits also traces the ray
        from its hit point toward its target (no dielectric key) and the
        result gains `occluded`, bool[N].
      stats: the result gains `n_step`, int32[N] loop iterations of the
        first traversal.
      use_skip: False traces the exact cell-by-cell DDA (the `exact`
        builds), which never reads the records' distance lane.

    Returns dict(found bool, t, px, py, pz, nx, ny, nz f32, index int32),
    each of shape [N].
    """
    return grid_hit_plain(static, tables, material_indices,
                          ox, oy, oz, dx, dy, dz, active, ray_key=ray_key,
                          max_steps=max_steps,
                          shadow_targets=shadow_targets, stats=stats,
                          use_skip=use_skip)
