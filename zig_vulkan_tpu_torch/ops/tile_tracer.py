"""First-hit traversal entry point: the wrapper over kernel A.

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

Every build takes a queue of lanes (`ops.trace.LaneQueue`, filled by
kernel D): the launch then traces only the queued lanes and leaves the
others' outputs unwritten. The frame's bounce levels pass one after their
first scatter launch; every other caller passes none and gets every lane.

For tensors on the CPU the wrapper runs the plain torch version,
`grid_hit_plain`. For CUDA tensors it launches kernel A or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.grid import GridStatic
from .trace import _grid_hit_soa, shadow_dirs, trace_constants

_RAY_FIELDS = ("ox", "oy", "oz", "dx", "dy", "dz")
_OUT_FIELDS = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")

_BUILDS = ("default", "shadow", "stats", "shadow+stats", "exact",
           "exact+shadow", "exact+stats", "exact+shadow+stats")


def _build_name(shadow: bool, stats: bool, use_skip: bool = True) -> str:
    flags = (("exact", not use_skip), ("shadow", shadow), ("stats", stats))
    return "+".join(name for name, on in flags if on) or "default"


def grid_hit_plain(static: GridStatic, tables, material_indices,
                   ox, oy, oz, dx, dy, dz, active, ray_key=None,
                   max_steps: int = 768, shadow_targets=None,
                   stats: bool = False, use_skip: bool = True, queue=None):
    """The plain torch version of every build of kernel A: the traversal
    twin `ops.trace._grid_hit_soa`, run a second time for the sun rays of
    the lanes that hit when `shadow_targets` is given. With a `queue` it
    runs on the queued lanes, gathered, and scatters their results back;
    the other lanes' outputs are 0 (the kernel leaves them unwritten)."""
    if queue is not None:
        lanes = queue.host_lanes()

        def pick(a):
            return None if a is None else a[lanes]

        sub = grid_hit_plain(
            static, tables, material_indices,
            *(a[lanes] for a in (ox, oy, oz, dx, dy, dz)), active[lanes],
            ray_key=pick(ray_key), max_steps=max_steps,
            shadow_targets=(None if shadow_targets is None
                            else tuple(pick(a) for a in shadow_targets)),
            stats=stats, use_skip=use_skip)
        out = {}
        for k, v in sub.items():
            out[k] = torch.zeros(ox.shape[0], dtype=v.dtype, device=v.device)
            out[k][lanes] = v
        return out
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
                   stats: bool = False, use_skip: bool = True, queue=None):
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
      queue: optional `ops.trace.LaneQueue`: only its lanes are traced
        (each as without a queue, `active` included), and only their
        entries of the outputs are written.

    Returns dict(found bool, t, px, py, pz, nx, ny, nz f32, index int32),
    each of shape [N].
    """
    rays = (ox, oy, oz, dx, dy, dz)
    if tables.device.type == "cpu":
        return grid_hit_plain(static, tables, material_indices, *rays,
                              active, ray_key=ray_key, max_steps=max_steps,
                              shadow_targets=shadow_targets, stats=stats,
                              use_skip=use_skip, queue=queue)
    if tables.device.type != "cuda":
        raise ValueError(f"grid_hit_tiles: unsupported device {tables.device}")
    return _launch(static, tables, material_indices, rays, active, ray_key,
                   max_steps, shadow_targets, stats, use_skip, queue)


# kernel A launches, in all and per build (_BUILDS); counted only where the
# kernel is launched
grid_hit_tiles.launches = 0
grid_hit_tiles.build_launches = dict.fromkeys(_BUILDS, 0)


def reset_launch_counts() -> None:
    grid_hit_tiles.launches = 0
    for name in grid_hit_tiles.build_launches:
        grid_hit_tiles.build_launches[name] = 0


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"grid_hit_tiles: {name} must be {dtype}{list(shape)} on {device}, "
            f"got {t.dtype}{list(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"grid_hit_tiles: {name} must be contiguous")


def _launch(static, tables, material_indices, rays, active, ray_key,
            max_steps, shadow_targets, stats, use_skip, queue):
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
    shadow = shadow_targets is not None
    if shadow:
        if len(shadow_targets) != 3:
            raise ValueError("grid_hit_tiles: shadow_targets is (tx, ty, tz)")
        for name, a in zip(("tx", "ty", "tz"), shadow_targets):
            _check(name, a, torch.float32, (n,), dev)
    if queue is not None:
        _check("queue.lanes", queue.lanes, torch.int32, (n,), dev)
        _check("queue.count", queue.count, torch.int32, (1,), dev)

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
    p.use_skip = int(bool(use_skip))
    p.n = n

    out = {name: torch.empty(n, dtype=torch.float32, device=dev)
           for name in _OUT_FIELDS}
    out["found"] = torch.empty(n, dtype=torch.bool, device=dev)
    out["index"] = torch.empty(n, dtype=torch.int32, device=dev)
    if shadow:
        out["occluded"] = torch.empty(n, dtype=torch.bool, device=dev)
    if stats:
        out["n_step"] = torch.empty(n, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if n == 0:
        return out  # nothing to launch
    if n > 2**31 - 129:
        raise ValueError("grid_hit_tiles: kernel A takes fewer than 2^31 - "
                         "128 lanes")
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.zvt_traverse(
            p, tables.data_ptr(), material_indices.data_ptr(),
            *(a.data_ptr() for a in rays), ptr(ray_key), active.data_ptr(),
            *(ptr(a) for a in (shadow_targets or (None, None, None))),
            *(out[name].data_ptr() for name in _OUT_FIELDS),
            ptr(out.get("occluded")), ptr(out.get("n_step")),
            *((None, None) if queue is None
              else (queue.lanes.data_ptr(), queue.count.data_ptr())),
            stream)
    _build.check(status, "zvt_traverse")
    grid_hit_tiles.launches += 1
    grid_hit_tiles.build_launches[_build_name(shadow, stats, use_skip)] += 1
    return out
