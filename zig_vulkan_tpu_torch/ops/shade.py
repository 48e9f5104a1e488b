"""The trace's shading glue as three kernels: camera rays, shade, resolve.

The JAX package runs a frame as one `jax.jit` program, and XLA fuses the
elementwise work around its two Pallas kernels into a few fusions: the
camera rays (`zig_vulkan_tpu/ops/trace.py:_camera_rays_soa`), the body of
each bounce level of `_ray_color_soa` and the background, tone map and
sample resolve of `_ray_color_soa` and `render_rows`. This module holds
their counterparts, one hand-written CUDA kernel each, with the wrappers
`ops.trace` calls:

- kernel C, `camera_rays` (csrc/camera.cu): the wavefront's origins and
  normalized directions, all samples in one launch, and, for the
  sun_in_kernel build of kernel A, the first level's sun targets;
- kernel D, `shade` (csrc/shade.cu), one launch a bounce level after
  kernels A and B: the scatter, the emissive and sun terms and the
  ray-state update, in place, plus what the level's shadow launch and the
  next level read;
- kernel E, `resolve` (csrc/resolve.cu): the last sun term, the sky, the
  tone map, and the samples' sum, division and square root.

The module has no JAX counterpart. A level runs A scatter -> B -> D -> A
shadow; D also fills the queues of live lanes that the later launches of
A, B and D take (`ops.trace._trace_levels`, `zeroed_counts`). With a shadow
launch (the sun on, not traced in kernel A), a level's lit term needs that
launch's `occluded`, so D writes it as a pending term that the next
level's D (or E, after the last level) adds, where the sun ray was not
occluded, before its own terms: each lane's float adds keep the order of
`_ray_color_soa` (colour + emitted, then + lit, level after level).

The ray state is a dict of f32[N] (int32, bool) tensors (`new_state`):
origin and direction (`RAY_KEYS`), `internal_refl`, `ignore_type`,
`loop_count`, `bouncing`, the colour `cr, cg, cb` and, with a shadow
launch, the pending term `pr, pg, pb`. `shade` updates it in place on
every device.

Each wrapper runs its plain torch twin (`camera_rays_plain`, `shade_plain`,
`resolve_plain`: the torch code the frame ran before, moved here) for
tensors on the CPU, and launches its kernel or raises for CUDA tensors.
Each counts its kernel's launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..core.materials import (
    MAT_DIELECTRIC,
    MAT_EMISSIVE,
    MAT_LAMBERTIAN,
    MAT_METAL,
    MAT_NONE,
)
from . import rng
from . import trace as trace_mod

F32 = torch.float32
RAY_KEYS = ("ox", "oy", "oz", "dx", "dy", "dz")
TARGET_KEYS = ("tx", "ty", "tz")
SHADOW_KEYS = ("shx", "shy", "shz")
PENDING_KEYS = ("pr", "pg", "pb")
COLOUR_KEYS = ("cr", "cg", "cb")
_STATE_TYPES = dict(dict.fromkeys(RAY_KEYS + COLOUR_KEYS, F32),
                    internal_refl=F32, ignore_type=torch.int32,
                    loop_count=torch.int32, bouncing=torch.bool)
_HIT_KEYS = ("found", "px", "py", "pz", "nx", "ny", "nz")

# how a level gets its sun term (kernel D's `sun`)
SUN_OFF = 0       # no sun: the diffuse term is the albedo
SUN_PROBE = 1     # the sun ray traced by kernel A's scatter launch
SUN_DEFERRED = 2  # a shadow launch of kernel A after kernel D


def sun_mode(sun_enabled: bool, shadow_probe: bool) -> int:
    if not sun_enabled:
        return SUN_OFF
    return SUN_PROBE if shadow_probe else SUN_DEFERRED


def _radius(sun_radius):
    return sun_radius if torch.is_tensor(sun_radius) else np.float32(
        sun_radius)


def new_state(rays: dict, mode: int) -> dict:
    """The ray state of a wavefront before its first level: the rays'
    tensors themselves (updated in place from then on), no colour, no
    dielectric, every lane bouncing."""
    ox = rays["ox"]
    n, dev = ox.shape[0], ox.device
    state = {k: rays[k] for k in RAY_KEYS}
    state.update(
        internal_refl=torch.ones(n, dtype=F32, device=dev),
        ignore_type=torch.full((n,), MAT_NONE, dtype=torch.int32, device=dev),
        loop_count=torch.zeros(n, dtype=torch.int32, device=dev),
        bouncing=torch.ones(n, dtype=torch.bool, device=dev),
        **{k: torch.zeros(n, dtype=F32, device=dev) for k in COLOUR_KEYS})
    if mode == SUN_DEFERRED:
        # written by the first level before any level reads them
        state.update({k: torch.empty(n, dtype=F32, device=dev)
                      for k in PENDING_KEYS})
    return state


# -- kernel C: camera rays ------------------------------------------------------

def camera_rays_plain(cam: dict, width: int, height: int, spp: int = 1,
                      sample_base=0.0, row0=0, rows=None, sun=None) -> dict:
    """The plain torch version of kernel C: `spp` samples of
    `ops.trace._camera_rays_soa` (sample s seeded by sample_base + s in
    float32), concatenated, directions normalized; with `sun` =
    (sun_position, sun_radius) also the lanes' sun targets
    (`ops.trace.sun_targets`)."""
    w, h = int(width), int(height)
    rows = h if rows is None else int(rows)
    if torch.is_tensor(sample_base):
        seeds = [sample_base + trace_mod._c(s) for s in range(spp)]
    else:
        seeds = [np.float32(np.float32(sample_base) + np.float32(s))
                 for s in range(spp)]
    samples = [trace_mod._camera_rays_soa(cam, w, h, seed, row0=row0,
                                          rows=rows) for seed in seeds]
    ox, oy, oz, dx, dy, dz = (torch.cat([sm[i] for sm in samples])
                              for i in range(6))
    dx, dy, dz = trace_mod._norm3(dx, dy, dz)
    out = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz)
    if sun is not None:
        out.update(zip(TARGET_KEYS, trace_mod.sun_targets(
            dx, dy, dz, trace_mod._vec3(sun[0]), _radius(sun[1]))))
    return out


def camera_rays(cam: dict, width: int, height: int, spp: int = 1,
                sample_base=0.0, row0=0, rows=None, sun=None) -> dict:
    """The camera rays of a band of `rows` image rows from `row0` (the
    whole frame by default), all `spp` samples, sample-major:
    {ox, oy, oz, dx, dy, dz} f32[spp * rows * width] each, contiguous,
    directions normalized; with `sun` = (sun_position, sun_radius) also
    {tx, ty, tz}, the lanes' sun targets. `cam` holds the four f32[3]
    camera vectors (`ops.trace.camera_vectors`, `basis_views`);
    `sample_base` and the sun values are host values or tensors on the
    camera's device."""
    dev = cam["origin"].device
    if dev.type == "cpu":
        return camera_rays_plain(cam, width, height, spp, sample_base, row0,
                                 rows, sun)
    if dev.type != "cuda":
        raise ValueError(f"camera_rays: unsupported device {dev}")
    return _launch_camera(cam, width, height, spp, sample_base, row0, rows,
                          sun)


camera_rays.launches = 0


# -- kernel D: one bounce level's shading ---------------------------------------

def zeroed_counts(k: int, device) -> torch.Tensor:
    """int32[k] zeros on `device`: the count slots of a wavefront's lane
    queues. On a card one memset (a memset node in a captured graph), no
    host value."""
    counts = torch.empty(k, dtype=torch.int32, device=device)
    if counts.device.type != "cuda":
        return counts.zero_()
    lib = _build.library()
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream(counts.device).cuda_stream
        _build.check(lib.zvt_zero(counts.data_ptr(), 4 * k, stream),
                     "zvt_zero")
    return counts


def _append(queue, take) -> None:
    """Append the lanes where `take` to `queue`, in lane order (the
    plain version of kernel D's appends)."""
    ids = torch.nonzero(take).reshape(-1).to(torch.int32)
    c = int(queue.count[0])
    queue.lanes[c:c + ids.numel()] = ids
    queue.count[0] = c + ids.numel()


def shade_plain(state: dict, hit: dict, looked, mode: int,
                sun_position=None, sun_color=None, sun_radius=None,
                prev_occluded=None, next_key: bool = False,
                next_targets: bool = False, next_queue=None,
                shadow_queue=None, queue=None) -> dict:
    """The plain torch version of kernel D (the body of a bounce level of
    `_ray_color_soa`, brick_raytracer.comp:203-259); see `shade`. With a
    `queue` it shades the queued lanes, gathered, and scatters them back;
    the other lanes' outputs are 0 (the kernel leaves them unwritten)."""
    sun = (sun_position, sun_color, sun_radius)
    if queue is None:
        out = _shade_lanes(state, hit, looked, mode, *sun, prev_occluded,
                           next_key, next_targets)
        bouncing = state["bouncing"]
    else:
        lanes = queue.host_lanes()
        n = state["ox"].shape[0]
        sub = {k: v[lanes] for k, v in state.items()}
        picked = _shade_lanes(
            sub, {k: v[lanes] for k, v in hit.items()},
            tuple(t[lanes] for t in looked), mode, *sun,
            None if prev_occluded is None else prev_occluded[lanes],
            next_key, next_targets)
        for k, v in sub.items():
            state[k][lanes] = v
        out = {}
        for k, v in picked.items():
            out[k] = torch.zeros(n, dtype=v.dtype, device=v.device)
            out[k][lanes] = v
        bouncing = torch.zeros(n, dtype=torch.bool, device=lanes.device)
        bouncing[lanes] = sub["bouncing"]
    if next_queue is not None:
        _append(next_queue, bouncing)
    if shadow_queue is not None:
        _append(shadow_queue, out["active"])
    return out


def _shade_lanes(state: dict, hit: dict, looked, mode: int, sun_position,
                 sun_color, sun_radius, prev_occluded, next_key: bool,
                 next_targets: bool) -> dict:
    """`shade_plain` over every lane of `state`, without the appends."""
    s = state
    ox, oy, oz, dx, dy, dz = (s[k] for k in RAY_KEYS)
    internal_refl, ignore_type = s["internal_refl"], s["ignore_type"]
    n, dev = ox.shape[0], ox.device
    zf = torch.zeros(n, dtype=F32, device=dev)
    active = s["bouncing"] & hit["found"]

    ar, ag, ab, mtype_f, type_data = looked
    mtype = mtype_f.to(torch.int32)
    is_emissive = mtype == MAT_EMISSIVE
    known = (mtype <= MAT_DIELECTRIC) | is_emissive
    loop_count = s["loop_count"] + (active & known).to(torch.int32)

    px, py, pz = hit["px"], hit["py"], hit["pz"]
    nx, ny, nz = hit["nx"], hit["ny"], hit["nz"]
    cox = px + pz
    coy = py + pz

    # lambertian (brick_raytracer.comp:539-544)
    rx, ry, rz = trace_mod._rand_vec3_range_soa(cox, coy, -0.4, 0.4)
    lamx, lamy, lamz = trace_mod._norm3(nx + rx, ny + ry, nz + rz)

    # metal (brick_raytracer.comp:546-551)
    dn = trace_mod._dot3(dx, dy, dz, nx, ny, nz)
    refx = dx - 2.0 * dn * nx
    refy = dy - 2.0 * dn * ny
    refz = dz - 2.0 * dn * nz
    fuzz = type_data
    mx, my, mz = trace_mod._rand_vec3_range_soa(cox, coy, -fuzz, fuzz)
    metx, mety, metz = trace_mod._norm3(refx + mx, refy + my, refz + mz)
    met_ok = trace_mod._dot3(metx, mety, metz, nx, ny, nz) > 0

    # dielectric (brick_raytracer.comp:576-596)
    ex, ey, ez = trace_mod._rand_vec3_range_soa(cox, coy, -0.05, 0.05)
    dnx, dny, dnz = trace_mod._norm3(nx + ex, ny + ey, nz + ez)
    ir = type_data
    eta = ir / internal_refl
    c1 = -trace_mod._dot3(dx, dy, dz, dnx, dny, dnz)
    w = eta * c1
    c2m = (w - eta) * (w + eta)
    should_refract = c2m >= -1.0
    wk = w - torch.sqrt(torch.clamp(1.0 + c2m, min=0.0))
    tx = eta * dx + wk * dnx
    ty = eta * dy + wk * dny
    tz = eta * dz + wk * dnz
    rnd = rng.rand3(torch.stack([px, py, pz], dim=-1))
    do_refract = should_refract & (rnd > 0.5)
    ddn = trace_mod._dot3(dx, dy, dz, dnx, dny, dnz)
    rfx = dx - 2.0 * ddn * dnx
    rfy = dy - 2.0 * ddn * dny
    rfz = dz - 2.0 * ddn * dnz
    diex, diey, diez = trace_mod._norm3(
        torch.where(do_refract, tx, rfx),
        torch.where(do_refract, ty, rfy),
        torch.where(do_refract, tz, rfz))

    is_lam = mtype == MAT_LAMBERTIAN
    is_met = mtype == MAT_METAL
    is_die = mtype == MAT_DIELECTRIC
    sdx = torch.where(is_lam, lamx, torch.where(is_met, metx, diex))
    sdy = torch.where(is_lam, lamy, torch.where(is_met, mety, diey))
    sdz = torch.where(is_lam, lamz, torch.where(is_met, metz, diez))
    # emissive paths terminate (superset; see core.materials)
    result = is_lam | (is_met & met_ok) | (~is_lam & ~is_met & is_die)
    refracted = is_die & do_refract
    new_ignore = torch.where(refracted, MAT_DIELECTRIC,
                             MAT_NONE).to(torch.int32)
    new_internal = torch.where(refracted, ir, 1.0)

    cr, cg, cb = (s[k] for k in COLOUR_KEYS)
    if prev_occluded is not None:
        # the previous level's lit term, now that its shadow ray is traced
        cr = cr + torch.where(prev_occluded, zf, s["pr"])
        cg = cg + torch.where(prev_occluded, zf, s["pg"])
        cb = cb + torch.where(prev_occluded, zf, s["pb"])
    # emissive contribution: albedo * strength, unshadowed
    emit = active & is_emissive
    cr = cr + torch.where(emit, ar * type_data, zf)
    cg = cg + torch.where(emit, ag * type_data, zf)
    cb = cb + torch.where(emit, ab * type_data, zf)
    sun_or_diffuse = active & ~is_emissive

    out = {}
    if mode == SUN_OFF:
        cr = cr + torch.where(sun_or_diffuse, ar, zf)
        cg = cg + torch.where(sun_or_diffuse, ag, zf)
        cb = cb + torch.where(sun_or_diffuse, ab, zf)
    else:
        sun_c = trace_mod._vec3(sun_color)
        if mode == SUN_PROBE:
            lit = sun_or_diffuse & ~hit["occluded"]
            cr = cr + torch.where(lit, ar * sun_c[0], zf)
            cg = cg + torch.where(lit, ag * sun_c[1], zf)
            cb = cb + torch.where(lit, ab * sun_c[2], zf)
        else:
            s["pr"].copy_(torch.where(sun_or_diffuse, ar * sun_c[0], zf))
            s["pg"].copy_(torch.where(sun_or_diffuse, ag * sun_c[1], zf))
            s["pb"].copy_(torch.where(sun_or_diffuse, ab * sun_c[2], zf))
            # the jittered sun target depends on the incoming direction
            tgt = trace_mod.sun_targets(dx, dy, dz,
                                        trace_mod._vec3(sun_position),
                                        _radius(sun_radius))
            out.update(zip(SHADOW_KEYS, trace_mod.shadow_dirs(hit, tgt)),
                       active=active)

    bouncing = active & result
    new = dict(
        ox=torch.where(active, px, ox), oy=torch.where(active, py, oy),
        oz=torch.where(active, pz, oz), dx=torch.where(bouncing, sdx, dx),
        dy=torch.where(bouncing, sdy, dy), dz=torch.where(bouncing, sdz, dz),
        internal_refl=torch.where(active, new_internal, internal_refl),
        ignore_type=torch.where(active, new_ignore, ignore_type),
        loop_count=loop_count, bouncing=bouncing, cr=cr, cg=cg, cb=cb)
    if next_key:
        # per-ray dielectric skip key of the next level: NaN (skip
        # nothing) unless the ray was refracted (brick_raytracer.comp:427)
        nan = torch.full((n,), float("nan"), dtype=F32, device=dev)
        out["key"] = torch.where(new["ignore_type"] == MAT_DIELECTRIC,
                                 new["internal_refl"], nan)
    if next_targets:
        out.update(zip(TARGET_KEYS, trace_mod.sun_targets(
            new["dx"], new["dy"], new["dz"], trace_mod._vec3(sun_position),
            _radius(sun_radius))))
    for k, v in new.items():
        s[k].copy_(v)
    return out


def shade(state: dict, hit: dict, looked, mode: int, sun_position=None,
          sun_color=None, sun_radius=None, prev_occluded=None,
          next_key: bool = False, next_targets: bool = False,
          next_queue=None, shadow_queue=None, queue=None) -> dict:
    """Shade one bounce level: update `state` (`new_state`'s dict) in place
    from kernel A's hit `hit` (found, px..pz, nx..nz; `occluded` with
    SUN_PROBE) and kernel B's `looked` = (albedo r, g, b, mtype, type_data),
    f32[N] each.

    `mode` is `sun_mode(...)`; the sun values (f32[3] position and colour,
    the radius; host values or tensors on the state's device) are read
    unless it is SUN_OFF. With SUN_DEFERRED the level's lit term goes to the
    state's pending term, and `prev_occluded` (the previous level's shadow
    hits, bool[N]; None at the first level) adds the previous one first.

    Returns the tensors the next launches read: with SUN_DEFERRED the shadow
    launch's mask `active` (bool) and directions `shx, shy, shz`; with
    `next_key` the next level's dielectric key `key` (the ir of a refracted
    ray, NaN otherwise); with `next_targets` the next level's sun targets
    `tx, ty, tz`.

    `next_queue` and `shadow_queue` (`ops.trace.LaneQueue`s, or None)
    gain the lanes left bouncing and (SUN_DEFERRED) the lanes of the
    shadow mask `active`: the next scatter launch's and this level's shadow
    launch's lanes. Each lane is appended once, after the count's value;
    the plain version appends in lane order, the kernel in the order it
    shades them (lane order, or the order of `queue`) within each block of
    256. Since the launches read only their queue's lanes, the kernel then
    writes `shx, shy, shz` only for the lanes of the shadow queue, and
    `key` and `tx, ty, tz` only for those of the next queue (the plain
    version writes every lane it shades).

    `queue` (a `LaneQueue`, or None: every lane) holds the lanes this level
    shades: the other lanes are neither read nor written, the outputs
    included (the plain version's are 0 there). Shading a lane that is not
    bouncing and has no pending term (0, or a `prev_occluded` hit) changes
    nothing, so a level after the first may take the lanes the previous
    level marked active (with SUN_DEFERRED) or left bouncing: the state and
    the queued outputs are those of a launch over every lane, bit for
    bit."""
    if shadow_queue is not None and mode != SUN_DEFERRED:
        raise ValueError("shade: a shadow queue comes with a shadow launch")
    dev = state["ox"].device
    if dev.type == "cpu":
        return shade_plain(state, hit, looked, mode, sun_position, sun_color,
                           sun_radius, prev_occluded, next_key, next_targets,
                           next_queue, shadow_queue, queue)
    if dev.type != "cuda":
        raise ValueError(f"shade: unsupported device {dev}")
    return _launch_shade(state, hit, looked, mode, sun_position, sun_color,
                         sun_radius, prev_occluded, next_key, next_targets,
                         next_queue, shadow_queue, queue)


shade.launches = 0


# -- kernel E: the resolve ------------------------------------------------------

def resolve_plain(state: dict, spp: int, sun_color=None, occluded=None,
                  gamma: bool = True):
    """The plain torch version of kernel E (the background and tone map of
    `_ray_color_soa`, the resolve of `render_rows`); see `resolve`."""
    cr, cg, cb = (state[k] for k in COLOUR_KEYS)
    n, dev = cr.shape[0], cr.device
    zf = torch.zeros(n, dtype=F32, device=dev)
    if occluded is not None:
        # the last level's lit term
        cr = cr + torch.where(occluded, zf, state["pr"])
        cg = cg + torch.where(occluded, zf, state["pg"])
        cb = cb + torch.where(occluded, zf, state["pb"])
    # background for never-hit rays (brick_raytracer.comp:260-262); a ray
    # that never hits never bounces and keeps its camera direction
    never = state["loop_count"] == 0
    t = 0.5 * (state["dy"] + 1.0)
    bgr = (1.0 - t) + t * 0.5
    bgg = (1.0 - t) + t * trace_mod._c(0.7)
    bgb = (1.0 - t) + t * 1.0
    if sun_color is not None:
        sun_c = trace_mod._vec3(sun_color)
        bgr, bgg, bgb = bgr * sun_c[0], bgg * sun_c[1], bgb * sun_c[2]
    cr = cr + torch.where(never, bgr, zf)
    cg = cg + torch.where(never, bgg, zf)
    cb = cb + torch.where(never, bgb, zf)
    # color/(color+1) tone map (brick_raytracer.comp:264)
    color = torch.stack([cr / (cr + 1.0), cg / (cg + 1.0),
                         cb / (cb + 1.0)], dim=-1)
    if not gamma:
        return color
    # the samples summed in order (for spp <= 2 what `sum(dim=0)` gives;
    # the JAX package's order, trace.py:1444-1461, for any spp)
    color = color.reshape(spp, n // spp, 3)
    total = color[0]
    for k in range(1, spp):
        total = total + color[k]
    return torch.sqrt(trace_mod._div(total, spp))


def resolve(state: dict, spp: int, sun_color=None, occluded=None,
            gamma: bool = True):
    """The pixels of a traced wavefront of `spp` samples (`state` after its
    last level): f32[N / spp, 3], the square root of the mean over the
    samples of each lane's tone-mapped colour, sky added where the ray never
    hit (scaled by `sun_color` when given: the sun is on). `occluded` (the
    last level's shadow hits, with the state's pending term) adds the last
    lit term first. `gamma=False` (spp 1) returns each lane's tone-mapped
    colour, f32[N, 3]."""
    if not gamma and spp != 1:
        raise ValueError("resolve: per-lane colours are one sample")
    dev = state["cr"].device
    if dev.type == "cpu":
        return resolve_plain(state, spp, sun_color, occluded, gamma)
    if dev.type != "cuda":
        raise ValueError(f"resolve: unsupported device {dev}")
    return _launch_resolve(state, spp, sun_color, occluded, gamma)


resolve.launches = 0


def reset_launch_counts() -> None:
    for fn in (camera_rays, shade, resolve):
        fn.launches = 0


# -- the launches ---------------------------------------------------------------

def _check(fn, name, t, dtype, n, device):
    if (t.device != device or t.dtype != dtype or t.dim() != 1
            or t.shape[0] != n):
        raise ValueError(f"{fn}: {name} must be {dtype}[{n}] on {device}, "
                         f"got {t.dtype}{list(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _frame_value(fn, name, v, count, device):
    """(device pointer or None, host floats) of a per-frame value: a tensor
    of `count` float32 on `device`, or host values."""
    if torch.is_tensor(v):
        if (v.device != device or v.dtype != F32 or v.numel() != count
                or not v.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be {count} contiguous "
                             f"float32 on {device}, got {v.dtype}"
                             f"{list(v.shape)} on {v.device}")
        return v.data_ptr(), [0.0] * count
    vals = np.asarray(v, dtype=np.float32).reshape(-1)
    if vals.size != count:
        raise ValueError(f"{fn}: {name} must hold {count} values")
    return None, [float(x) for x in vals]


def _call(entry, args, device, counter):
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, entry)(ctypes.byref(args), stream)
    _build.check(status, entry)
    counter.launches += 1


def _launch_camera(cam, width, height, spp, sample_base, row0, rows, sun):
    dev = cam["origin"].device
    w, h = int(width), int(height)
    rows = h if rows is None else int(rows)
    for name in trace_mod.CAMERA_BASIS:
        _check("camera_rays", name, cam[name], F32, 3, dev)
    n = int(spp) * rows * w
    keys = RAY_KEYS + (TARGET_KEYS if sun is not None else ())
    out = {k: torch.empty(n, dtype=F32, device=dev) for k in keys}
    a = _build.CameraArgs()
    a.origin, a.horizontal, a.vertical, a.lower_left = (
        cam[name].data_ptr() for name in trace_mod.CAMERA_BASIS)
    a.base_ptr, (a.base,) = _frame_value("camera_rays", "sample_base",
                                         sample_base, 1, dev)
    if sun is not None:
        a.sun_p_ptr, a.sun_p[:] = _frame_value("camera_rays", "sun_position",
                                               sun[0], 3, dev)
        a.radius_ptr, (a.radius,) = _frame_value("camera_rays", "sun_radius",
                                                 sun[1], 1, dev)
    for k in keys:
        setattr(a, k, out[k].data_ptr())
    a.n, a.width, a.rows, a.spp = n, w, rows, int(spp)
    a.row0, a.w1, a.h1 = (trace_mod._c(v) for v in (row0, w - 1, h - 1))
    if n == 0:
        return out  # nothing to launch
    if n >= 2**31:
        raise ValueError("camera_rays: kernel C takes fewer than 2^31 lanes")
    _call("zvt_camera_rays", a, dev, camera_rays)
    return out


def _launch_shade(state, hit, looked, mode, sun_position, sun_color,
                  sun_radius, prev_occluded, next_key, next_targets,
                  next_queue, shadow_queue, queue):
    dev = state["ox"].device
    n = state["ox"].shape[0]
    for k, dtype in _STATE_TYPES.items():
        _check("shade", k, state[k], dtype, n, dev)
    for k in _HIT_KEYS:
        _check("shade", k, hit[k], torch.bool if k == "found" else F32, n,
               dev)
    if len(looked) != 5:
        raise ValueError("shade: looked is (r, g, b, mtype, type_data)")
    for k, t in zip(("albedo_r", "albedo_g", "albedo_b", "mtype",
                     "type_data"), looked):
        _check("shade", k, t, F32, n, dev)
    if mode not in (SUN_OFF, SUN_PROBE, SUN_DEFERRED):
        raise ValueError(f"shade: unknown sun mode {mode}")
    if mode == SUN_PROBE:
        _check("shade", "occluded", hit["occluded"], torch.bool, n, dev)
    if mode == SUN_DEFERRED:
        for k in PENDING_KEYS:
            _check("shade", k, state[k], F32, n, dev)
    if prev_occluded is not None:
        if mode != SUN_DEFERRED:
            raise ValueError("shade: prev_occluded comes with a shadow launch")
        _check("shade", "prev_occluded", prev_occluded, torch.bool, n, dev)
    if next_targets and mode != SUN_PROBE:
        raise ValueError("shade: next targets are for the sun_in_kernel "
                         "build")
    for name, q in (("next_queue", next_queue),
                    ("shadow_queue", shadow_queue), ("queue", queue)):
        if q is not None:
            _check("shade", f"{name}.lanes", q.lanes, torch.int32, n, dev)
            _check("shade", f"{name}.count", q.count, torch.int32, 1, dev)

    out = {}
    if mode == SUN_DEFERRED:
        out["active"] = torch.empty(n, dtype=torch.bool, device=dev)
        out.update({k: torch.empty(n, dtype=F32, device=dev)
                    for k in SHADOW_KEYS})
    if next_key:
        out["key"] = torch.empty(n, dtype=F32, device=dev)
    if next_targets:
        out.update({k: torch.empty(n, dtype=F32, device=dev)
                    for k in TARGET_KEYS})

    a = _build.ShadeArgs()
    for k in _HIT_KEYS:
        setattr(a, k, hit[k].data_ptr())
    a.albedo_r, a.albedo_g, a.albedo_b, a.mtype, a.type_data = (
        t.data_ptr() for t in looked)
    for k in _STATE_TYPES:
        setattr(a, k, state[k].data_ptr())
    for k, t in out.items():
        setattr(a, k, t.data_ptr())
    if mode == SUN_PROBE:
        a.occluded = hit["occluded"].data_ptr()
    if mode == SUN_DEFERRED:
        a.pr, a.pg, a.pb = (state[k].data_ptr() for k in PENDING_KEYS)
    if prev_occluded is not None:
        a.prev_occluded = prev_occluded.data_ptr()
    if next_queue is not None:
        a.next_queue = next_queue.lanes.data_ptr()
        a.next_count = next_queue.count.data_ptr()
    if shadow_queue is not None:
        a.shadow_queue = shadow_queue.lanes.data_ptr()
        a.shadow_count = shadow_queue.count.data_ptr()
    if queue is not None:
        a.in_queue = queue.lanes.data_ptr()
        a.in_count = queue.count.data_ptr()
    if mode != SUN_OFF:
        a.sun_p_ptr, a.sun_p[:] = _frame_value("shade", "sun_position",
                                               sun_position, 3, dev)
        a.sun_c_ptr, a.sun_c[:] = _frame_value("shade", "sun_color",
                                               sun_color, 3, dev)
        a.radius_ptr, (a.radius,) = _frame_value("shade", "sun_radius",
                                                 sun_radius, 1, dev)
    a.n, a.sun = n, mode
    if n == 0:
        return out  # nothing to launch
    if n >= 2**31:
        raise ValueError("shade: kernel D takes fewer than 2^31 lanes")
    _call("zvt_shade", a, dev, shade)
    return out


def _launch_resolve(state, spp, sun_color, occluded, gamma):
    dev = state["cr"].device
    n = state["cr"].shape[0]
    if spp < 1 or n % spp:
        raise ValueError(f"resolve: {n} lanes are not {spp} whole samples")
    for k in COLOUR_KEYS + ("dy",):
        _check("resolve", k, state[k], F32, n, dev)
    _check("resolve", "loop_count", state["loop_count"], torch.int32, n, dev)
    m = n // spp
    out = torch.empty((m, 3), dtype=F32, device=dev)
    a = _build.ResolveArgs()
    a.cr, a.cg, a.cb, a.dy = (state[k].data_ptr()
                              for k in COLOUR_KEYS + ("dy",))
    a.loop_count = state["loop_count"].data_ptr()
    if occluded is not None:
        for k in PENDING_KEYS:
            _check("resolve", k, state[k], F32, n, dev)
        _check("resolve", "occluded", occluded, torch.bool, n, dev)
        a.pr, a.pg, a.pb = (state[k].data_ptr() for k in PENDING_KEYS)
        a.occluded = occluded.data_ptr()
    if sun_color is not None:
        a.sun = 1
        a.sun_c_ptr, a.sun_c[:] = _frame_value("resolve", "sun_color",
                                               sun_color, 3, dev)
    a.out = out.data_ptr()
    a.m, a.spp, a.gamma = m, int(spp), int(bool(gamma))
    if m == 0:
        return out  # nothing to launch
    if m >= 2**31:
        raise ValueError("resolve: kernel E takes fewer than 2^31 pixels")
    _call("zvt_resolve", a, dev, resolve)
    return out
