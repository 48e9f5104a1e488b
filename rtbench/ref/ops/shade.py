"""The trace's shading glue as three kernels: camera rays, shade, resolve.

Frozen copy of `zig_vulkan_tpu_torch/ops/shade.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

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
shadow. With a shadow launch (the sun on, not traced in kernel A), a
level's lit term needs that launch's `occluded`, so D writes it as a
pending term that the next level's D (or E, after the last level) adds,
where the sun ray was not occluded, before its own terms: each lane's
float adds keep the order of `_ray_color_soa` (colour + emitted, then +
lit, level after level).

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

import numpy as np
import torch

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
    return camera_rays_plain(cam, width, height, spp, sample_base, row0,
                             rows, sun)


# -- kernel D: one bounce level's shading ---------------------------------------

def shade_plain(state: dict, hit: dict, looked, mode: int,
                sun_position=None, sun_color=None, sun_radius=None,
                prev_occluded=None, next_key: bool = False,
                next_targets: bool = False) -> dict:
    """The plain torch version of kernel D (the body of a bounce level of
    `_ray_color_soa`, brick_raytracer.comp:203-259); see `shade`."""
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
          next_key: bool = False, next_targets: bool = False) -> dict:
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
    `tx, ty, tz`."""
    return shade_plain(state, hit, looked, mode, sun_position, sun_color,
                       sun_radius, prev_occluded, next_key, next_targets)


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
    return resolve_plain(state, spp, sun_color, occluded, gamma)

