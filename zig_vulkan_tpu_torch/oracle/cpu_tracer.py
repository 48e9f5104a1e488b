"""CPU reference ray tracer (the parity oracle).

An independent numpy implementation of the reference's compute kernel
(reference: assets/shaders/brick_raytracer.comp), kept structurally close to
the GLSL so it can serve as ground truth for the port's tracer
(ops.trace, kernel A): nested masked while-loops mirror the shader's
grid-level and brick-level 3D-DDA (brick_raytracer.comp:271-471), and the
shading loop mirrors RayColor (brick_raytracer.comp:203-265), including:

- the slab entry test with normal (AdvNormIntersect,
  brick_raytracer.comp:522-536) and its max-component tie-breaking;
- the precision offsets: grid penetration +1e-4*scale (:287), brick entry
  +0.01*scale (:332), hit backoff t_offset = 0.05*voxel_scale (:431-433);
- lambertian/metal/dielectric scattering with the hash RNG (:539-596),
  Bec's-method refraction (:564-574), and the same-dielectric skip rule
  (:427);
- sun disk sampling + shadow rays (:240-249), background sky (:197-201),
  `color/(color+1)` tone mapping (:264) and sqrt gamma (:176).

All arithmetic is float32 numpy. A copy of
`zig_vulkan_tpu.oracle.cpu_tracer` that imports no JAX and none of the
port's torch ops: its random functions are the numpy copy in
`oracle/rng.py`, so it equals the JAX package's oracle bit for bit and
checks the port on a machine without JAX. It takes host (numpy) scene
arrays: a `BrickGrid`'s `arrays`, or `io.scene_io.load_scene`'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import BRICK_DIMENSION, BRICK_WORDS
from ..core.grid import GridArrays, GridStatic
from ..core.materials import (
    MAT_DIELECTRIC,
    MAT_EMISSIVE,
    MAT_LAMBERTIAN,
    MAT_METAL,
    MAT_NONE,
    MaterialTable,
)
from . import rng

F = np.float32
INFINITY = np.float32(np.inf)


@dataclasses.dataclass
class HitRecords:
    """Vectorized HitRecord (brick_raytracer.comp:46-51)."""

    found: np.ndarray    # bool[N]
    t: np.ndarray        # f32[N]
    point: np.ndarray    # f32[N, 3]
    normal: np.ndarray   # f32[N, 3]
    index: np.ndarray    # int32[N] material index


def safe_inverse(v: np.ndarray) -> np.ndarray:
    """GLSL safeInverse (brick_raytracer.comp:267-268)."""
    with np.errstate(divide="ignore"):
        return np.where(v == 0.0, F(1e12), F(1.0) / v).astype(F)


def _index_of_max_component(v: np.ndarray) -> np.ndarray:
    """GLSL indexOfMaxComponent (brick_raytracer.comp:501-503):
    int(y>x && y>z) + 2*int(z>x && z>y) — note ties resolve to x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return ((y > x) & (y > z)).astype(np.int32) + 2 * ((z > x) & (z > y)).astype(np.int32)


def adv_norm_intersect(box_min, box_max, origin, inv_dir, t_min, t_max):
    """GLSL AdvNormIntersect (brick_raytracer.comp:522-536).

    Returns (ok, normal, new_t_min, new_t_max)."""
    t_lower = (box_min - origin) * inv_dir
    t_upper = (box_max - origin) * inv_dir
    t_mins = np.minimum(t_lower, t_upper)
    t_maxes = np.maximum(t_lower, t_upper)
    idx = _index_of_max_component(t_mins)
    n = origin.shape[0]
    rows = np.arange(n)
    normal = np.zeros_like(origin)
    normal[rows, idx] = np.sign(inv_dir[rows, idx])
    new_t_min = np.maximum(t_min, t_mins[rows, idx])
    new_t_max = np.minimum(t_max, t_maxes.min(axis=-1))
    return new_t_min <= new_t_max, normal.astype(F), new_t_min.astype(F), new_t_max.astype(F)


def _dda_step(side_dist, local_pos, normal, scale_vec, ray_delta, ray_step, mask):
    """One DDA advance (brick_raytracer.comp:344-372 / :439-467).

    Mutates side_dist/local_pos/normal in place for masked rays; returns the
    step t_value (pre-increment side_dist * scale on the chosen axis)."""
    sx, sy, sz = side_dist[:, 0], side_dist[:, 1], side_dist[:, 2]
    axis = np.where(sx < sy, np.where(sx < sz, 0, 2), np.where(sy < sz, 1, 2))
    rows = np.arange(side_dist.shape[0])
    t_value = (side_dist[rows, axis] * scale_vec[axis]).astype(F)
    if mask is not None:
        rows = rows[mask]
        axis = axis[mask]
    side_dist[rows, axis] += ray_delta[rows, axis]
    local_pos[rows, axis] += ray_step[rows, axis]
    normal[rows] = 0.0
    # normal_axis = +1 where step < 0 else -1 (brick_raytracer.comp:304-308)
    normal[rows, axis] = np.where(ray_step[rows, axis] < 0, F(1.0), F(-1.0))
    return t_value


@dataclasses.dataclass
class OracleScene:
    static: GridStatic
    arrays: GridArrays       # numpy arrays
    materials: MaterialTable


def brick_hit(scene: OracleScene, origin, direction, ray_delta, ray_step,
              t_min, grid_t_max, entry_t, brick_index, brick_min, normal,
              ignore_type, internal_reflection, mask):
    """GLSL BrickHit (brick_raytracer.comp:378-471), vectorized + masked.

    `normal` is read/written in place (the GLSL `inout hit` record).
    Returns (found, hit_t, hit_point, hit_material_index)."""
    st = scene.static
    a = scene.arrays
    n = origin.shape[0]
    scale_vec = np.full(3, st.scale, dtype=F)
    voxel_scale = (scale_vec * F(1.0 / BRICK_DIMENSION)).astype(F)

    pos_at_entry = origin + direction * entry_t[:, None]
    fpos = (pos_at_entry - brick_min) / voxel_scale
    intersection_delta = np.floor(fpos) - fpos
    side_dist = ((ray_step * intersection_delta + (ray_step * F(0.5) + F(0.5)))
                 * ray_delta).astype(F)
    local_pos = np.floor(fpos).astype(np.int32)
    local_t_max = (grid_t_max - entry_t).astype(F)
    t_value = np.zeros(n, dtype=F)

    found = np.zeros(n, dtype=bool)
    hit_t = np.zeros(n, dtype=F)
    hit_point = np.zeros((n, 3), dtype=F)
    hit_index = np.zeros(n, dtype=np.int32)

    running = mask.copy()
    guard = 0
    while running.any():
        guard += 1
        if guard > 4 * BRICK_DIMENSION:  # GLSL loop is bounded by geometry
            running[:] = False
            break
        in_bounds = ((local_pos >= 0).all(axis=-1)
                     & (local_pos < BRICK_DIMENSION).all(axis=-1)
                     & (t_value <= local_t_max))
        running &= in_bounds
        if not running.any():
            break

        voxel_index = (local_pos[:, 0]
                       + BRICK_DIMENSION * (local_pos[:, 2]
                                            + BRICK_DIMENSION * local_pos[:, 1]))
        vi = np.clip(voxel_index, 0, BRICK_DIMENSION ** 3 - 1)
        word = np.clip(brick_index, 0, st.brick_alloc - 1) * BRICK_WORDS + vi // 32
        occ = (a.occupancy[word] >> (vi % 32).astype(np.uint32)) & 1
        is_hit = running & (occ == 1)

        if is_hit.any():
            start = (a.start_indices[np.clip(brick_index, 0, st.brick_alloc - 1)]
                     & np.uint32(0x7FFFFFFF)).astype(np.int64)
            mat_idx = a.material_indices[
                np.clip(start + vi, 0, a.material_indices.size - 1)
            ].astype(np.int32)
            # same-material skip (brick_raytracer.comp:427)
            ignore = ((scene.materials.mtype[mat_idx] == ignore_type)
                      & (internal_reflection == scene.materials.type_data[mat_idx]))
            real_hit = is_hit & ~ignore
            if real_hit.any():
                t_off = voxel_scale[0] * F(0.05)
                ht = (entry_t + t_value - t_off).astype(F)
                hp = origin + direction * ht[:, None] + normal * t_off
                found |= real_hit
                hit_t[real_hit] = ht[real_hit]
                hit_point[real_hit] = hp[real_hit]
                hit_index[real_hit] = mat_idx[real_hit]
                running &= ~real_hit
            if not running.any():
                break

        step_t = _dda_step(side_dist, local_pos, normal, voxel_scale,
                           ray_delta, ray_step, running)
        t_value = np.where(running, step_t, t_value).astype(F)

    return found, hit_t, hit_point, hit_index


def grid_hit(scene: OracleScene, origin, direction, t_min, t_max,
             ignore_type, internal_reflection, mask) -> HitRecords:
    """GLSL GridHit (brick_raytracer.comp:271-376), vectorized + masked."""
    st = scene.static
    a = scene.arrays
    n = origin.shape[0]
    g_min = np.asarray(st.min_point, dtype=F)
    g_max = np.asarray(st.max_point, dtype=F)
    scale_vec = np.full(3, st.scale, dtype=F)
    dims = np.asarray(st.dims, dtype=np.int32)

    inv_dir = safe_inverse(direction)
    ok, normal, grid_t_min, grid_t_max = adv_norm_intersect(
        g_min, g_max, origin, inv_dir,
        np.full(n, t_min, dtype=F), np.full(n, t_max, dtype=F))
    running = mask & ok

    global_t = (grid_t_min + F(1e-4) * F(st.scale)).astype(F)
    ray_delta = np.abs(inv_dir).astype(F)
    ray_step = np.sign(direction).astype(np.int32)

    hit_point0 = origin + direction * global_t[:, None]
    fpos = (hit_point0 - g_min) / scale_vec
    intersection_delta = np.floor(fpos) - fpos
    side_dist = ((ray_step * intersection_delta + (ray_step * F(0.5) + F(0.5)))
                 * ray_delta).astype(F)
    local_pos = np.floor(fpos).astype(np.int32)
    t_value = np.zeros(n, dtype=F)

    found = np.zeros(n, dtype=bool)
    out_t = np.zeros(n, dtype=F)
    out_point = np.zeros((n, 3), dtype=F)
    out_index = np.zeros(n, dtype=np.int32)

    guard = 0
    max_grid_steps = 4 * (st.dim_x + st.dim_y + st.dim_z)
    while running.any():
        guard += 1
        if guard > max_grid_steps:
            running[:] = False
            break
        in_bounds = ((local_pos >= 0).all(axis=-1)
                     & (local_pos < dims).all(axis=-1)
                     & (global_t <= t_max))
        running &= in_bounds
        if not running.any():
            break

        cell = (local_pos[:, 0]
                + st.dim_x * (local_pos[:, 2] + st.dim_z * local_pos[:, 1]))
        cell_c = np.clip(cell, 0, st.cells - 1)
        status = (a.statuses[cell_c // 32] >> (cell_c % 32).astype(np.uint32)) & 1
        enter = running & (status == 1)

        if enter.any():
            brick_min = (local_pos * scale_vec + g_min).astype(F)
            new_global_t = (t_value + grid_t_min + F(0.01) * F(st.scale)).astype(F)
            brick_index = a.indices[cell_c].astype(np.int64)
            bh_found, bh_t, bh_point, bh_index = brick_hit(
                scene, origin, direction, ray_delta, ray_step,
                t_min, grid_t_max, new_global_t, brick_index, brick_min,
                normal, ignore_type, internal_reflection, enter)
            global_t = np.where(enter, new_global_t, global_t).astype(F)
            newly = enter & bh_found
            found |= newly
            out_t[newly] = bh_t[newly]
            out_point[newly] = bh_point[newly]
            out_index[newly] = bh_index[newly]
            running &= ~newly
            if not running.any():
                break

        step_t = _dda_step(side_dist, local_pos, normal, scale_vec,
                           ray_delta, ray_step, running)
        t_value = np.where(running, step_t, t_value).astype(F)

    return HitRecords(found=found, t=out_t, point=out_point,
                      normal=normal, index=out_index)


# -- shading ------------------------------------------------------------------

def _normalize(v):
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True)).astype(F)
    with np.errstate(invalid="ignore", divide="ignore"):
        return (v / n).astype(F)


def _reflect(d, n):
    return (d - F(2.0) * np.sum(d * n, axis=-1, keepdims=True) * n).astype(F)


def transmission_direction(n1, n2, ray_dir, normal):
    """Bec's-method refraction (brick_raytracer.comp:564-574).

    Returns (should_refract, refrac_dir)."""
    eta = (n1 / n2).astype(F)
    c1 = -np.sum(ray_dir * normal, axis=-1).astype(F)
    w = eta * c1
    c2m = ((w - eta) * (w + eta)).astype(F)
    should = c2m >= F(-1.0)
    with np.errstate(invalid="ignore"):
        refrac = (eta[:, None] * ray_dir
                  + (w - np.sqrt(np.maximum(F(1.0) + c2m, 0.0)))[:, None] * normal)
    return should, refrac.astype(F)


def background_color(direction):
    """GLSL BackgroundColor (brick_raytracer.comp:197-201)."""
    t = (F(0.5) * (direction[:, 1] + F(1.0))).astype(F)
    white = np.ones(3, dtype=F)
    blue = np.asarray([0.5, 0.7, 1.0], dtype=F)
    return ((F(1.0) - t)[:, None] * white + t[:, None] * blue).astype(F)


def ray_color(scene: OracleScene, origin, direction, max_bounce: int,
              sun_position, sun_enabled: bool, sun_color, sun_radius) -> np.ndarray:
    """GLSL RayColor (brick_raytracer.comp:203-265), vectorized."""
    mats = scene.materials
    n = origin.shape[0]
    color = np.zeros((n, 3), dtype=F)
    cur_origin = origin.astype(F).copy()
    cur_dir = _normalize(direction.astype(F))
    internal_refl = np.ones(n, dtype=F)
    ignore_type = np.full(n, MAT_NONE, dtype=np.int32)
    loop_count = np.zeros(n, dtype=np.int32)
    bouncing = np.ones(n, dtype=bool)
    sun_color = np.asarray(sun_color, dtype=F)
    sun_position = np.asarray(sun_position, dtype=F)

    for _ in range(max_bounce):
        if not bouncing.any():
            break
        hits = grid_hit(scene, cur_origin, cur_dir, F(1e-5), INFINITY,
                        ignore_type, internal_refl, bouncing)
        active = bouncing & hits.found
        bouncing = active.copy()
        if not active.any():
            break

        mat_idx = hits.index
        mtype = mats.mtype[mat_idx]
        attenuation = mats.albedo[mat_idx].astype(F)
        type_data = mats.type_data[mat_idx].astype(F)
        # default case decrements the (already incremented) loop counter
        # (brick_raytracer.comp:235-238); emissive (superset) counts as known
        is_emissive = mtype == MAT_EMISSIVE
        known = (mtype <= MAT_DIELECTRIC) | is_emissive
        loop_count += (active & known).astype(np.int32)

        co = np.stack([hits.point[:, 0] + hits.point[:, 2],
                       hits.point[:, 1] + hits.point[:, 2]], axis=-1).astype(F)

        # lambertian (brick_raytracer.comp:539-544)
        lam_dir = _normalize(hits.normal + rng.rand_vec3_range(co, -0.4, 0.4))
        lam_ok = np.ones(n, dtype=bool)

        # metal (brick_raytracer.comp:546-551): RandVec3(co, -fuzz, fuzz)
        # with per-ray fuzz bounds (the chained hash coords depend on the
        # range-mapped components, so the bounds must flow through the hash)
        reflected = _reflect(cur_dir, hits.normal)
        fuzz = type_data
        met_raw = reflected + rng.rand_vec3_range(co, -fuzz, fuzz)
        met_dir = _normalize(met_raw)
        met_ok = np.sum(met_dir * hits.normal, axis=-1) > 0

        # dielectric (brick_raytracer.comp:576-596)
        d_normal = _normalize(hits.normal + rng.rand_vec3_range(co, -0.05, 0.05))
        ir = type_data
        should_refract, refrac_dir = transmission_direction(
            ir, internal_refl, cur_dir, d_normal)
        do_refract = should_refract & (rng.rand3(hits.point) > F(0.5))
        die_dir = _normalize(np.where(do_refract[:, None], refrac_dir,
                                      _reflect(cur_dir, d_normal)))
        die_ok = np.ones(n, dtype=bool)

        is_lam = mtype == MAT_LAMBERTIAN
        is_met = mtype == MAT_METAL
        is_die = mtype == MAT_DIELECTRIC
        scattered_dir = np.where(is_lam[:, None], lam_dir,
                                 np.where(is_met[:, None], met_dir, die_dir)).astype(F)
        result = np.where(is_lam, lam_ok,
                          np.where(is_met, met_ok,
                                   np.where(is_die, die_ok, False)))
        new_ignore = np.where(is_die & do_refract, MAT_DIELECTRIC, MAT_NONE).astype(np.int32)
        new_internal = np.where(is_die & do_refract, ir, F(1.0)).astype(F)

        # emissive contribution (superset): albedo * strength, unshadowed
        emit = active & is_emissive
        color[emit] += attenuation[emit] * type_data[emit, None]
        sun_or_diffuse = active & ~is_emissive

        # sun shadow ray from the *incoming* ray direction (brick_raytracer.comp:240-249)
        if sun_enabled:
            sco = np.stack([cur_dir[:, 0] + cur_dir[:, 2],
                            cur_dir[:, 1] + cur_dir[:, 2]], axis=-1).astype(F)
            sun_sample = sun_position + rng.rand_vec3_range(
                sco, -float(sun_radius), float(sun_radius))
            shadow_dir = _normalize(sun_sample - hits.point)
            sh = grid_hit(scene, hits.point, shadow_dir, F(1e-5), INFINITY,
                          np.full(n, MAT_NONE, dtype=np.int32),
                          np.ones(n, dtype=F), active)
            lit = sun_or_diffuse & ~sh.found
            color[lit] += attenuation[lit] * sun_color
        else:
            color[sun_or_diffuse] += attenuation[sun_or_diffuse]

        bouncing &= result
        cur_origin = np.where(active[:, None], hits.point, cur_origin).astype(F)
        cur_dir = np.where((active & result)[:, None], scattered_dir, cur_dir).astype(F)
        internal_refl = np.where(active, new_internal, internal_refl).astype(F)
        ignore_type = np.where(active, new_ignore, ignore_type)

    never_hit = loop_count == 0
    bg_scale = sun_color if sun_enabled else np.ones(3, dtype=F)
    color[never_hit] += background_color(cur_dir[never_hit]) * bg_scale

    return (color / (color + F(1.0))).astype(F)


def render(scene: OracleScene, camera_device, sun_device,
           max_bounce: int | None = None) -> np.ndarray:
    """Full frame render (kernel main, brick_raytracer.comp:153-178).

    Returns f32[height, width, 3] in [0, 1]. Row 0 corresponds to v=0
    (the viewport's lower edge), matching the GLSL image layout.
    """
    d = camera_device
    w, h = int(d.image_width), int(d.image_height)
    spp = int(d.samples_per_pixel)
    mb = int(d.max_bounce if max_bounce is None else max_bounce)

    ys, xs = np.meshgrid(np.arange(h, dtype=F), np.arange(w, dtype=F), indexing="ij")
    xs = xs.ravel()
    ys = ys.ravel()
    color = np.zeros((h * w, 3), dtype=F)
    for s in range(spp):
        sf = F(0.2) * F(1.0 if s > 0 else 0.0)
        noise_x = rng.hash12(np.stack([(xs + F(s)) * sf, ys * sf], axis=-1))
        noise_y = rng.hash12(np.stack([xs * sf, (ys + F(s)) * sf], axis=-1))
        u = ((xs + noise_x) / F(w - 1)).astype(F)
        v = ((ys + noise_y) / F(h - 1)).astype(F)
        ray_dir = (d.horizontal * u[:, None]
                   + d.lower_left_corner
                   + d.vertical * v[:, None]
                   - d.origin).astype(F)
        origin = np.broadcast_to(d.origin.astype(F), ray_dir.shape).copy()
        color += ray_color(scene, origin, ray_dir, mb,
                           sun_device.position, bool(sun_device.enabled),
                           sun_device.color, float(sun_device.radius))

    color = np.sqrt(color / F(spp)).astype(F)
    return color.reshape(h, w, 3)
