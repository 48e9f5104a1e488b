"""Wavefront path tracer on torch tensors (the frame's compute path).

The torch counterpart of `zig_vulkan_tpu.ops.trace` (the reference's
per-pixel megakernel, assets/shaders/brick_raytracer.comp). A frame is a
wavefront: every ray is one lane of flat (N,) float32 arrays, kept as
separate x/y/z components (SoA). Per bounce level the wavefront goes
through

1. the first-hit traversal, `ops.tile_tracer.grid_hit_tiles` (kernel A on
   CUDA, `_grid_hit_soa` below on the CPU);
2. the material lookup, `ops.lookup.table_lookup` (kernel B on CUDA);
3. the shading, `ops.shade.shade` (kernel D on CUDA): lambertian /
   metal / dielectric / emissive scatter and the ray-state update;
4. the sun-shadow ray: a second traversal, or traced by the same kernel A
   thread with `shadow_probe`.

The camera rays before the first level (kernel C) and the background,
tone map and sample resolve after the last (kernel E) are `ops.shade`'s
too; this module holds the traversal's plain version, the scene tables and
the entry points.

Colours do not depend on lane order (every random number is a hash of hit
positions and ray directions), so the wavefront stays in pixel order: the
reference's bin sorts and unsort are not needed.

Float parity: every expression keeps the reference's operation order, one
float32 rounding per operation. Divisions by constants divide by a 0-d
tensor on the wavefront's device, because PyTorch's CUDA division by a
Python scalar multiplies by its reciprocal, which can differ in the last
bit. Such a constant is made on the device by a fill (`_const`), never
copied from the host, and the per-frame values (camera basis, sun, sample
base) may come as device tensors: a frame then makes no host-to-device
copy, waits for nothing, and can be captured as a CUDA graph. A 0-d
float32 tensor operand rounds as the float32 host value did.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BRICK_DIMENSION, BRICK_WORDS, TraceConfig
from ..core.grid import GridArrays, GridStatic
from ..core.materials import MAT_DIELECTRIC, MaterialTable
from ..utils import profiling
from . import rng
from .lookup import table_lookup

F32 = torch.float32
_F = np.float32
_BD = BRICK_DIMENSION
EMPTY = -1  # empty-cell record sentinel: 0xFFFFFFFF seen as int32


def _c(x) -> float:
    """A Python float holding exactly the float32 value of `x`."""
    return float(_F(x))


def _const(c, device):
    """The float32 value of host scalar `c` as a 0-d tensor on `device`,
    made by a fill: no host-to-device copy."""
    return torch.full((), _c(c), dtype=F32, device=device)


def _div(x, c):
    """`x / c` for a float32 constant or 0-d tensor `c`, rounded as a true
    division on every device (see the module docstring)."""
    return x / (c if torch.is_tensor(c) else _const(c, x.device))


def _vec3(v):
    """A per-frame float32[3] value as the shading reads it: a device
    tensor stays one; host values become exact float32 Python floats."""
    if torch.is_tensor(v):
        return v
    return [_c(x) for x in np.asarray(v, dtype=np.float32)]


def materials_to_device(table: MaterialTable, device) -> torch.Tensor:
    """The material table as the bounce loop reads it: f32[5, 256] rows of
    albedo r, g, b, mtype (as float) and type_data, the layout kernel B
    (ops.lookup) looks up by material index."""
    albedo = np.asarray(table.albedo, dtype=np.float32)
    lookup = np.stack([albedo[:, 0], albedo[:, 1], albedo[:, 2],
                       np.asarray(table.mtype).astype(np.float32),
                       np.asarray(table.type_data, dtype=np.float32)])
    return torch.from_numpy(np.ascontiguousarray(lookup)).to(device)


# -- small SoA vector helpers ---------------------------------------------------

def _rsqrt(x):
    # 1/sqrt(x), correctly rounded per step on every device (torch.rsqrt
    # on CUDA is an approximation)
    return torch.reciprocal(torch.sqrt(x))


def _norm3(x, y, z):
    inv = _rsqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def safe_inverse(v):
    """GLSL safeInverse (brick_raytracer.comp:267-268)."""
    return torch.where(v == 0.0, torch.full_like(v, 1e12),
                       torch.reciprocal(v))


# -- scene tables ---------------------------------------------------------------

DIST_CAP = 31  # max encoded empty-space Chebyshev radius

# conservative far-field windows (zig_vulkan_tpu/ops/trace.py:189-190):
# exact to _DF_EXACT_RADIUS, then doubled windows with floor penalties
_DF_EXACT_RADIUS = 3
_DF_LEVELS = ((6, 4), (12, 7), (24, 13), (DIST_CAP - 1, 25))


def _distance_field(static: GridStatic, loaded, exact: bool = False):
    """Chebyshev distance to the nearest loaded cell, capped at DIST_CAP,
    as int32[cells] (zig_vulkan_tpu/ops/trace.py:193-264).

    Separable into three 1-D min-max passes (along x, z, y). `exact=True`
    evaluates every offset up to DIST_CAP-1 (the scene-build field);
    otherwise offsets up to _DF_EXACT_RADIUS are exact and the far field
    uses doubled windowed minima with floor penalties, which never
    overestimate the true distance."""
    vol = loaded.reshape(static.dim_y, static.dim_z, static.dim_x)
    cap = torch.full(vol.shape, DIST_CAP, dtype=torch.int32, device=vol.device)
    dist = torch.where(vol, torch.zeros_like(cap), cap)
    exact_r = DIST_CAP - 1 if exact else _DF_EXACT_RADIUS
    levels = () if exact else _DF_LEVELS

    def pad(d, axis, width):
        shape = list(d.shape)
        shape[axis] = width
        side = torch.full(shape, DIST_CAP, dtype=d.dtype, device=d.device)
        return torch.cat([side, d, side], dim=axis)

    def axis_pass(d, axis):
        n = d.shape[axis]
        out = d
        p = pad(d, axis, exact_r)
        w = d  # windowed min, its radius grows as we go
        for k in range(1, exact_r + 1):
            left = p.narrow(axis, exact_r - k, n)
            right = p.narrow(axis, exact_r + k, n)
            near = torch.minimum(left, right)
            out = torch.minimum(out, torch.clamp(near, min=k))
            w = torch.minimum(w, near)
        prev_r = exact_r
        for r, floor in levels:
            step = r - prev_r
            pw = pad(w, axis, step)
            w = torch.minimum(w, torch.minimum(pw.narrow(axis, 0, n),
                                               pw.narrow(axis, 2 * step, n)))
            out = torch.minimum(out, torch.clamp(w, min=floor))
            prev_r = r
        return out

    for axis in (2, 1, 0):
        dist = axis_pass(dist, axis)
    return dist.reshape(-1)


def _loaded_cells(static: GridStatic, arrays: GridArrays):
    """bool[cells]: the status bit of every cell. The int32 status words
    shift arithmetically; `& 1` still isolates the right bit."""
    cells = torch.arange(static.cells, dtype=torch.int64,
                         device=arrays.statuses.device)
    bits = arrays.statuses[cells // 32]
    return ((bits >> (cells % 32).to(torch.int32)) & 1) == 1


def distance_field(static: GridStatic, arrays: GridArrays,
                   exact: bool = False):
    """The skip field of a scene (zig_vulkan_tpu/ops/trace.py:267-276)."""
    return _distance_field(static, _loaded_cells(static, arrays), exact=exact)


def no_skip_field(static: GridStatic, arrays: GridArrays):
    """An all-0 distance lane (no leap), for records that only the exact
    DDA reads: those of the one-shot paths (`one_shot_tables`: the
    one-shot renders and the sharded step with `use_skip=False`). The
    exact traversal never reads the lane, so no distance field is built.
    The engine does not use it: its records keep a live field whatever
    `empty_skip` is."""
    return torch.zeros(static.cells, dtype=torch.int32,
                       device=arrays.statuses.device)


def _rows_for_cells(static: GridStatic, arrays: GridArrays, cells,
                    dist_rows):
    """The traversal records of `cells` (int64[K], in range), with skip
    distances `dist_rows` (zig_vulkan_tpu/ops/trace.py:327-351)."""
    bits = arrays.statuses[cells // 32]
    loaded = ((bits >> (cells % 32).to(torch.int32)) & 1) == 1
    cell_brick = arrays.indices[cells]
    brick = torch.where(loaded, cell_brick,
                        torch.zeros_like(cell_brick)).long()
    occ2 = arrays.occupancy.reshape(static.brick_alloc, BRICK_WORDS)
    occ_rows = occ2[brick]
    diel2 = arrays.diel_mask.reshape(static.brick_alloc, BRICK_WORDS)
    diel_rows = diel2[brick]
    ir_bits = arrays.brick_ir[brick].view(torch.int32)
    start = arrays.start_indices[brick]
    start = torch.where(loaded, start, torch.full_like(start, EMPTY))
    return torch.stack(
        [start, occ_rows[:, 0], occ_rows[:, 1], dist_rows,
         diel_rows[:, 0], diel_rows[:, 1], ir_bits,
         torch.zeros_like(dist_rows)], dim=-1).contiguous()


def build_trace_tables(static: GridStatic, arrays: GridArrays, dist=None):
    """Per-cell traversal records, int32[cells, 8]
    (zig_vulkan_tpu/ops/trace.py:279-324): {material window start (or -1 =
    empty cell), occupancy word 0, occupancy word 1, Chebyshev skip
    distance, dielectric-mask word 0, dielectric-mask word 1, brick ir as
    float32 bits, 0}. One 32-byte row per cell: everything the traversal
    needs at a cell, in one aligned read."""
    if dist is None:
        dist = _distance_field(static, _loaded_cells(static, arrays))
    cells = torch.arange(static.cells, dtype=torch.int64,
                         device=arrays.statuses.device)
    return _rows_for_cells(static, arrays, cells, dist)


def one_shot_tables(static: GridStatic, arrays: GridArrays,
                    use_skip: bool = True):
    """The records a one-shot render builds for itself: the fast
    conservative field, or none for the exact DDA (the engine caches
    records built with the exact field instead)."""
    dist = None if use_skip else no_skip_field(static, arrays)
    return build_trace_tables(static, arrays, dist)


def refresh_tables_after_insert(static: GridStatic, arrays: GridArrays,
                                tables, cells, valid, dist=None):
    """Bring cached tables up to date after an insert batch
    (zig_vulkan_tpu/ops/trace.py:354-373), in place: the conservative
    skip field is rebuilt whole (inserts can load new cells, lowering
    distances anywhere within DIST_CAP) and written to lane 3, then the
    rows of the touched `cells` (int[K], masked by `valid`) are gathered
    anew. Returns (tables, dist); the tables then equal
    `build_trace_tables(static, arrays, distance_field(static, arrays))`
    on every lane the traversal reads. (An empty cell's row also carries
    brick 0's words, which stay as they were when an edit changes brick 0,
    as in the reference; no traversal reads them.) A `dist` tensor given
    receives the field in place (the engine's cached field, whose address
    its edit graphs hold). The field's rebuild is the `edit_field` device
    span (`utils.profiling.device_mark`)."""
    profiling.device_mark("edit_field", tables.device)
    field = distance_field(static, arrays)
    dist = field if dist is None else dist.copy_(field)
    tables[:, 3] = dist
    profiling.device_mark("edit_field", tables.device)
    _refresh_rows(static, arrays, tables, dist, cells, valid)
    return tables, dist


def refresh_tables_after_remove(static: GridStatic, arrays: GridArrays,
                                tables, dist, cells, valid):
    """Bring cached tables up to date after removals
    (zig_vulkan_tpu/ops/trace.py:376-385), in place: statuses never change
    (bricks are not freed), so the cached skip field `dist` stays valid and
    only the touched rows are gathered anew."""
    _refresh_rows(static, arrays, tables, dist, cells, valid)
    return tables


def _refresh_rows(static, arrays, tables, dist, cells, valid):
    """Gather anew the rows of the `valid` lanes' cells, with no shape that
    depends on the data: every lane writes a row, and an invalid lane
    writes the row of the first valid lane's cell (the same row that lane
    writes), or, in a batch with no valid lane, its own row unchanged."""
    safe = cells.to(torch.int64).clamp(0, static.cells - 1)
    first = torch.argmax(valid.to(torch.int32)).view(1)
    cell = torch.where(valid, safe, safe[first])
    rows = torch.where(valid.any(), _rows_for_cells(static, arrays, cell,
                                                    dist[cell]),
                       tables[cell])
    tables[cell] = rows


# -- first-hit traversal: the plain torch version of kernel A ------------------

def trace_constants(static: GridStatic) -> dict:
    """The float32 constants of the traversal, rounded as the reference
    rounds them (also passed to kernel A)."""
    scale = _F(static.scale)
    voxel_scale = _F(static.scale / _BD)
    return dict(
        g0=tuple(_F(v) for v in static.min_point),
        g1=tuple(_F(v) for v in static.max_point),
        scale=scale,
        voxel_scale=voxel_scale,
        park=_F(1e-4) * scale,        # the 1e-4*scale cursor offset
        enter_eps=_F(0.01) * scale,   # the 0.01*scale brick entry offset
        t_off=voxel_scale * _F(0.05),  # the hit-point offset along the normal
    )


# brick-level voxel steps per traversal loop iteration (the reference's
# brick_unroll default); kernel A has the same constant
BRICK_UNROLL = 4


def _grid_hit_soa(static: GridStatic, tables, material_indices,
                  ox, oy, oz, dx, dy, dz, active, ray_key=None,
                  max_steps: int = 768, stats: bool = False,
                  use_skip: bool = True):
    """First voxel hit of the two-level grid+brick DDA (GLSL GridHit +
    BrickHit, brick_raytracer.comp:271-471) for a wavefront of rays: the
    plain torch version of kernel A (csrc/traverse.cu).

    The semantics are those of `zig_vulkan_tpu.ops.trace._grid_hit_soa`
    with `use_skip` (True: the Chebyshev empty-space leap over the records'
    distance lane; False: the exact cell-by-cell DDA, which never reads
    that lane), `bounded_t=False` (t_max = +inf, as every RayColor call has
    it) and the per-ray dielectric key: `ray_key` is the ir of a
    refracted ray and NaN otherwise; a voxel of the brick's dielectric mask
    is skipped when the brick's ir equals the key (brick_raytracer.comp:427).
    NaN never compares equal, so `ray_key=None` skips nothing.

    One loop iteration is one reference while-loop iteration: one
    grid-level action (enter a brick, leap empty space, or step a cell)
    plus BRICK_UNROLL brick-level voxel steps. A lane that has not hit
    after `max_steps` iterations is a miss, as in the reference.

    Returns dict(found, t, px, py, pz, nx, ny, nz, index); with `stats`
    also `n_step`, int32 loop iterations per lane (a lane that hits with
    `n_step = k` hits with `max_steps = k` and misses with `k - 1`).
    """
    k = trace_constants(static)
    dev = ox.device
    n = ox.shape[0]
    gx0, gy0, gz0 = (_c(v) for v in k["g0"])
    gx1, gy1, gz1 = (_c(v) for v in k["g1"])
    scale = _c(k["scale"])
    voxel_scale = _c(k["voxel_scale"])
    park = _c(k["park"])
    enter_eps = _c(k["enter_eps"])
    t_off = _c(k["t_off"])
    dim_x, dim_y, dim_z = static.dims
    cells = static.cells
    mat_cap = material_indices.shape[0] - 1
    inf = torch.full((n,), float("inf"), dtype=F32, device=dev)

    ix, iy, iz = safe_inverse(dx), safe_inverse(dy), safe_inverse(dz)

    # slab entry with normal (AdvNormIntersect, brick_raytracer.comp:522-536)
    tlx, tux = (gx0 - ox) * ix, (gx1 - ox) * ix
    tly, tuy = (gy0 - oy) * iy, (gy1 - oy) * iy
    tlz, tuz = (gz0 - oz) * iz, (gz1 - oz) * iz
    tminx, tmaxx = torch.minimum(tlx, tux), torch.maximum(tlx, tux)
    tminy, tmaxy = torch.minimum(tly, tuy), torch.maximum(tly, tuy)
    tminz, tmaxz = torch.minimum(tlz, tuz), torch.maximum(tlz, tuz)
    # indexOfMaxComponent tie-breaking (brick_raytracer.comp:501-503)
    is_y = (tminy > tminx) & (tminy > tminz)
    is_z = (tminz > tminx) & (tminz > tminy)
    is_x = ~(is_y | is_z)
    entry_tmin = torch.where(is_x, tminx, torch.where(is_y, tminy, tminz))
    grid_t_min = torch.maximum(torch.full_like(entry_tmin, _c(1e-5)),
                               entry_tmin)
    grid_t_max = torch.minimum(
        inf, torch.minimum(tmaxx, torch.minimum(tmaxy, tmaxz)))
    slab_ok = grid_t_min <= grid_t_max

    adx, ady, adz = torch.abs(ix), torch.abs(iy), torch.abs(iz)
    stx = torch.sign(dx).to(torch.int32)
    sty = torch.sign(dy).to(torch.int32)
    stz = torch.sign(dz).to(torch.int32)
    stxf, styf, stzf = stx.to(F32), sty.to(F32), stz.to(F32)

    def cursor(t0, g0, stf, ad, o, d, size):
        # DDA cursor from the ray position at t0 (brick_raytracer.comp:
        # 287-311 at grid level, :389-405 at brick level)
        f = _div(o + d * t0 - g0, size)
        fl = torch.floor(f)
        return (stf * (fl - f) + (stf * 0.5 + 0.5)) * ad, fl.to(torch.int32)

    def grid_init(t_base):
        t0 = t_base + park
        sx, lx = cursor(t0, gx0, stxf, adx, ox, dx, scale)
        sy, ly = cursor(t0, gy0, styf, ady, oy, dy, scale)
        sz, lz = cursor(t0, gz0, stzf, adz, oz, dz, scale)
        return sx, sy, sz, lx, ly, lz

    sx, sy, sz, lx, ly, lz = grid_init(grid_t_min)
    inv_max_abs_d = torch.reciprocal(torch.maximum(
        torch.abs(dx), torch.maximum(torch.abs(dy), torch.abs(dz))))

    # normal code: axis (0, 1, 2) + 4 for the negative sign
    four = torch.full_like(stx, 4)
    slab_code = torch.where(
        is_x, torch.where(ix >= 0, 0, four),
        torch.where(is_y, torch.where(iy >= 0, 1, four + 1),
                    torch.where(iz >= 0, 2, four + 2))).to(torch.int32)
    step_code_x = torch.where(stx < 0, 0, four)  # normal +x when stepping -x
    step_code_y = torch.where(sty < 0, 1, four + 1)
    step_code_z = torch.where(stz < 0, 2, four + 2)

    zf = torch.zeros(n, dtype=F32, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    running = active & slab_ok
    in_brick = zb
    t_base = grid_t_min
    t_value = zf
    ncode = slab_code
    blx = bly = blz = zi
    bsx = bsy = bsz = zf
    b_t = entry_t = zf
    occ_lo = occ_hi = dmask_lo = dmask_hi = zi
    mat_start = zi
    bminx = bminy = bminz = zf
    local_t_max = zf
    brick_key = torch.full((n,), float("nan"), dtype=F32, device=dev)
    if ray_key is None:
        ray_key = brick_key
    found = zb
    out_t = zf
    out_addr = zi

    def sel3(a, b, c, xs, ys, zs):
        return torch.where(a, xs, torch.where(b, ys, zs))

    n_step = zi
    step = 0
    while step < max_steps and bool(running.any()):
        step += 1
        n_step = n_step + running.to(torch.int32)
        # ---------------- grid level: cell check ----------------
        g = running & ~in_brick
        in_b_g = ((lx >= 0) & (lx < dim_x) & (ly >= 0) & (ly < dim_y)
                  & (lz >= 0) & (lz < dim_z))
        g_miss = g & ~in_b_g
        g_act = g & in_b_g
        cell = torch.clamp(lx + dim_x * (lz + dim_z * ly), 0, cells - 1)
        rec = tables[cell.long()]
        start_raw = rec[:, 0]
        enter = g_act & (start_raw != EMPTY)
        occ_lo = torch.where(enter, rec[:, 1], occ_lo)
        occ_hi = torch.where(enter, rec[:, 2], occ_hi)
        mat_start = torch.where(enter, start_raw & 0x7FFFFFFF, mat_start)
        dmask_lo = torch.where(enter, rec[:, 4], dmask_lo)
        dmask_hi = torch.where(enter, rec[:, 5], dmask_hi)
        brick_key = torch.where(enter, rec[:, 6].contiguous().view(F32),
                                brick_key)

        # empty-space skip: leap dist-1 cells and re-derive the DDA cursor
        t_base_old = t_base
        if use_skip:
            dist = rec[:, 3]
            do_skip = g_act & ~enter & (dist >= 2)
            cur_t = t_base + park + t_value
            new_base = cur_t + (dist.to(F32) - 1.0) * scale * inv_max_abs_d
            t_base = torch.where(do_skip, new_base, t_base)
            rsx, rsy, rsz, rlx, rly, rlz = grid_init(t_base)
        else:
            do_skip = zb

        bminx = torch.where(enter, lx.to(F32) * scale + gx0, bminx)
        bminy = torch.where(enter, ly.to(F32) * scale + gy0, bminy)
        bminz = torch.where(enter, lz.to(F32) * scale + gz0, bminz)
        new_global_t = t_value + t_base_old + enter_eps
        entry_t = torch.where(enter, new_global_t, entry_t)

        # brick-level DDA init on entry (brick_raytracer.comp:389-405)
        esx, elx = cursor(entry_t, bminx, stxf, adx, ox, dx, voxel_scale)
        esy, ely = cursor(entry_t, bminy, styf, ady, oy, dy, voxel_scale)
        esz, elz = cursor(entry_t, bminz, stzf, adz, oz, dz, voxel_scale)
        bsx = torch.where(enter, esx, bsx)
        bsy = torch.where(enter, esy, bsy)
        bsz = torch.where(enter, esz, bsz)
        blx = torch.where(enter, elx, blx)
        bly = torch.where(enter, ely, bly)
        blz = torch.where(enter, elz, blz)
        b_t = torch.where(enter, zf, b_t)
        local_t_max = torch.where(enter, grid_t_max - entry_t, local_t_max)
        in_brick = in_brick | enter

        # ------- brick level: voxel checks -------
        b_exit_any = zb
        for _ in range(BRICK_UNROLL):
            b = running & in_brick
            in_b_b = ((blx >= 0) & (blx < _BD) & (bly >= 0) & (bly < _BD)
                      & (blz >= 0) & (blz < _BD) & (b_t <= local_t_max))
            b_exit = b & ~in_b_b
            in_brick = in_brick & ~b_exit
            b_exit_any = b_exit_any | b_exit
            b_act = b & in_b_b

            vi = blx + _BD * (blz + _BD * bly)
            viu = torch.clamp(vi, 0, _BD ** 3 - 1)
            sh = viu % 32
            occ_word = torch.where(viu < 32, occ_lo, occ_hi)
            vhit = b_act & (((occ_word >> sh) & 1) == 1)
            mat_addr = torch.clamp(mat_start + vi, 0, mat_cap)
            d_word = torch.where(viu < 32, dmask_lo, dmask_hi)
            ignore = (((d_word >> sh) & 1) == 1) & (brick_key == ray_key)
            real_hit = vhit & ~ignore

            hit_t = entry_t + b_t - t_off
            found = found | real_hit
            out_t = torch.where(real_hit, hit_t, out_t)
            out_addr = torch.where(real_hit, mat_addr, out_addr)
            running = running & ~real_hit

            brick_steps = b_act & ~real_hit
            bax = (bsx < bsy) & (bsx < bsz)
            bay = ~(bsx < bsy) & (bsy < bsz)
            baz = ~(bax | bay)
            bt_new = sel3(bax, bay, baz, bsx, bsy, bsz) * voxel_scale
            mx, my, mz = brick_steps & bax, brick_steps & bay, brick_steps & baz
            bsx = torch.where(mx, bsx + adx, bsx)
            blx = torch.where(mx, blx + stx, blx)
            bsy = torch.where(my, bsy + ady, bsy)
            bly = torch.where(my, bly + sty, bly)
            bsz = torch.where(mz, bsz + adz, bsz)
            blz = torch.where(mz, blz + stz, blz)
            b_t = torch.where(brick_steps, bt_new, b_t)
            ncode = torch.where(
                brick_steps,
                sel3(bax, bay, baz, step_code_x, step_code_y, step_code_z),
                ncode)

        # ---------------- grid advance ----------------
        grid_steps = (g_act & ~enter & ~do_skip) | b_exit_any
        running = running & ~g_miss
        gax = (sx < sy) & (sx < sz)
        gay = ~(sx < sy) & (sy < sz)
        gaz = ~(gax | gay)
        gt_new = sel3(gax, gay, gaz, sx, sy, sz) * scale
        mx, my, mz = grid_steps & gax, grid_steps & gay, grid_steps & gaz
        sx = torch.where(mx, sx + adx, sx)
        lx = torch.where(mx, lx + stx, lx)
        sy = torch.where(my, sy + ady, sy)
        ly = torch.where(my, ly + sty, ly)
        sz = torch.where(mz, sz + adz, sz)
        lz = torch.where(mz, lz + stz, lz)
        t_value = torch.where(grid_steps, gt_new, t_value)
        if use_skip:
            sx, sy, sz = (torch.where(do_skip, r, v)
                          for r, v in ((rsx, sx), (rsy, sy), (rsz, sz)))
            lx, ly, lz = (torch.where(do_skip, r, v)
                          for r, v in ((rlx, lx), (rly, ly), (rlz, lz)))
            t_value = torch.where(do_skip, zf, t_value)
        ncode = torch.where(
            grid_steps,
            sel3(gax, gay, gaz, step_code_x, step_code_y, step_code_z), ncode)

    # decode the normal code; hit point (brick_raytracer.comp:431-433)
    sign = torch.where(ncode < 4, 1.0, -1.0).to(F32)
    axis = ncode & 3
    nx = torch.where(axis == 0, sign, zf)
    ny = torch.where(axis == 1, sign, zf)
    nz = torch.where(axis == 2, sign, zf)
    px = ox + dx * out_t + nx * t_off
    py = oy + dy * out_t + ny * t_off
    pz = oz + dz * out_t + nz * t_off
    index = material_indices[torch.where(found, out_addr, zi).long()].to(
        torch.int32)
    out = dict(found=found, t=out_t, px=px, py=py, pz=pz,
               nx=nx, ny=ny, nz=nz, index=index)
    if stats:
        out["n_step"] = n_step
    return out


def sun_targets(dx, dy, dz, sun_p, radius):
    """Per-lane jittered sun-disk target of a ray (brick_raytracer.comp:
    240-249; zig_vulkan_tpu/ops/trace.py:1127-1139). The jitter seed is the
    incoming direction, so the target is known before the traversal: the
    shadow build of kernel A takes it and traces the sun ray itself.
    `sun_p` is three floats or an f32[3] tensor, `radius` a float32 or a
    0-d tensor on the rays' device."""
    jx, jy, jz = _rand_vec3_range_soa(dx + dz, dy + dz, -radius, radius)
    return sun_p[0] + jx, sun_p[1] + jy, sun_p[2] + jz


def shadow_dirs(hit, targets):
    """Normalized directions from the hit points toward `targets`, rounded
    as kernel A's shadow build rounds them."""
    return _norm3(targets[0] - hit["px"], targets[1] - hit["py"],
                  targets[2] - hit["pz"])


# -- path tracing ---------------------------------------------------------------

def _rand_vec3_range_soa(cox, coy, lo, hi):
    """SoA GLSL RandVec3(co, min, max) (rand.comp:15-20)."""
    v = rng.rand_vec3_range(torch.stack([cox, coy], dim=-1), lo, hi)
    return v[:, 0], v[:, 1], v[:, 2]


def _trace_levels(static: GridStatic, tables, material_indices, mats,
                  state: dict, max_bounce: int, mode: int, sun,
                  targets=None, max_steps: int = 768, use_skip: bool = True):
    """The bounce levels of a wavefront: per level kernel A's scatter
    launch, kernel B's material lookup, kernel D's shading (`ops.shade`,
    the ray `state` updated in place) and, with SUN_DEFERRED, kernel A's
    shadow launch. `sun` = (position, colour, radius); `targets` are the
    first level's sun targets (SUN_PROBE). Returns the last shadow
    launch's hits (SUN_DEFERRED with a level), else None."""
    from . import shade
    from .tile_tracer import grid_hit_tiles  # imports this module

    key = occluded = None
    for level in range(max_bounce):
        last = level == max_bounce - 1
        h = grid_hit_tiles(static, tables, material_indices,
                           *(state[k] for k in shade.RAY_KEYS),
                           state["bouncing"], ray_key=key,
                           max_steps=max_steps, shadow_targets=targets,
                           use_skip=use_skip)
        looked = table_lookup(mats, h["index"])
        out = shade.shade(state, h, looked, mode, *sun,
                          prev_occluded=occluded, next_key=not last,
                          next_targets=mode == shade.SUN_PROBE and not last)
        # dielectric-skip state exists only after a refraction: the first
        # level has no key
        key = out.get("key")
        targets = (tuple(out[k] for k in shade.TARGET_KEYS)
                   if "tx" in out else None)
        if mode == shade.SUN_DEFERRED:
            occluded = grid_hit_tiles(
                static, tables, material_indices, h["px"], h["py"],
                h["pz"], *(out[k] for k in shade.SHADOW_KEYS),
                out["active"], max_steps=max_steps,
                use_skip=use_skip)["found"]
    return occluded


def _ray_color_soa(static: GridStatic, tables, material_indices,
                   mats, ox, oy, oz, dx, dy, dz,
                   max_bounce: int, sun_position, sun_enabled: bool,
                   sun_color, sun_radius, max_steps: int = 768,
                   shadow_probe: bool = False, use_skip: bool = True):
    """Path-traced, tone-mapped radiance for a wavefront (RayColor,
    brick_raytracer.comp:203-265; zig_vulkan_tpu/ops/trace.py:867-1325).

    `mats` is `materials_to_device`'s f32[5, 256] table; `sun_position`/
    `sun_color` are float32[3] vectors and `sun_radius` a float32 scalar
    (the per-frame push constants), each on the host or as a tensor on the
    wavefront's device (f32[3], 0-d). With `shadow_probe` (and the
    sun on) each bounce level's sun ray is traced inside its scatter
    traversal (kernel A's shadow build) instead of a second traversal; the
    colours are the same. `use_skip=False` traces every ray with the exact
    cell-by-cell DDA (kernel A's NO_SKIP builds; the records' distance lane
    is then never read). The levels run through kernels A, B and D and the
    tone map through kernel E (`_trace_levels`, `ops.shade`).
    Returns (r, g, b) f32[N] each, in lane order."""
    from . import shade

    dx, dy, dz = _norm3(dx, dy, dz)
    rays = dict(zip(shade.RAY_KEYS, (
        a.clone(memory_format=torch.contiguous_format)
        for a in (ox, oy, oz, dx, dy, dz))))
    mode = shade.sun_mode(sun_enabled, shadow_probe)
    radius = shade._radius(sun_radius)
    targets = (sun_targets(rays["dx"], rays["dy"], rays["dz"],
                           _vec3(sun_position), radius)
               if mode == shade.SUN_PROBE else None)
    state = shade.new_state(rays, mode)
    occluded = _trace_levels(static, tables, material_indices, mats, state,
                             max_bounce, mode,
                             (sun_position, sun_color, sun_radius), targets,
                             max_steps, use_skip)
    color = shade.resolve(state, 1, sun_color if sun_enabled else None,
                          occluded, gamma=False)
    return color.unbind(-1)


# -- camera rays and the frame --------------------------------------------------

CAMERA_BASIS = ("origin", "horizontal", "vertical", "lower_left_corner")


def camera_basis(camera_device) -> np.ndarray:
    """The camera basis (the push-constant payload, Camera.zig:183-193) as
    one float32[12] array: origin, horizontal, vertical, lower-left corner,
    the engine's pc[0:12]."""
    return np.concatenate([np.asarray(getattr(camera_device, name),
                                      dtype=np.float32)
                           for name in CAMERA_BASIS])


def basis_views(basis) -> dict:
    """`camera_vectors`' dict over a float32[12] basis tensor (the layout
    of `camera_basis`): four float32[3] views."""
    return {name: basis[3 * i:3 * i + 3]
            for i, name in enumerate(CAMERA_BASIS)}


def camera_vectors(camera_device, device) -> dict:
    """The camera basis as float32[3] tensors on `device`, views of one
    host-to-device copy. The engine's frame reads the same basis from its
    push constants instead."""
    return basis_views(torch.from_numpy(camera_basis(camera_device))
                       .to(device))


def _camera_rays_soa(cam: dict, width: int, height: int, sample_index,
                     row0=0, rows=None):
    """Per-pixel jittered camera rays (brick_raytracer.comp:162-171 +
    CameraGetRay :474-477) of the `rows` image rows from `row0` on (the
    whole frame by default), row-major, as six f32[rows*width] arrays.
    Pixel y is row0 + its row in the band, in float32; u and v divide by the
    whole frame's width - 1 and height - 1. `sample_index` is a host value
    or a 0-d float32 tensor on the camera's device."""
    w, h = int(width), int(height)
    rows = h if rows is None else int(rows)
    dev = cam["origin"].device
    ys, xs = torch.meshgrid(torch.arange(rows, dtype=F32, device=dev),
                            torch.arange(w, dtype=F32, device=dev),
                            indexing="ij")
    xs = xs.reshape(-1)
    ys = ys.reshape(-1) + _const(row0, dev)
    s = (sample_index if torch.is_tensor(sample_index)
         else _const(sample_index, dev))
    sf = _c(0.2) * (s > 0).to(F32)
    noise_x = rng.hash12(torch.stack([(xs + s) * sf, ys * sf], dim=-1))
    noise_y = rng.hash12(torch.stack([xs * sf, (ys + s) * sf], dim=-1))
    u = _div(xs + noise_x, w - 1)
    v = _div(ys + noise_y, h - 1)
    hvec = cam["horizontal"]
    vvec = cam["vertical"]
    ll = cam["lower_left_corner"]
    o = cam["origin"]
    rdx = hvec[0] * u + ll[0] + vvec[0] * v - o[0]
    rdy = hvec[1] * u + ll[1] + vvec[1] * v - o[1]
    rdz = hvec[2] * u + ll[2] + vvec[2] * v - o[2]
    n = rows * w
    return (o[0].expand(n), o[1].expand(n), o[2].expand(n), rdx, rdy, rdz)


def render_rows(static: GridStatic, tables, material_indices, mats,
                cam: dict, width: int, height: int, spp: int,
                max_bounce: int, sun_position, sun_color, sun_radius,
                sun_enabled: bool, max_steps: int = 768,
                sample_base: float = 0.0, shadow_probe: bool = False,
                use_skip: bool = True, row0=0, rows=None):
    """Render a band of image rows (the sharding unit; the whole frame by
    default): f32[rows, width, 3], tone-mapped and gamma'd
    (brick_raytracer.comp:153-178; zig_vulkan_tpu/ops/trace.py:1382-1470).

    All `spp` samples ride one wavefront of spp*rows*width lanes, so each
    bounce level is one traversal launch (plus one for its shadows, unless
    `shadow_probe`) and one lookup launch, whatever spp is. Per-lane
    results equal a loop over samples: the RNG keys off hit positions and
    the per-sample jitter seed, not lane position. For the same reason, and
    because every operation rounds once, the rows `row0 .. row0 + rows - 1`
    rendered as a band equal those rows of the whole frame bit for bit.
    The camera rays are kernel C, each level kernels A, B and D (and A
    again for the sun rays), the resolve kernel E (`ops.shade`).

    `sample_base` offsets the per-sample jitter seed (sample s uses
    sample_base + s, in float32); temporal accumulation passes
    frame_index * spp so every frame draws fresh sub-pixel samples.
    `use_skip=False` runs the exact DDA (TraceConfig.empty_skip=False).

    The per-frame values may be device tensors on the records' device: the
    camera basis (`cam`, four f32[3]), `sun_position` and `sun_color`
    (f32[3]), `sun_radius` and `sample_base` (0-d). Then nothing on the
    path reads them back or copies from the host (the engine's compiled
    step passes views of its push constants)."""
    from . import shade

    w, h = int(width), int(height)
    rows = h if rows is None else int(rows)
    mode = shade.sun_mode(sun_enabled, shadow_probe)
    probe = mode == shade.SUN_PROBE
    rays = shade.camera_rays(cam, w, h, spp, sample_base, row0, rows,
                             sun=(sun_position, sun_radius) if probe
                             else None)
    state = shade.new_state(rays, mode)
    occluded = _trace_levels(
        static, tables, material_indices, mats, state, max_bounce, mode,
        (sun_position, sun_color, sun_radius),
        tuple(rays[k] for k in shade.TARGET_KEYS) if probe else None,
        max_steps, use_skip)
    color = shade.resolve(state, spp, sun_color if sun_enabled else None,
                          occluded)
    return color.reshape(rows, w, 3)


def render_image(static: GridStatic, arrays, mats, camera_device,
                 sun_position, sun_color, sun_radius, sun_enabled: bool,
                 trace_config: TraceConfig = TraceConfig(), tables=None):
    """Render a full frame from a host CameraDevice on the device the scene
    `arrays` live on (zig_vulkan_tpu/ops/trace.py:1473-1484; the engine
    calls `render_rows` directly). The records are built here
    (`one_shot_tables`) unless `tables` brings them."""
    d = camera_device
    if tables is None:
        tables = one_shot_tables(static, arrays, trace_config.empty_skip)
    return render_rows(
        static, tables, arrays.material_indices, mats,
        camera_vectors(d, tables.device),
        int(d.image_width), int(d.image_height),
        int(d.samples_per_pixel), int(d.max_bounce),
        sun_position, sun_color, sun_radius, sun_enabled,
        max_steps=trace_config.max_steps,
        shadow_probe=bool(trace_config.sun_in_kernel),
        use_skip=trace_config.empty_skip)


# -- array-of-structs entry points ----------------------------------------------
# Thin wrappers over the SoA internals above for callers that hold rays as
# f32[N, 3] (tests, tools); the frame's path uses the SoA functions directly.

def _split3(v):
    return (v[:, 0].contiguous(), v[:, 1].contiguous(), v[:, 2].contiguous())


def grid_hit(static: GridStatic, arrays: GridArrays, origin, direction,
             t_max=float("inf"), ignore_type=None, internal_reflection=None,
             active=None, max_steps: int = 768, tables=None,
             use_skip: bool = False, needs_ignore: bool = True):
    """First voxel hit of a wavefront of rays held as f32[N, 3]
    (zig_vulkan_tpu/ops/trace.py:391-421): kernel A for a scene on a CUDA
    device, its plain version for one on the CPU
    (`ops.tile_tracer.grid_hit_tiles`).

    Args:
      origin, direction: f32[N, 3], direction normalized.
      t_max: scalar upper bound on the hit distance.
      ignore_type, internal_reflection: int32[N] / f32[N] dielectric-skip
        state of each ray: a ray with `ignore_type == MAT_DIELECTRIC` passes
        through dielectric voxels of a brick whose ir equals its
        `internal_reflection` (the kernel's `ray_key`). None, or
        `needs_ignore=False`, skips nothing.
      active: bool[N] lanes to trace (default: all).
      tables: the records of `build_trace_tables`; built here when None
        (`one_shot_tables`).
      use_skip: False traces the exact cell-by-cell DDA, the reference's
        default for this entry point.

    The reference's `mats` argument (never read by its traversal),
    `brick_unroll` (a constant of kernel A) and `bounded_t` are not taken.
    The reference lets `t_max` end a traversal early; its answer is that of
    the unbounded traversal with every hit past `t_max` turned into a miss:
    it tests a voxel only while `entry_t + b_t <= t_max` and reports
    `t = entry_t + b_t - t_off`, distances grow along a ray, and the brick
    after the one where the bound fell is entered past it. So a finite
    `t_max` is applied here after the launch, as `t + t_off <= t_max`; a
    hit within a rounding of the bound may fall on the other side.

    Returns dict(found bool[N], t f32[N], point f32[N, 3], normal f32[N, 3],
    index int32[N]). Only `found` is meaningful on a lane that missed.
    """
    from .tile_tracer import grid_hit_tiles  # imports this module

    if tables is None:
        tables = one_shot_tables(static, arrays, use_skip)
    dev = tables.device
    n = origin.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    key = None
    if needs_ignore and ignore_type is not None:
        nan = torch.full((n,), float("nan"), dtype=F32, device=dev)
        key = torch.where(ignore_type == MAT_DIELECTRIC,
                          internal_reflection.to(F32), nan)
    out = grid_hit_tiles(static, tables, arrays.material_indices,
                         *_split3(origin.to(F32)), *_split3(direction.to(F32)),
                         active, ray_key=key, max_steps=max_steps,
                         use_skip=use_skip)
    found = out["found"]
    t_max = float(_F(t_max))
    if t_max != float("inf"):
        t_off = _c(trace_constants(static)["t_off"])
        found = found & (out["t"] + t_off <= t_max)
    return dict(
        found=found,
        t=out["t"],
        point=torch.stack([out["px"], out["py"], out["pz"]], dim=-1),
        normal=torch.stack([out["nx"], out["ny"], out["nz"]], dim=-1),
        index=out["index"],
    )


def transmission_direction(n1, n2, ray_dir, normal):
    """Bec's-method refraction (brick_raytracer.comp:564-574;
    zig_vulkan_tpu/ops/trace.py:758-768) for f32[N] indices and f32[N, 3]
    vectors: (should_refract bool[N], refracted f32[N, 3])."""
    eta = n1 / n2
    c1 = -_dot3(ray_dir[:, 0], ray_dir[:, 1], ray_dir[:, 2],
                normal[:, 0], normal[:, 1], normal[:, 2])
    w = eta * c1
    c2m = (w - eta) * (w + eta)
    should = c2m >= -1.0
    wk = w - torch.sqrt(torch.clamp(1.0 + c2m, min=0.0))
    return should, eta[:, None] * ray_dir + wk[:, None] * normal


def background_color(direction):
    """GLSL BackgroundColor (brick_raytracer.comp:197-201): the sky's
    white-to-blue blend by the direction's height, f32[N, 3]."""
    t = 0.5 * (direction[:, 1] + 1.0)
    white = torch.ones(3, dtype=F32, device=direction.device)
    blue = torch.tensor([0.5, _c(0.7), 1.0], dtype=F32,
                        device=direction.device)
    return (1.0 - t)[:, None] * white + t[:, None] * blue


def ray_color(static: GridStatic, arrays: GridArrays, mats, origin,
              direction, max_bounce: int, sun_position, sun_enabled: bool,
              sun_color, sun_radius, max_steps: int = 768, tables=None,
              use_skip: bool = False):
    """Path-traced, tone-mapped radiance of a wavefront of rays held as
    f32[N, 3] (zig_vulkan_tpu/ops/trace.py:851-864): f32[N, 3]. `mats` is
    `materials_to_device`'s table; the records are built here when
    `tables` is None."""
    if tables is None:
        tables = one_shot_tables(static, arrays, use_skip)
    cr, cg, cb = _ray_color_soa(
        static, tables, arrays.material_indices, mats,
        *_split3(origin.to(F32)), *_split3(direction.to(F32)), max_bounce,
        sun_position, sun_enabled, sun_color, sun_radius, max_steps,
        use_skip=use_skip)
    return torch.stack([cr, cg, cb], dim=-1)


def camera_rays(cam: dict, width: int, height: int, sample_index,
                row0=0, rows=None):
    """Per-pixel jittered camera rays as (origin f32[N, 3], direction
    f32[N, 3]), directions not normalized
    (zig_vulkan_tpu/ops/trace.py:1371-1379)."""
    oxs, oys, ozs, rdx, rdy, rdz = _camera_rays_soa(
        cam, width, height, sample_index, row0, rows)
    return (torch.stack([oxs, oys, ozs], dim=-1),
            torch.stack([rdx, rdy, rdz], dim=-1))
