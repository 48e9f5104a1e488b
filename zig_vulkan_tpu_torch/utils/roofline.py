"""The least time the card could take for the work of a kernel launch.

A launch's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the operations it does on these inputs over the card's peak rate.
The rates are NVIDIA's published peaks for one H100 SXM (dense, at the
700 W power limit): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside
the tensor cores.

Kernel A (csrc/traverse.cu) moves, per lane, its ray (6 f32), its `active`
byte, the optional dielectric key (f32) and sun target (3 f32), and writes
`found` (1 byte), t, the hit point and normal (7 f32) and `index` (int32),
plus `occluded` (1 byte) with sun targets and `n_step` (int32) in the
stats builds; each lane that hits reads one material byte. The records
the rays visit depend on the path of every ray and are not counted, so
the bound is low by at most the distinct records read (the default
scene's 1,048,576 cells: 16 MiB unkeyed, 32 MiB keyed). Its operations are
its loop iterations (the stats build's `n_step`, summed) times
MIN_OPS_PER_ITERATION, the operations of the cheapest iteration; the
brick entries, leaps and voxel steps cost more, and the sun rays of the
SHADOW builds are not in `n_step`, so this count too is low, never high.

Kernel B (csrc/lookup.cu) reads one int32 index and writes one f32 per
table a lane; its tables (a few KiB) are read once per block.

Kernels C, D and E (csrc/camera.cu, shade.cu, resolve.cu) read and write
flat arrays, every lane once: their bytes are counted from the arrays each
launch reads and writes (kernel D skips the state writes that would store
the value read, so those count for the lanes that change), and their
operations from the source, by hand: the float operations of each lane's
hashes, square roots and selects (`CAMERA_OPS`, `SHADE_OPS`,
`RESOLVE_OPS_PER_SAMPLE`), leaving out index arithmetic; both counts are
low, never high.

Kernel F (csrc/denoise.cu) reads its input slab and writes its output
rows, 12 bytes a pixel each (and the runtime builds' three knobs); its
operations are counted from the source by hand a tap and a pixel
(`denoise_ops`), with `POWF_OPS` standing for each call of powf, an
estimate. On the runtime path a masked tap needs work only where it reads a
value that is not finite (elsewhere it adds +0): the caller counts those
pixels from the image; the taps' influences from the knobs are needed once
a launch.

The voxel edits (csrc/edit.cu) read the edit buffer, 16 bytes a lane
(three coordinates and a material, int32 each); an insert with the records
current also reads the status bitmap (a bit a cell) and writes the field
(int32 a cell). The bricks, words and rows an edit changes (a few hundred
bytes a brush stroke) are not counted, so the bound is low, never high.

`warp_use_share` measures divergence from a stats build's `n_step`: the
share of lane-iterations that do work when lanes 32w..32w+31 run together
as warp w until the longest of them is done. `slowest_lanes` picks the rays
whose chains of steps end a launch.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# The float and integer operations of kernel A's cheapest loop iteration,
# the step over an empty cell (csrc/traverse.cu, trace_ray's loop), counted
# by hand from the source: the loop's bound test and counter (2), the grid
# bounds test (6 compares), the cell index (2 multiplies, 2 adds), the
# record's address (2), the empty-record test (1), the axis choice (3
# compares), the step (a multiply and two adds: 3). Logic that folds into
# predicates is not counted, nor the leap test of the SKIP builds.
MIN_OPS_PER_ITERATION = 21

RAY_IN_BYTES = 6 * 4 + 1      # origin, direction, active
KEY_BYTES = 4                 # ray_key
TARGET_BYTES = 3 * 4          # sun target
HIT_OUT_BYTES = 1 + 7 * 4 + 4  # found; t, px..pz, nx..nz; index
OCCLUDED_BYTES = 1
N_STEP_BYTES = 4
MATERIAL_BYTE = 1


def traverse_bytes_per_lane(has_key: bool = False, shadow: bool = False,
                            stats: bool = False) -> int:
    """Bytes kernel A must move for every lane, hit or not."""
    return (RAY_IN_BYTES + HIT_OUT_BYTES
            + (KEY_BYTES if has_key else 0)
            + ((TARGET_BYTES + OCCLUDED_BYTES) if shadow else 0)
            + (N_STEP_BYTES if stats else 0))


def traverse_bytes(n: int, hits: int, has_key: bool = False,
                   shadow: bool = False, stats: bool = False) -> int:
    """Bytes of one kernel A launch over `n` lanes of which `hits` hit
    (records not counted, see the module docstring)."""
    return (n * traverse_bytes_per_lane(has_key, shadow, stats)
            + hits * MATERIAL_BYTE)


def lookup_bytes(n: int, n_tables: int, size: int) -> int:
    """Bytes of one kernel B launch: indices in, values out, the tables."""
    return n * (4 + 4 * n_tables) + 4 * n_tables * size


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    """(least time in ms, "bytes" or "operations"): the larger of the two
    times at the card's peak rates."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def traverse_bound_ms(n: int, hits: int, iterations: int,
                      has_key: bool = False, shadow: bool = False,
                      stats: bool = False):
    """(ms, bound_by) of one kernel A launch; `iterations` is the launch's
    loop iterations summed over its lanes, as the stats build counts them
    (the first traversal only: a SHADOW build's sun rays are left out)."""
    return bound_ms(traverse_bytes(n, hits, has_key, shadow, stats),
                    iterations * MIN_OPS_PER_ITERATION)


# float operations of the shared device functions (csrc/shading.cuh),
# counted by hand: hsin 19 (2 to reduce, 1 floor, 1 subtract of the
# multiple, a square, 6 Horner steps of 2, the last multiply), rand2 its
# two products and sum, hsin, a multiply and fract (2); rand_vec3_range
# three rand2 with a multiply-add each and the 4 adds of the chained seeds;
# rand1 a multiply, hsin, a multiply and fract; rand3 rand1, 2 adds and
# rand2; norm3 3 squares, 2 adds, a root, a reciprocal and 3 multiplies;
# hash12 24; a sun target rand_vec3_range, the 2 seed adds, a negation and
# a subtraction for the range, 3 adds
_HSIN = 19
_RAND2 = 3 + _HSIN + 3
_RAND_VEC3 = 3 * (_RAND2 + 2) + 4
_RAND3 = (1 + _HSIN + 3) + 2 + _RAND2
_NORM3 = 10
_DOT3 = 5
_HASH12 = 24
_SUN_TARGET = _RAND_VEC3 + 4 + 3

# kernel C a lane: two hash12, the seed and jitter factors (8), u and v (4),
# the direction (3 x 4), its normalization; a sun target with targets
CAMERA_OPS = 2 * _HASH12 + 8 + 4 + 12 + _NORM3
# kernel D a lane: the lambertian (rand_vec3_range, 3 adds, norm3), the
# metal (a dot, the reflection 9, the fuzz range 2, rand_vec3_range, 3
# adds, norm3, a dot and a compare), the dielectric (rand_vec3_range, 3
# adds, norm3, the division, a dot and a negation, 3 for w and c2m, the
# compare, add, clamp, root and subtract 5, rand3 and its compare, a dot,
# the two candidate directions 18 and norm3), the colour (about 12 adds,
# multiplies and selects); with a shadow launch the target, the direction
# (3 subtracts, norm3) and the 3 pending products; sun targets of the next
# level
SHADE_OPS = ((_RAND_VEC3 + 3 + _NORM3)
             + (_DOT3 + 9 + 2 + _RAND_VEC3 + 3 + _NORM3 + _DOT3 + 1)
             + (_RAND_VEC3 + 3 + _NORM3 + 1 + _DOT3 + 1 + 3 + 5 + _RAND3
                + 1 + _DOT3 + 18 + _NORM3)
             + 12)
SHADE_SHADOW_OPS = _SUN_TARGET + 3 + _NORM3 + 3
SHADE_TARGET_OPS = _SUN_TARGET
# kernel E a lane: the pending term (3), the sky (2 + 9, 3 with the sun),
# its add (3), the tone map (6), the sum (3); a pixel: 3 divisions and 3
# roots
RESOLVE_OPS_PER_SAMPLE = 3 + 11 + 3 + 3 + 6 + 3
RESOLVE_OPS_PER_PIXEL = 6

RAY_BYTES = 6 * 4             # origin and direction
STATE_READ_BYTES = (1 + 6 * 4 + 5 * 4 + 3 * 4 + 4 + 4 + 4 + 1 + 3 * 4)
# found, hit point and normal, the five looked-up values, direction,
# internal reflection, ignore type, loop count, bouncing, colour


def camera_bytes(n: int, targets: bool = False) -> int:
    """Bytes of one kernel C launch over `n` lanes: the rays (and sun
    targets) written, the basis, sample base and sun values read."""
    return n * (RAY_BYTES + (TARGET_BYTES if targets else 0)) + 4 * (
        12 + 1 + (4 if targets else 0))


def shade_bytes(n: int, active: int, bouncing: int, mode: int,
                prev: bool = False, next_key: bool = False,
                next_targets: bool = False) -> int:
    """Bytes of one kernel D launch over `n` lanes, `active` of them hit
    and `bouncing` of them bounce on (`ops.shade.sun_mode`'s `mode`;
    `prev`: a pending term from the previous level is added)."""
    from ..ops import shade

    per = STATE_READ_BYTES + 4 + 1 + 3 * 4  # + loop count, bouncing, colour
    if mode == shade.SUN_PROBE:
        per += OCCLUDED_BYTES
    if mode == shade.SUN_DEFERRED:
        per += 3 * 4 + 1 + 3 * 4  # pending, the shadow mask and directions
    if prev:
        per += 3 * 4 + OCCLUDED_BYTES
    if next_key:
        per += KEY_BYTES
    if next_targets:
        per += TARGET_BYTES
    # origin, internal reflection and ignore type of the lanes that hit;
    # the direction of the lanes that bounce on
    return n * per + active * (3 * 4 + 4 + 4) + bouncing * 3 * 4 + 4 * 7


def resolve_bytes(n: int, pixels: int, pending: bool = False) -> int:
    """Bytes of one kernel E launch: colour, loop count and direction's y
    of the `n` lanes (and the pending term and its shadow hits), the
    `pixels` RGB values written."""
    per = 3 * 4 + 4 + 4 + ((3 * 4 + OCCLUDED_BYTES) if pending else 0)
    return n * per + pixels * 3 * 4 + 3 * 4


def camera_bound_ms(n: int, targets: bool = False):
    return bound_ms(camera_bytes(n, targets),
                    n * (CAMERA_OPS + (_SUN_TARGET if targets else 0)))


def shade_bound_ms(n: int, active: int, bouncing: int, mode: int,
                   prev: bool = False, next_key: bool = False,
                   next_targets: bool = False):
    from ..ops import shade

    ops = SHADE_OPS + (SHADE_SHADOW_OPS if mode == shade.SUN_DEFERRED
                       else 0) + (SHADE_TARGET_OPS if next_targets else 0)
    return bound_ms(shade_bytes(n, active, bouncing, mode, prev, next_key,
                                next_targets), n * ops)


def resolve_bound_ms(n: int, pixels: int, pending: bool = False):
    return bound_ms(resolve_bytes(n, pixels, pending),
                    n * RESOLVE_OPS_PER_SAMPLE
                    + pixels * RESOLVE_OPS_PER_PIXEL)


# kernel F, counted by hand from csrc/denoise.cu: a bilinear sample 9 a
# channel (four products, two sums, the lerp of the rows); a tap's length
# (3 squares, 2 adds, the root), its normal (the clamp, 3 divisions), the
# dot product (5), the hue's base and clamp (3), the saturation's
# difference, absolute value, complement and clamp (4), the influence (2),
# the two running sums (1 + 3 products + 3 adds); each powf as POWF_OPS, an
# estimate of its log2 polynomial, product and exp2 (the CUDA math
# library's, not counted from the compiled code); a coordinate on one axis
# of the resampling path (the offset or the half and the division, the
# scale, the half pixel, floor, the fraction and its complement: 6, 7 for
# the centre's); a pixel's centre length and normal (10) and the final
# divisions (3)
POWF_OPS = 20
DENOISE_SAMPLE_OPS = 27
DENOISE_TAP_OPS = 31 + 2 * POWF_OPS
DENOISE_COORD_OPS = 6
DENOISE_CENTRE_COORD_OPS = 7
DENOISE_PIXEL_OPS = 13
# the runtime path: a masked tap's three products by 0 and three sums (its
# bilinear sample is DENOISE_SAMPLE_OPS); a tap's influence from the knobs
# (the root, the square, the division, the clamp, powf, the product, the
# complement, the cube's two products)
DENOISE_MASKED_OPS = 6
DENOISE_INFLUENCE_OPS = 8 + POWF_OPS
PIXEL_BYTES = 3 * 4
KNOB_BYTES = 3 * 4


def denoise_ops(pixels: int, taps: int, mode: int, masked_taps: int = 0,
                masked_pixels: int = 0, influences: int = 0) -> int:
    """Float operations of one kernel F launch over `pixels` output pixels
    with `taps` live taps, in `ops.denoise`'s `mode`; on the runtime path
    also `masked_taps` masked taps at each of the `masked_pixels` output
    pixels whose masked taps read a value that is not finite, and
    `influences` taps' influences computed from the knobs."""
    from ..ops import denoise

    centre = 2 * DENOISE_CENTRE_COORD_OPS + DENOISE_SAMPLE_OPS
    if mode == denoise.RESAMPLE_ONLY:
        return pixels * centre
    tap = DENOISE_SAMPLE_OPS + DENOISE_TAP_OPS
    masked = DENOISE_SAMPLE_OPS + DENOISE_MASKED_OPS
    per = DENOISE_PIXEL_OPS
    if mode == denoise.RESAMPLE:
        tap += 2 * DENOISE_COORD_OPS
        masked += 2 * DENOISE_COORD_OPS
        per += centre
    return (pixels * (taps * tap + per)
            + masked_pixels * masked_taps * masked
            + influences * DENOISE_INFLUENCE_OPS)


def denoise_bytes(in_pixels: int, out_pixels: int,
                  runtime: bool = False) -> int:
    """Bytes of one kernel F launch: the slab's pixels read, the output
    rows' written, the runtime path's knobs read."""
    return PIXEL_BYTES * (in_pixels + out_pixels) + KNOB_BYTES * runtime


def denoise_bound_ms(in_pixels: int, out_pixels: int, taps: int, mode: int,
                     masked_taps: int = 0, masked_pixels: int = 0,
                     influences: int = 0):
    """(bound ms, what bounds it) of one kernel F launch (`denoise_ops`'
    arguments; `influences` > 0 on the runtime path)."""
    return bound_ms(denoise_bytes(in_pixels, out_pixels, influences > 0),
                    denoise_ops(out_pixels, taps, mode, masked_taps,
                                masked_pixels, influences))


EDIT_LANE_BYTES = 4 * 4  # x, y, z and the material, int32 each


def edit_bytes(op: str, lanes: int, cells: int, records: bool = True) -> int:
    """Bytes of one edit ("insert" or "remove") of `lanes` padded lanes on
    a grid of `cells` cells: the buffer in and, for an insert with the
    records current, the status bits in and the field out."""
    field = cells // 8 + 4 * cells if op == "insert" and records else 0
    return lanes * EDIT_LANE_BYTES + field


def edit_bound_ms(op: str, lanes: int, cells: int, records: bool = True):
    """(bound ms, what bounds it) of one edit (`edit_bytes`' arguments)."""
    return bound_ms(edit_bytes(op, lanes, cells, records))


def warp_use_share(n_step) -> float:
    """Σ n_step / Σ_w 32·max_{lane in w} n_step over warps of 32
    consecutive lanes (the last warp padded with idle lanes); NaN when no
    lane iterates."""
    s = np.asarray(n_step, dtype=np.int64).ravel()
    if s.size == 0:
        return float("nan")
    pad = (-s.size) % 32
    w = np.concatenate([s, np.zeros(pad, np.int64)]).reshape(-1, 32)
    life = 32 * int(w.max(axis=1).sum())
    return float(s.sum()) / life if life else float("nan")


def slowest_lanes(n_step, active, share: float = 0.01):
    """bool mask of the active lanes whose `n_step` (torch, int) is above
    the active lanes' (1 - share) quantile: the slowest `share` of the
    rays, or fewer where many tie at the quantile."""
    import torch

    act = n_step[active].float()
    if act.numel() == 0:
        return torch.zeros_like(active)
    return active & (n_step > torch.quantile(act, 1.0 - share))
