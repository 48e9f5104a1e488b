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
