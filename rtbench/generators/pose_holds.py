"""Traffic generator `pose_holds`: one closed-loop viewer who moves in steps
and holds each view while the engine's temporal running mean refines it.

- Poses: `poses` camera origins in front of the scene plug-in `target`'s
  block (its `block_voxels(static)`), at `look_at_emissive_block`'s place
  (zig_vulkan_tpu_torch/benchmarks/configs.py: the grid's top centre, 6
  voxels down, then `lift` x dim_y and `back` x dim_z world units of the
  grid), moved along x to `poses` evenly spaced offsets over +-`pose_span`
  x dim_x world units, in a loop. Yaw and pitch are identity.
- Holds: each pose is held for `hold_frames` frames; a move resets the
  running mean. The sun is the configuration's and stays still.
- Warm-up: one period (`poses` x `hold_frames` frames).

`--seed` picks the first pose of the loop and the hold whose frames are
checked: its frames at running-mean counts `checked_counts` (1 is the
hold's first frame), in the window's first period. Every seed's period
holds the same frames, in another order. Set-up refuses a pose whose
camera does not see the block (`path_loop.in_view`, occlusion aside).
"""

from __future__ import annotations

import numpy as np

from rtbench import spec, traffic


def origins(tr: dict, static) -> np.ndarray:
    """f32[poses, 3]: the camera origins of the loop, in order."""
    vs = static.voxel_scale
    vx, _, vz = static.voxel_dims
    span = tr["pose_span"] * static.dim_x * static.scale
    centre = (static.min_point[0] + vx // 2 * vs,
              static.min_point[1] + 6 * vs
              + tr["lift"] * static.dim_y * static.scale,
              static.min_point[2] + vz // 2 * vs
              + tr["back"] * static.dim_z * static.scale)
    return np.stack([np.asarray((centre[0] + dx, centre[1], centre[2]),
                                dtype=np.float32)
                     for dx in np.linspace(-span, span, int(tr["poses"]))])


def build(tr: dict, engine: dict, seed: int, static=None, arrays=None):
    from rtbench.ref.utils import quat as q

    n_poses, hold = int(tr["poses"]), int(tr["hold_frames"])
    if not all(1 <= c <= hold for c in tr["checked_counts"]):
        raise ValueError("a checked count lies outside a hold")
    where = origins(tr, static)
    yaw = np.asarray(q.quat_identity(), dtype=np.float32)
    sun_pos, sun_col = traffic.sun_states(1, 0.0, engine["sun"])
    block = spec.plugin("scenes", tr["target"]).block_voxels(static)
    in_view = spec.plugin("generators", "path_loop").in_view
    for p, o in enumerate(where):
        if not in_view(o, yaw, engine, block.astype(np.float32),
                       static) > 0:
            raise ValueError(f"pose {p} of {tr['name']} does not see the "
                             f"{tr['target']} block")

    offset = int(traffic.rng(seed, 0).integers(0, n_poses))
    period = n_poses * hold
    frames = [traffic.Frame(where[(offset + g // hold) % n_poses], yaw,
                            sun_pos[0], sun_col[0])
              for g in range(period)]
    first = hold * int(traffic.rng(seed, 2).integers(0, n_poses))
    checked = [first + c - 1 for c in tr["checked_counts"]]
    return traffic.Tables(period=period, warmup=period, frames=frames,
                          checked=checked, poses=n_poses, offset=offset)
