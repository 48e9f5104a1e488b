"""Traffic generator `path_loop`: one closed-loop viewer on the reference's
benchmark path, looped, optionally editing before each frame.

- Poses: the reference's 60 s benchmark path (`traffic.path_poses`: 11
  lerped waypoints, 11 component-lerped orientations, written into the
  camera's yaw with the pitch reset), sampled every `path_dt_s` seconds of
  path: `path_duration_s / path_dt_s` poses, looped.
- Sun: the reference's animated sun, advanced `sun_dt_s` a frame, one state
  a pose, looped with them.
- Edits (`edits`, optional): the cycle of batches the edit pattern
  `edits["pattern"]` makes (`rtbench/edits/<pattern>.py`: `cycle(edits,
  static, arrays, seed)`), one batch a frame before its draw.

`--seed` picks the first pose of the loop (a multiple of gcd(poses,
cycle)), what the edit pattern draws from it, and the frames whose images
are checked. Every seed's period then holds the same (pose, sun, cycle
phase) triples, in another order. A run's frame g (g counts from the first
warm-up frame) takes pose `(offset + g) % poses` and batch `g % cycle`, so
every table repeats after `period` frames. The warm-up is whole edit
cycles covering at least one loop of the path.

Checked frames: `check_frames` of the first period of the window. With
edits, one of them is a frame right after the cycle's fullest phase, chosen
among those whose camera sees the pattern's marks (the blocks' centres) at
least half as large as the one that sees them largest (`in_view`).
"""

from __future__ import annotations

import math

import numpy as np

from rtbench import spec, traffic


def in_view(origin, yaw, engine: dict, points, static) -> float:
    """How much of the image `points` (f32[k, 3], voxels (x, y, z), Y up)
    cover from the camera at (origin, yaw), about: the sum over those in
    front of it and within the image of 1 / depth^2 (a block's share of the
    image goes as that). Occlusion is not looked at. World Y grows
    downwards: a voxel's world position is min_point + (x, dim_y - y, z)
    voxel scales."""
    from rtbench.ref.config import CameraConfig
    from rtbench.ref.core.camera import Camera
    from rtbench.ref.engine import VFOV_DEGREES
    from rtbench.ref.utils import quat as q

    cam = Camera(VFOV_DEGREES, engine["internal_resolution_width"],
                 engine["internal_resolution_height"], CameraConfig())
    cam.d_camera.origin = np.asarray(origin, np.float64)
    cam.yaw = np.asarray(yaw, np.float32)
    cam.pitch = q.quat_identity()
    cam.propagate_pitch_change()
    d = cam.d_camera
    vs = static.voxel_scale
    vy = static.voxel_dims[1]
    world = np.stack([static.min_point[0] + points[:, 0] * vs,
                      static.min_point[1] + (vy - points[:, 1]) * vs,
                      static.min_point[2] + points[:, 2] * vs], axis=-1)
    o = np.asarray(d.origin, np.float64)
    m = np.stack([np.asarray(d.horizontal, np.float64),
                  np.asarray(d.vertical, np.float64), np.zeros(3)], axis=1)
    rhs = o - np.asarray(d.lower_left_corner, np.float64)
    seen = 0.0
    for p in world:
        # the ray through image point (u, v) is s (p - o), s = 1 / depth
        m[:, 2] = -(p - o)
        try:
            u, v, s = np.linalg.solve(m, rhs)
        except np.linalg.LinAlgError:
            continue
        if s > 0 and 0 <= u <= 1 and 0 <= v <= 1:
            seen += s * s
    return seen


def build(tr: dict, engine: dict, seed: int, static=None, arrays=None):
    n_poses = int(round(tr["path_duration_s"] / tr["path_dt_s"]))
    origins, yaws = traffic.path_poses(n_poses, tr["path_dt_s"],
                                       tr["path_duration_s"])
    sun_pos, sun_col = traffic.sun_states(n_poses, tr["sun_dt_s"],
                                          engine["sun"])
    edits = tr.get("edits")
    cyc, batches, fullest, marks = 0, [], None, None
    if edits:
        pattern = spec.plugin("edits", edits["pattern"])
        batches, fullest, marks = pattern.cycle(edits, static, arrays, seed)
        cyc = len(batches)
    # the first pose, a multiple of gcd(poses, cycle): every seed's period
    # then holds the same (pose, cycle phase) pairs, in another order
    step = math.gcd(n_poses, cyc) if cyc else 1
    offset = step * int(traffic.rng(seed, 0).integers(0, n_poses // step))
    period = n_poses if not cyc else n_poses * cyc // step
    warmup = n_poses if not cyc else cyc * -(-n_poses // cyc)

    frames = []
    for g in range(period):
        p = (offset + g) % n_poses
        frames.append(traffic.Frame(
            origins[p], yaws[p], sun_pos[p], sun_col[p],
            (batches[g % cyc],) if cyc else ()))

    pick = traffic.rng(seed, 2)
    k = int(tr["check_frames"])
    checked = set()
    if cyc:
        # a frame right after the fullest phase whose camera sees the
        # marks large
        after = [w for w in range(period) if (warmup + w) % cyc == fullest]
        seen = [in_view(frames[(warmup + w) % period].origin,
                        frames[(warmup + w) % period].yaw, engine, marks,
                        static) for w in after]
        best = [w for w, s in zip(after, seen) if s >= max(seen) / 2]
        checked.add(int(pick.choice(best)))
    while len(checked) < min(k, period):
        checked.add(int(pick.integers(0, period)))
    return traffic.Tables(
        period=period, warmup=warmup, frames=frames, checked=sorted(checked),
        scene_period=cyc or None, fullest=fullest, poses=n_poses,
        offset=offset)
