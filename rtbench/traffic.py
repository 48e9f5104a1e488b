"""A run's traffic: a mix's data file in, the run's tables out.

A mix (`rtbench/traffic/<name>.json`) names its generator
(`rtbench/generators/<generator>.py`, whose `build(traffic, engine, seed,
static, arrays)` returns `Tables`); the generator may hand part of the work
to other plug-ins the mix names, such as an edit pattern
(`rtbench/edits/<pattern>.py`). Everything a frame of a run needs is worked
out in set-up, from the mix's parameters, the configuration and `--seed`;
inside the measured window the harness only indexes the tables.

A frame is a pose, a sun and a tuple of actions made before the draw. An
action is any object with a `name` (its kind, which names its host range in
a trace and the list of its card times), `program(rt)`, which makes it
through the program's public API, and `reference(ref)`, which makes it in
the reference engine. `Edit` is the one action of this module; a
generator may bring its own.

This module also holds the arithmetic generators share: the reference's
benchmark path (`path_poses`) and its animated sun (`sun_states`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# the reference benchmark's path (Benchmark.zig:146-172; a frozen copy of
# zig_vulkan_tpu_torch/engine/benchmark.py's PATH_POINTS and PATH_EULERS)
PATH_POINTS = (
    (0, 0, 0), (2, 5, 0), (3, 5, 5), (5, 2, 1), (10, 0, 10), (20, -20, 20),
    (10, -25, 15), (10, -22, 20), (10, -30, 25), (5, -10, 10), (0, 13, 0))
PATH_EULERS = (
    (0, 0, 0), (0, 45, 0), (10, -20, 0), (20, 180, 0), (50, 90, 0),
    (60, 0, 0), (80, -10, 0), (75, -40, 0), (80, -10, 0), (80, -90, 0),
    (0, -145, 0))

INSERT = "insert"
REMOVE = "remove"


@dataclasses.dataclass
class Edit:
    """An edit batch: voxels int32[n, 3] (x, y, z) and, for an insert,
    their materials uint8[n]. Through the program: `VoxelRT.insert_voxels`
    or `remove_voxels`."""

    kind: str
    xyz: np.ndarray
    mats: Optional[np.ndarray]
    name = "edit"

    def program(self, rt) -> None:
        if self.kind == INSERT:
            rt.insert_voxels(self.xyz, self.mats)
        else:
            rt.remove_voxels(self.xyz)

    def reference(self, ref) -> None:
        if self.kind == INSERT:
            ref.insert(self.xyz, self.mats)
        else:
            ref.remove(self.xyz)


@dataclasses.dataclass
class Frame:
    """What frame g hands the program: the camera's origin f32[3] and yaw
    quaternion f32[4] (pitch identity), the sun's position and colour
    f32[3], and the actions made before the draw."""

    origin: np.ndarray
    yaw: np.ndarray
    sun_position: np.ndarray
    sun_color: np.ndarray
    actions: Tuple = ()


@dataclasses.dataclass
class Tables:
    period: int              # frames after which every table repeats
    warmup: int              # warm-up frames (frames 0 .. warmup - 1)
    frames: List[Frame]      # frame g is frames[g % period]
    checked: List[int]       # window frames (from warmup) whose images
    #                          are checked
    # frames after which the scene repeats once the warm-up is over (None:
    # it never does, and the reference replays every frame's actions)
    scene_period: Optional[int] = None
    # the phase (frame % scene_period) after which the scene holds the most
    # edits: the program is handed the actions up to one after the window,
    # and its scene is then checked voxel by voxel (None: right after the
    # window)
    fullest: Optional[int] = None
    poses: int = 0           # poses in the loop, where the path loops
    offset: int = 0          # the loop's first pose (from the seed)

    def frame(self, g: int) -> Frame:
        return self.frames[g % self.period]

    def same_scene(self, g: int) -> int:
        """The earliest frame after whose actions the scene is what it is
        after frame g's."""
        if self.scene_period is None or g < self.warmup:
            return g
        return self.warmup + (g - self.warmup) % self.scene_period


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def path_poses(n: int, dt: float, duration: float):
    """(origin f32[n, 3], yaw f32[n, 4]) of the benchmark path at path
    times 0, dt, 2 dt, ... (Benchmark.update, Benchmark.zig:46-74, with its
    state carried as there: past the last waypoint the origin stays where
    it was). A frozen copy of `zig_vulkan_tpu_torch/engine/benchmark.py`'s
    arithmetic."""
    from .ref.utils import quat as q

    points = [np.asarray(p, dtype=np.float32) for p in PATH_POINTS]
    orients = [q.quat_from_euler_angles(*e) for e in PATH_EULERS]
    point_frac = duration / len(points)
    orient_frac = duration / len(orients)
    origin, yaw = points[0].copy(), orients[0].copy()
    origins, yaws = [], []
    for i in range(n):
        timer = i * dt
        idx = int(timer // point_frac)
        if idx < len(points) - 1:
            t = (timer % point_frac) / point_frac
            origin = q.lerp(points[idx], points[idx + 1], np.float32(t))
        oidx = int(timer // orient_frac)
        if oidx < len(orients) - 1:
            t = (timer % orient_frac) / orient_frac
            yaw = q.quat_lerp(orients[oidx], orients[oidx + 1],
                              np.float32(t))
        origins.append(np.asarray(origin, dtype=np.float32))
        yaws.append(np.asarray(yaw, dtype=np.float32))
    return np.stack(origins), np.stack(yaws)


def sun_states(n: int, dt: float, sun: dict):
    """(position f32[n, 3], colour f32[n, 3]): the sun after 1 .. n updates
    of `dt` seconds (the reference's Sun, Sun.zig:65-86, updated before each
    draw)."""
    from .ref.config import SunConfig
    from .ref.core.sun import Sun

    s = Sun(SunConfig(animate=sun["animate"],
                      animate_speed=sun["animate_speed"],
                      enabled=sun["enabled"], color=tuple(sun["color"]),
                      radius=sun["radius"],
                      sun_distance=sun["sun_distance"]))
    pos, col = [], []
    for _ in range(n):
        s.update(dt)
        pos.append(np.asarray(s.device_data.position, dtype=np.float32))
        col.append(np.asarray(s.device_data.color, dtype=np.float32))
    return np.stack(pos), np.stack(col)


def build(traffic: dict, engine: dict, seed: int, static=None,
          arrays=None) -> Tables:
    """The tables of a run: `traffic` is the mix's file, `engine` the
    configuration's "engine" entry, `static`/`arrays` the set-up scene's
    reference grid (host arrays; needed only where the mix edits)."""
    from . import spec

    return spec.plugin("generators", traffic["generator"]).build(
        traffic, engine, seed, static, arrays)
