"""Reference engine `temporal`: `rtbench.ref.engine.RefEngine` with the
engine's temporal running mean (zig_vulkan_tpu_torch/engine/engine.py:
VoxelRT.set_temporal), for a configuration whose "engine" entry holds
`"temporal": true`.

The semantics, from the engine's documentation: while the pose key (the
camera's origin, the lower-left corner of its view and the sun's position)
stays what it was on the frame before, each frame's traced image goes into
a running mean, and a frame whose key differs starts it again. The c-th
frame of a hold (c from 0) is traced with its jitter seeds offset by
`sample_base = c * spp` and added as `a += (img - a) / (c + 1)` in
float32, `a` starting at zero; the post-process then runs on the mean.

`advance(frame)` makes the frame's actions and follows the holds;
`traced(...)` returns the mean of the current hold up to the last frame
advanced, tracing each of its frames through `ops.trace.render_rows`.
The means are kept, one a sample count, so that the frames of one hold
are traced once. Plain torch on the frozen twins; nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.ref.config import CameraConfig
from rtbench.ref.core.camera import Camera
from rtbench.ref.engine import VFOV_DEGREES, RefEngine
from rtbench.ref.ops import trace
from rtbench.ref.utils import quat as q


class Engine(RefEngine):
    """`RefEngine` of the configuration without `temporal`, with the
    running mean over the holds of the frames advanced."""

    def __init__(self, grid, materials, engine: dict, device):
        super().__init__(grid, materials,
                         {k: v for k, v in engine.items() if k != "temporal"},
                         device)
        self.hold_key = None  # the pose key of the current hold
        self.count = 0        # frames advanced in the current hold
        self._keys = {}       # (origin, yaw, sun) bytes -> pose key
        self._means = {}      # spp -> (frames in the mean, the mean)

    def pose_key(self, origin, yaw, sun_position):
        """The engine's pose key of a pose: the camera's origin and
        lower-left corner (yaw given, pitch identity), the sun's
        position."""
        parts = tuple(np.ascontiguousarray(v, dtype=np.float32)
                      for v in (origin, yaw, sun_position))
        cached = b"".join(p.tobytes() for p in parts)
        key = self._keys.get(cached)
        if key is None:
            e = self.engine
            cam = Camera(VFOV_DEGREES, e["internal_resolution_width"],
                         e["internal_resolution_height"], CameraConfig())
            cam.d_camera.origin = parts[0]
            cam.yaw = parts[1]
            cam.pitch = q.quat_identity()
            cam.propagate_pitch_change()
            d = cam.d_camera
            key = self._keys[cached] = (
                tuple(np.asarray(d.origin).tolist()),
                tuple(np.asarray(d.lower_left_corner).tolist()),
                tuple(parts[2].tolist()))
        return key

    def advance(self, frame) -> None:
        """Make frame `frame`'s actions and count it into its hold."""
        super().advance(frame)
        key = self.pose_key(frame.origin, frame.yaw, frame.sun_position)
        if key != self.hold_key:
            self.hold_key, self.count, self._means = key, 0, {}
        self.count += 1

    def traced(self, origin, yaw, sun_position, sun_color, spp=None):
        """The running mean f32[ih, iw, 3] of the current hold's frames
        (before the post-process), each traced at the configuration's
        samples a pixel or `spp`. The pose must be the last frame
        advanced's."""
        if self.pose_key(origin, yaw, sun_position) != self.hold_key:
            raise ValueError("traced: the pose is not the current hold's")
        e = self.engine
        sun, tc, cam = e["sun"], e["trace"], e["camera"]
        spp = spp or cam["samples_per_pixel"]
        done, mean = self._means.get(spp, (0, None))
        arrays, _, records = self.scene()
        basis = self.basis(origin, yaw)
        if mean is None:
            mean = torch.zeros(e["internal_resolution_height"],
                               e["internal_resolution_width"], 3,
                               dtype=torch.float32, device=self.device)
        for c in range(done, self.count):
            img = trace.render_rows(
                self.static, records, arrays.material_indices, self.mats,
                basis, e["internal_resolution_width"],
                e["internal_resolution_height"], spp, cam["max_bounce"] + 1,
                np.asarray(sun_position, dtype=np.float32),
                np.asarray(sun_color, dtype=np.float32),
                np.float32(sun["radius"]), bool(sun["enabled"]),
                max_steps=tc["max_steps"], sample_base=float(c * spp),
                shadow_probe=bool(tc["sun_in_kernel"]),
                use_skip=bool(tc["empty_skip"]))
            mean = mean + trace._div(img - mean, float(c + 1))
        self._means[spp] = (self.count, mean)
        return mean.clone()
