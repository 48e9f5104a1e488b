"""Animated directional sun light.

Frozen copy of `zig_vulkan_tpu_torch/core/sun.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

Re-implements the reference sun (reference: src/modules/voxel_rt/Sun.zig):
a (0, -sun_distance, 0) vector rotated by slerping between three key
orientations, with a matching three-color day-phase lerp (Sun.zig:36-46,
65-86). The device struct matches the push constant
{position, enabled, color, radius} (Sun.zig:13-18).

Host-side update (a few flops per frame); the device values cross as
trace-time scalars in the render step.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SunConfig
from ..utils import quat as q

_F32 = np.float32


@dataclasses.dataclass
class SunDevice:
    """Device push-constant equivalent (reference Sun.zig:13-18)."""

    position: np.ndarray  # (3,) f32
    enabled: bool
    color: np.ndarray     # (3,) f32
    radius: np.float32


class Sun:
    """Animated sun (reference Sun.zig)."""

    def __init__(self, config: SunConfig = SunConfig()):
        self.animate = config.animate
        self.animate_speed = _F32(config.animate_speed)
        self.slerp_index = 0
        self.slerp_pos = _F32(0.0)
        # three day-phase orientations (Sun.zig:36-40)
        self.slerp_orientations = [
            q.quat_from_euler_angles(0.0, 0.0, 0.0),
            q.quat_from_euler_angles(0.0, 10.0, 120.0),
            q.quat_from_euler_angles(0.0, 0.0, 240.0),
        ]
        # three day-phase colors (Sun.zig:42-46)
        self.lerp_color = [
            np.array([1.0, 0.99, 0.823], dtype=_F32),
            np.array([0.9, 0.45, 0.45], dtype=_F32),
            np.array([1.0, 0.7569, 0.5412], dtype=_F32),
        ]
        self.static_pos_vec = np.array([0.0, -config.sun_distance, 0.0], dtype=_F32)
        self.device_data = SunDevice(
            position=self.static_pos_vec.copy(),
            enabled=bool(config.enabled),
            color=np.asarray(config.color, dtype=_F32),
            radius=_F32(config.radius),
        )

    def update(self, delta_time: float) -> None:
        """Advance the animation (reference Sun.zig:65-86)."""
        if not self.animate or not self.device_data.enabled:
            return

        next_index = (self.slerp_index + 1) % len(self.slerp_orientations)
        quat_a = self.slerp_orientations[self.slerp_index]
        quat_b = self.slerp_orientations[next_index]
        self.device_data.position = q.quat_rotate_vec(
            q.quat_slerp(quat_a, quat_b, self.slerp_pos), self.static_pos_vec
        )

        color_a = self.lerp_color[self.slerp_index]
        color_b = self.lerp_color[next_index]
        self.device_data.color = q.lerp(color_a, color_b, self.slerp_pos).astype(_F32)

        self.slerp_pos = _F32(self.slerp_pos + self.animate_speed * _F32(delta_time))
        if self.slerp_pos > 1.0:
            self.slerp_pos = _F32(self.slerp_pos - np.floor(self.slerp_pos))
            self.slerp_index = next_index
