"""Ray-tracing camera.

Frozen copy of `zig_vulkan_tpu_torch/core/camera.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

Re-implements the reference camera (reference: src/modules/voxel_rt/Camera.zig)
as a host-side mutable wrapper around a pure float32 state:

- viewport derived from vertical fov (Camera.zig:36-77);
- orientation = (yaw * pitch).norm() quaternion pair with a +-90 degree pitch
  clamp (Camera.zig:124-151);
- the device-visible struct `CameraDevice` matches the reference push
  constant {image size, horizontal, vertical, lower_left_corner, origin,
  samples_per_pixel, max_bounce} (Camera.zig:183-193). Note the reference's
  `max_bounce + 1` rule (Camera.zig:74): user-facing max_bounce of 0 means
  "primary rays only", and the device value is user value + 1.

The camera basis math runs on host numpy (it is a handful of flops per
frame); only `CameraDevice` crosses to the device, as trace-time scalars.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import CameraConfig
from ..utils import quat as q

_F32 = np.float32

_WORLD_UP = np.array([0.0, 1.0, 0.0], dtype=_F32)
_FORWARD = np.array([0.0, 0.0, 1.0], dtype=_F32)


@dataclasses.dataclass
class CameraDevice:
    """Device push-constant equivalent (reference Camera.zig:183-193)."""

    image_width: int
    image_height: int
    horizontal: np.ndarray      # (3,) f32
    vertical: np.ndarray        # (3,) f32
    lower_left_corner: np.ndarray  # (3,) f32
    origin: np.ndarray          # (3,) f32
    samples_per_pixel: int
    max_bounce: int             # internal value = user max_bounce + 1


class Camera:
    """Interactive FPS camera (reference Camera.zig)."""

    def __init__(self, vertical_fov: float, image_width: int, image_height: int,
                 config: CameraConfig = CameraConfig()):
        aspect_ratio = _F32(image_width) / _F32(image_height)
        theta = _F32(vertical_fov) * _F32(np.pi / 180.0)
        viewport_height = _F32(config.viewport_height) * _F32(np.tan(theta * _F32(0.5)))
        viewport_width = aspect_ratio * viewport_height

        self.turn_rate = _F32(config.turn_rate)
        self.normal_speed = _F32(config.normal_speed)
        self.sprint_speed = _F32(config.sprint_speed)
        self.movement_speed = _F32(config.normal_speed)
        self.user_input_disabled = config.user_input_disabled
        self.viewport_width = viewport_width
        self.viewport_height = viewport_height
        self.vertical_fov = _F32(vertical_fov)
        self.pitch = q.quat_identity()
        self.yaw = q.quat_identity()

        right = q.normalize(np.cross(_WORLD_UP, _FORWARD))
        up = q.normalize(np.cross(_FORWARD, right))
        horizontal = right * viewport_width
        vertical = up * viewport_height
        origin = np.asarray(config.origin, dtype=_F32)
        lower_left = origin - horizontal * _F32(0.5) - vertical * _F32(0.5) - _FORWARD

        self.d_camera = CameraDevice(
            image_width=int(image_width),
            image_height=int(image_height),
            horizontal=horizontal,
            vertical=vertical,
            lower_left_corner=lower_left,
            origin=origin,
            samples_per_pixel=int(config.samples_per_pixel),
            # +1 so that max_bounce == 0 means primary rays only (Camera.zig:74)
            max_bounce=int(config.max_bounce) + 1,
        )

    # -- speed ---------------------------------------------------------------

    # -- input gating (used by the benchmark, Camera.zig:94-100) --------------

    # -- movement --------------------------------------------------------------

    # -- basis -----------------------------------------------------------------
    def orientation(self) -> np.ndarray:
        return q.quat_norm(q.quat_mul(self.yaw, self.pitch))

    def forward_dir(self) -> np.ndarray:
        return q.quat_rotate_vec(self.orientation(), _FORWARD)

    def propagate_pitch_change(self) -> None:
        """Recompute the device basis after orientation/origin change
        (Camera.zig:167-175)."""
        forward = self.forward_dir()
        right = q.normalize(np.cross(_WORLD_UP, forward))
        up = q.normalize(np.cross(forward, right))
        self.d_camera.horizontal = right * self.viewport_width
        self.d_camera.vertical = up * self.viewport_height
        self.d_camera.lower_left_corner = (
            self.d_camera.origin
            - self.d_camera.horizontal * _F32(0.5)
            - self.d_camera.vertical * _F32(0.5)
            - forward
        )
