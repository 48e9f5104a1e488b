"""Ray-tracing camera.

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

The camera basis runs on the host: each pose as one native routine
(`core.pose_host`, csrc/pose_host.cpp, about 150 float32 flops in one ctypes
call), whose plain twin is the numpy body
(`Camera.propagate_pitch_change_plain`), equal to it bit for bit. Only
`CameraDevice` crosses to the device, as the frame's push constants.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import CameraConfig
from ..utils import profiling, quat as q
from . import pose_host

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
        self._pose = pose_host.Pose()

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
    def activate_sprint(self) -> None:
        self.movement_speed = self.normal_speed * self.sprint_speed

    def disable_sprint(self) -> None:
        self.movement_speed = self.normal_speed

    # -- input gating (used by the benchmark, Camera.zig:94-100) --------------
    def disable_input(self) -> None:
        self.user_input_disabled = True

    def enable_input(self) -> None:
        self.user_input_disabled = False

    def reset(self) -> None:
        """Reset orientation after programmatic use (Camera.zig:104-109)."""
        self.enable_input()
        self.yaw = q.quat_identity()
        self.pitch = q.quat_identity()
        self.propagate_pitch_change()

    # -- movement --------------------------------------------------------------
    def set_origin(self, origin) -> None:
        self.d_camera.origin = np.asarray(origin, dtype=_F32)
        self.propagate_pitch_change()

    def translate(self, delta_time: float, by) -> None:
        """Move along the camera basis (Camera.zig:112-122)."""
        if self.user_input_disabled:
            return
        by = np.asarray(by, dtype=_F32)
        # NaN for the zero vector, matching zalgebra .norm() — silenced so
        # the intentional divide doesn't mask real NaN bugs in debug mode
        with np.errstate(invalid="ignore", divide="ignore"):
            norm = by / np.sqrt(np.sum(by * by))
        delta = q.quat_rotate_vec(self.orientation(), norm * (_F32(delta_time) * self.movement_speed))
        if np.isnan(delta[0]):
            return
        self.d_camera.origin = self.d_camera.origin + delta
        self.propagate_pitch_change()

    def turn_pitch(self, angle: float) -> None:
        """Pitch with +-90 degree clamp (Camera.zig:124-141)."""
        if self.user_input_disabled:
            return
        h_angle = _F32(angle) * self.turn_rate
        rot = np.array([np.cos(h_angle), np.sin(h_angle), 0.0, 0.0], dtype=_F32)
        prev_pitch = self.pitch
        self.pitch = q.quat_mul(self.pitch, rot)
        if abs(q.quat_extract_euler_x(self.pitch)) >= 90.0:
            self.pitch = prev_pitch
        self.propagate_pitch_change()

    def turn_yaw(self, angle: float) -> None:
        """Yaw (Camera.zig:143-151)."""
        if self.user_input_disabled:
            return
        h_angle = _F32(angle) * self.turn_rate
        rot = np.array([np.cos(h_angle), 0.0, np.sin(h_angle), 0.0], dtype=_F32)
        self.yaw = q.quat_mul(self.yaw, rot)
        self.propagate_pitch_change()

    # -- basis -----------------------------------------------------------------
    def orientation(self) -> np.ndarray:
        return q.quat_norm(q.quat_mul(self.yaw, self.pitch))

    def forward_dir(self) -> np.ndarray:
        return q.quat_rotate_vec(self.orientation(), _FORWARD)

    def propagate_pitch_change(self) -> None:
        """Recompute the device basis after orientation/origin change
        (Camera.zig:167-175): the profiling zone `pose`. The native routine
        (`core.pose_host`) takes the pose where it is loaded and yaw, pitch
        and origin are float32, each such pose counted under `pose_native`;
        `propagate_pitch_change_plain` takes any other, bit for bit the
        same where both can."""
        with profiling.zone("pose"):
            d = self.d_camera
            basis = self._pose(self.yaw, self.pitch, d.origin,
                               self.viewport_width, self.viewport_height)
            if basis is None:
                profiling.count("pose_native", 0)
                self.propagate_pitch_change_plain()
            else:
                profiling.count("pose_native")
                d.horizontal = basis[0:3]
                d.vertical = basis[3:6]
                d.lower_left_corner = basis[6:9]

    def propagate_pitch_change_plain(self) -> None:
        """The basis update in numpy: the native routine's plain twin."""
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
