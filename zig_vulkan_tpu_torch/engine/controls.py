"""Headless control panel / HUD.

Re-implements the reference's ImGui control surface (reference:
src/modules/voxel_rt/ImguiGui.zig) as a programmatic + terminal API: every
tunable the GUI exposes is available with the same ranges and effects —

- Camera window: max_bounce slider 1..32, samples_per_pixel 1..32, movement
  speed, origin (ImguiGui.zig:176-209);
- Metrics window: device name + the 128-frame rolling frame-time plot with
  min/max (ImguiGui.zig:211-246), rendered as a sparkline;
- "Start benchmark" button + per-frame benchmark drive with the sun reset
  for determinism (ImguiGui.zig:248-272, :154-163);
- Post-process window: the four denoiser knobs (ImguiGui.zig:275-306);
- Sun window: enabled/position/color/radius/animation (ImguiGui.zig:308-347).

Instead of ImGui's raw-pointer StateBinding (ImguiGui.zig:16-22), the panel
holds the engine and mutates its host state directly. A copy of
`zig_vulkan_tpu.engine.controls`; the device name is the engine's card's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .benchmark import Benchmark
from .engine import VoxelRT, device_name

_SPARK = " .:-=+*#%@"


class ControlPanel:
    """Programmatic equivalent of the ImGui windows."""

    MAX_BOUNCE_RANGE = (1, 32)   # ImguiGui.zig:190
    SPP_RANGE = (1, 32)          # ImguiGui.zig:197

    def __init__(self, engine: VoxelRT):
        self.engine = engine
        self.active_benchmark: Optional[Benchmark] = None

    # -- camera window (ImguiGui.zig:176-209) ----------------------------------
    def set_max_bounce(self, user_bounces: int) -> None:
        lo, hi = self.MAX_BOUNCE_RANGE
        # the GUI slider edits the device value directly (user value + 1)
        self.engine.camera.d_camera.max_bounce = int(np.clip(user_bounces, lo, hi))

    def set_samples_per_pixel(self, spp: int) -> None:
        lo, hi = self.SPP_RANGE
        self.engine.camera.d_camera.samples_per_pixel = int(np.clip(spp, lo, hi))
        iw, ih = self.engine.internal_resolution
        self.engine.metrics.rays_per_frame = iw * ih * int(np.clip(spp, lo, hi))

    def set_movement_speed(self, speed: float) -> None:
        self.engine.camera.normal_speed = np.float32(speed)
        self.engine.camera.movement_speed = np.float32(speed)

    def set_camera_origin(self, origin) -> None:
        self.engine.camera.set_origin(origin)

    # -- post-process window (ImguiGui.zig:275-306) ------------------------------
    def set_denoiser(self, **knobs) -> None:
        self.engine.set_denoiser(**knobs)

    # -- sun window (ImguiGui.zig:308-347) ----------------------------------------
    def set_sun_enabled(self, enabled: bool) -> None:
        self.engine.sun.device_data.enabled = bool(enabled)

    def set_sun_position(self, position) -> None:
        self.engine.sun.device_data.position = np.asarray(position, np.float32)

    def set_sun_color(self, color) -> None:
        self.engine.sun.device_data.color = np.asarray(color, np.float32)

    def set_sun_radius(self, radius: float) -> None:
        self.engine.sun.device_data.radius = np.float32(radius)

    def set_sun_animate(self, animate: bool, speed: Optional[float] = None) -> None:
        self.engine.sun.animate = bool(animate)
        if speed is not None:
            self.engine.sun.animate_speed = np.float32(speed)

    # -- benchmark (ImguiGui.zig:248-272) ------------------------------------------
    def start_benchmark(self, duration: float = 60.0) -> Benchmark:
        """The "Start benchmark" button: resets the sun for determinism
        (ImguiGui.zig:257-259) and takes over the camera."""
        sun = self.engine.sun
        sun.slerp_index = 0
        sun.slerp_pos = np.float32(0.0)
        self.active_benchmark = self.engine.create_benchmark(duration)
        return self.active_benchmark

    def new_frame(self, dt: float) -> None:
        """Per-frame panel logic (ImguiGui.newFrame, ImguiGui.zig:93-174):
        drives an active benchmark and prints its report on completion."""
        if self.active_benchmark is not None:
            if self.active_benchmark.update(dt):
                self.engine.camera.reset()
                self.active_benchmark.print_report(
                    device_name(self.engine.device))
                self.active_benchmark = None

    # -- metrics window (ImguiGui.zig:211-246) ---------------------------------
    def metrics_text(self) -> str:
        m = self.engine.metrics
        times = m.frame_times or [0.0]
        lo = min(times)
        hi = max(times)
        span = (hi - lo) or 1.0
        spark = "".join(
            _SPARK[int((t - lo) / span * (len(_SPARK) - 1))] for t in times[-64:])
        s = m.summary()
        d = self.engine.camera.d_camera
        return "\n".join([
            f"device: {device_name(self.engine.device)}",
            f"frame ms  min {s['min_ms']:.3f}  max {s['max_ms']:.3f}  "
            f"avg {s['avg_ms']:.3f}  fps {s['fps']:.1f}",
            f"rays/s: {s['mrays_per_s']:.1f}M   resolution: "
            f"{d.image_width}x{d.image_height}  spp {d.samples_per_pixel}  "
            f"bounce {d.max_bounce}",
            f"[{spark}]",
        ])
