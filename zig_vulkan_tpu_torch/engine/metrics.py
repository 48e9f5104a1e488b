"""Frame metrics and observability.

Re-implements the reference's GUI-based telemetry (SURVEY.md §5.5): the
128-frame rolling frame-time window with tracked min/max that ImguiGui plots
via ImPlot (reference ImguiGui.zig:32-37, :143-152, :226-246), re-packaged
as a headless metrics object the host loop can print, log, or export. Adds
ray-throughput derived metrics (Mrays/s).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

ROLLING_WINDOW = 128  # frames (ImguiGui.zig:33)


@dataclasses.dataclass
class FrameMetrics:
    """Rolling frame telemetry (the ImGui metrics window, headless)."""

    window: int = ROLLING_WINDOW
    frame_times: List[float] = dataclasses.field(default_factory=list)
    min_frame_time: float = float("inf")
    max_frame_time: float = 0.0
    frame_count: int = 0
    rays_per_frame: int = 0

    def record(self, dt_seconds: float) -> None:
        self.frame_count += 1
        self.min_frame_time = min(self.min_frame_time, dt_seconds)
        self.max_frame_time = max(self.max_frame_time, dt_seconds)
        self.frame_times.append(dt_seconds)
        if len(self.frame_times) > self.window:
            self.frame_times.pop(0)

    @property
    def avg_frame_time(self) -> float:
        if not self.frame_times:
            return 0.0
        return float(np.mean(self.frame_times))

    @property
    def fps(self) -> float:
        avg = self.avg_frame_time
        return 1.0 / avg if avg > 0 else 0.0

    @property
    def mrays_per_second(self) -> float:
        """Primary-ray throughput over the rolling window."""
        avg = self.avg_frame_time
        if avg <= 0 or self.rays_per_frame <= 0:
            return 0.0
        return self.rays_per_frame / avg / 1e6

    def summary(self) -> dict:
        return {
            "frames": self.frame_count,
            "min_ms": self.min_frame_time * 1e3 if self.frame_times else 0.0,
            "max_ms": self.max_frame_time * 1e3,
            "avg_ms": self.avg_frame_time * 1e3,
            "fps": self.fps,
            "mrays_per_s": self.mrays_per_second,
        }
