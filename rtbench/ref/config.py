"""Nested configuration dataclasses.

Frozen copy of `zig_vulkan_tpu_torch/config.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

Keeps the groups the reference builds: Camera.Config (Camera.zig:5-14),
Sun.Config (Sun.zig:4-11), the denoiser push constants
(GraphicsPipeline.zig:27-39) and BrickGrid.Config (brick/Grid.zig:13-20),
with the fields and defaults of `zig_vulkan_tpu.config`, and the brick
geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Reference Camera.Config (Camera.zig:5-14)."""

    viewport_height: float = 2.0
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    samples_per_pixel: int = 2
    max_bounce: int = 2
    turn_rate: float = 0.1
    normal_speed: float = 1.0
    sprint_speed: float = 2.0
    user_input_disabled: bool = False


@dataclasses.dataclass(frozen=True)
class SunConfig:
    """Reference Sun.Config (Sun.zig:4-11)."""

    animate: bool = True
    animate_speed: float = 0.1
    enabled: bool = True
    color: Tuple[float, float, float] = (1.0, 1.1, 1.0)
    radius: float = 5.0
    sun_distance: float = 1000.0


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """Reference GraphicsPipeline.PushConstant defaults (GraphicsPipeline.zig:27-39)."""

    samples: int = 20
    distribution_bias: float = 0.6
    pixel_multiplier: float = 1.5
    inverse_hue_tolerance: float = 20.0
    enabled: bool = True


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Reference BrickGrid.Config (brick/Grid.zig:13-20).

    `workers_count` is kept for API parity: the vectorized numpy builder
    does not use it; it sets the threads of the native C++ builder
    (`io.native_builder.NativeGridBuilder`).
    """

    brick_alloc: Optional[int] = None
    base_t: float = 0.01
    min_point: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: float = 1.0
    workers_count: int = 4


# Brick geometry constants (reference brick/State.zig:5-11; Vulkan
# specialization constants in the reference, Pipeline.zig:293-315).
BRICK_DIMENSION: int = 4
BRICK_BITS: int = BRICK_DIMENSION ** 3          # 64
BRICK_BYTES: int = BRICK_BITS // 8              # 8
BRICK_WORDS: int = BRICK_BYTES // 4             # 2
