"""Nested configuration dataclasses.

Mirrors the reference's nested `Config` struct tree with identical fields and
defaults: VoxelRT.Config (reference VoxelRT.zig:22-28), Camera.Config
(Camera.zig:5-14), Sun.Config (Sun.zig:4-11), the denoiser push constants
(GraphicsPipeline.zig:27-39), BrickGrid.Config (brick/Grid.zig:13-20).

Field names and defaults equal those of `zig_vulkan_tpu.config`, so a
configuration reads the same in both packages. `TraceConfig` keeps only the
fields that mean something to the CUDA traversal.
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


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Traversal knobs with no reference analog.

    `max_steps` bounds the two-level DDA per ray: one step is one iteration
    of the traversal loop (a grid-level action plus up to four brick-level
    voxel steps), counted exactly as `zig_vulkan_tpu.ops.trace._grid_hit_soa`
    counts its while-loop iterations. A ray that exhausts it is a miss.
    `empty_skip` selects the Chebyshev distance-field leap over empty
    cells; False runs the exact cell-by-cell DDA
    (`zig_vulkan_tpu.ops.trace.grid_hit(use_skip=False)`, kernel A's
    `NO_SKIP` builds), which gives the numpy oracle's hits.

    `sun_in_kernel` traces each bounce level's sun-shadow ray inside the
    same kernel A launch (the shadow build: one thread traces its own sun
    ray, as brick_raytracer.comp:240-249 does) instead of a second launch;
    None (the default) and False keep the separate launch. The two give
    the same image.

    `degraded_nonempty_fraction`: the scene counts as degraded (empty-space
    roaming collapsed, the BASELINE config-3 regime) when more than this
    fraction of 4x16x16-cell regions holds a loaded cell. Only the engine's
    report reads it: a one-thread-per-ray kernel has no region serve to
    switch.
    """

    max_steps: int = 768
    empty_skip: bool = True
    sun_in_kernel: Optional[bool] = None
    degraded_nonempty_fraction: float = 0.5


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Reference VoxelRT.Config (VoxelRT.zig:22-28) + Pipeline.Config knobs.

    `internal_resolution_*` decouples render resolution from output
    resolution exactly like the reference (main.zig:23, Pipeline.zig:103-127);
    the denoiser pass resamples internal -> output.

    `debug_validation` is the "Debug build with validation layers" analog
    (SURVEY.md §5.2): the engine validates the scene at init and checks
    every frame it returns for non-finite or out-of-range pixels
    (`utils.validation`).

    `cards` is the number of cards the frame's rows are split over: shard i
    goes on `cuda:i` (every shard on the CPU where the engine's device is
    the CPU), each card holding a replica of the scene
    (`parallel.mesh.ShardedStep`); 1 draws the whole frame on the engine's
    device.
    """

    internal_resolution_width: int = 1024
    internal_resolution_height: int = 576
    output_resolution_width: Optional[int] = None   # None = same as internal
    output_resolution_height: Optional[int] = None
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    sun: SunConfig = dataclasses.field(default_factory=SunConfig)
    denoiser: DenoiserConfig = dataclasses.field(default_factory=DenoiserConfig)
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    debug_validation: bool = False
    cards: int = 1


# Brick geometry constants (reference brick/State.zig:5-11; Vulkan
# specialization constants in the reference, Pipeline.zig:293-315).
BRICK_DIMENSION: int = 4
BRICK_BITS: int = BRICK_DIMENSION ** 3          # 64
BRICK_BYTES: int = BRICK_BITS // 8              # 8
BRICK_WORDS: int = BRICK_BYTES // 4             # 2
BRICK_VOXEL_SCALE: float = 1.0 / BRICK_DIMENSION  # Pipeline.zig:313
