"""VoxelRT — the engine facade on torch.

The torch counterpart of `zig_vulkan_tpu.engine.engine.VoxelRT` (the
reference's public renderer API, src/modules/VoxelRT.zig, with the
per-frame orchestration of voxel_rt/Pipeline.zig). A frame is eager torch
on one device:

    trace (ops.trace.render_rows: kernels A and B on CUDA)
      -> denoise + resample (ops.denoise)

The scene's per-cell traversal records are built once, on the first frame,
with the exact distance field, and cached. Host-side mutable state is the
camera and sun (the reference's push constants) plus the metrics ring.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..config import EngineConfig
from ..core.camera import Camera
from ..core.grid import BrickGrid
from ..core.materials import MaterialTable
from ..core.sun import Sun
from ..ops import denoise as denoise_mod
from ..ops import trace as trace_mod
from .metrics import FrameMetrics


class VoxelRT:
    """Engine facade (reference VoxelRT.zig:39-172).

    Example:
        scene = models.scenes.default_scene()
        rt = VoxelRT(scene.grid, scene.materials, EngineConfig(),
                     device="cuda")
        rt.camera.translate(dt, [0, 0, -1])
        image = rt.draw(dt)           # f32[out_h, out_w, 3] on the device
    """

    VFOV_DEGREES = 75.0  # reference VoxelRT.init camera vfov

    def __init__(self, grid: BrickGrid, materials: MaterialTable,
                 config: EngineConfig, device):
        self.device = torch.device(device)
        self.config = config
        self.grid_static = grid.static
        self.arrays = grid.arrays.to_device(self.device)
        self.materials_host = materials
        self.mats = trace_mod.materials_to_device(materials, self.device)

        iw = int(config.internal_resolution_width)
        ih = int(config.internal_resolution_height)
        self.internal_resolution = (iw, ih)
        ow = int(config.output_resolution_width or iw)
        oh = int(config.output_resolution_height or ih)
        self.output_resolution = (ow, oh)

        self.camera = Camera(self.VFOV_DEGREES, iw, ih, config.camera)
        self.sun = Sun(config.sun)
        self.denoiser = config.denoiser
        self.trace_config = config.trace

        self.metrics = FrameMetrics()
        self.metrics.rays_per_frame = iw * ih * int(config.camera.samples_per_pixel)
        self._tables = None

    def tables(self):
        """The scene's per-cell traversal records, built on first use with
        the exact distance field (ops.trace.build_trace_tables)."""
        if self._tables is None:
            dist = trace_mod.distance_field(self.grid_static, self.arrays,
                                            exact=True)
            self._tables = trace_mod.build_trace_tables(
                self.grid_static, self.arrays, dist)
        return self._tables

    def render(self):
        """Render one frame; returns the device image f32[out_h, out_w, 3]."""
        iw, ih = self.internal_resolution
        ow, oh = self.output_resolution
        d = self.camera.d_camera
        sun = self.sun.device_data
        img = trace_mod.render_rows(
            self.grid_static, self.tables(), self.arrays.material_indices,
            self.mats, trace_mod.camera_vectors(d, self.device), iw, ih,
            int(d.samples_per_pixel), int(d.max_bounce),
            sun.position, sun.color, sun.radius, bool(sun.enabled),
            max_steps=int(self.trace_config.max_steps))
        return denoise_mod.postprocess(img, self.denoiser, oh, ow)

    def draw(self, dt: float | None = None):
        """Render + record frame metrics (Pipeline.draw analog). Waits for
        the device so the recorded frame time is the frame's."""
        t0 = time.perf_counter()
        image = self.render()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.metrics.record(dt if dt is not None else elapsed)
        return image

    # -- dynamic state (reference VoxelRT update methods) ------------------------

    def update_sun(self, dt: float) -> None:
        """Advance the sun animation (VoxelRT.zig:80-83)."""
        self.sun.update(dt)

    def set_denoiser(self, **knobs) -> None:
        """Tune denoiser push constants (Pipeline.zig:543-557 setters)."""
        self.denoiser = dataclasses.replace(self.denoiser, **knobs)
