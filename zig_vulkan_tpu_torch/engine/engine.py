"""VoxelRT — the engine facade on torch.

The torch counterpart of `zig_vulkan_tpu.engine.engine.VoxelRT` (the
reference's public renderer API, src/modules/VoxelRT.zig, with the
per-frame orchestration of voxel_rt/Pipeline.zig). A frame is eager torch
on one device:

    trace (ops.trace.render_rows: kernels A and B on CUDA)
      -> temporal running mean (when enabled)
      -> denoise + resample (ops.denoise)

The scene's per-cell traversal records are built once, on the first frame,
with the exact distance field, and cached. Voxel edits (`insert_voxels`,
`remove_voxels`) update the scene arrays on the device and bring the cached
records up to date in place, with the fast conservative field (the
reference's dirty-range uploads, VoxelRT.zig:107-172). With
`TraceConfig(empty_skip=False)` the frame runs the exact DDA and the records
carry no distance field. Host-side mutable state is the camera and sun (the
reference's push constants), the roamability mirror, the brick-count bound
and the metrics ring.

The profiling zones (`utils.profiling.zone`) carry the JAX engine's names:
draw, device_sync, render_step, build_tables, edit_insert,
refresh_tables_insert, edit_remove.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..core.camera import Camera
from ..core.grid import BrickGrid, apply_edits, grid_at, remove_edits
from ..core.materials import MAT_DIELECTRIC, MaterialTable
from ..core.sun import Sun
from ..ops import denoise as denoise_mod
from ..ops import trace as trace_mod
from ..ops.tile_tracer import REGION_CELLS, region_grid
from ..utils import profiling, validation
from .benchmark import Benchmark
from .metrics import FrameMetrics


class VoxelRT:
    """Engine facade (reference VoxelRT.zig:39-172).

    Example:
        scene = models.scenes.default_scene()
        rt = VoxelRT(scene.grid, scene.materials, EngineConfig(),
                     device="cuda")
        rt.camera.translate(dt, [0, 0, -1])
        rt.insert_voxels([[10, 40, 10]], [5])
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

        if config.debug_validation:
            validation.enable_debug_mode()
            validation.validate_scene(self.grid_static, grid.arrays)

        self._tables = None
        self._dist = None
        self._tables_skip = None  # the empty_skip the records were built for
        self._track_host_grid(grid)

        # temporal accumulation (BASELINE config 4): running mean of traced
        # frames while the camera and sun pose stay put, with fresh jitter
        # seeds per frame
        self.temporal_enabled = False
        self._accum = None
        self._accum_count = 0
        self._pose_key = None

    def _track_host_grid(self, grid: BrickGrid) -> None:
        # host-side bound on the active bricks: the edit path never reads
        # the device unless the bound says a batch could exhaust brick_alloc
        self._bricks_upper = int(grid.arrays.active_bricks)
        # host mirror of which regions hold a loaded cell (exact: removals
        # never unload a cell, so regions only ever turn non-empty)
        self._n_regions, self._nonempty_regions = _region_occupancy(
            self.grid_static, np.asarray(grid.arrays.statuses))

    def tables(self):
        """The scene's per-cell traversal records, built on first use with
        the exact distance field (ops.trace.build_trace_tables) and kept up
        to date by the edits. With `empty_skip=False` the distance lane is
        never read and no field is built (ops.trace.no_skip_field)."""
        skip = bool(self.trace_config.empty_skip)
        if self._tables_skip != skip:
            self._tables = None
            self._dist = None
        if self._tables is None:
            with profiling.zone("build_tables"):
                if self._dist is None:
                    self._dist = (trace_mod.distance_field(
                        self.grid_static, self.arrays, exact=True) if skip
                        else trace_mod.no_skip_field(self.grid_static,
                                                     self.arrays))
                self._tables = trace_mod.build_trace_tables(
                    self.grid_static, self.arrays, self._dist)
            self._tables_skip = skip
        return self._tables

    def render(self):
        """Render one frame; returns the device image f32[out_h, out_w, 3].
        In debug mode (`utils.validation.enable_debug_mode`) a frame with
        non-finite or out-of-range pixels raises SceneValidationError."""
        tables = self.tables()
        with profiling.zone("render_step"):
            image = self._render(tables)
        if validation.debug_mode_enabled():
            validation.check_image(image)
        return image

    def _render(self, tables):
        iw, ih = self.internal_resolution
        ow, oh = self.output_resolution
        d = self.camera.d_camera
        sun = self.sun.device_data
        spp = int(d.samples_per_pixel)
        if self.temporal_enabled:
            pose = (tuple(np.asarray(d.origin).tolist()),
                    tuple(np.asarray(d.lower_left_corner).tolist()),
                    tuple(np.asarray(sun.position).tolist()))
            if (pose != self._pose_key or self._accum is None
                    or tuple(self._accum.shape) != (ih, iw, 3)):
                self._accum = torch.zeros((ih, iw, 3), dtype=torch.float32,
                                          device=self.device)
                self._accum_count = 0
            self._pose_key = pose
        sample_base = self._accum_count * spp if self.temporal_enabled else 0
        img = trace_mod.render_rows(
            self.grid_static, tables, self.arrays.material_indices,
            self.mats, trace_mod.camera_vectors(d, self.device), iw, ih,
            spp, int(d.max_bounce), sun.position, sun.color, sun.radius,
            bool(sun.enabled), max_steps=int(self.trace_config.max_steps),
            sample_base=sample_base,
            shadow_probe=bool(self.trace_config.sun_in_kernel),
            use_skip=bool(self.trace_config.empty_skip))
        if self.temporal_enabled:
            self._accum = self._accum + trace_mod._div(
                img - self._accum, self._accum_count + 1)
            self._accum_count += 1
            img = self._accum
        return denoise_mod.postprocess(img, self.denoiser, oh, ow)

    def draw(self, dt: float | None = None):
        """Render + record frame metrics (Pipeline.draw analog). Waits for
        the device so the recorded frame time is the frame's."""
        t0 = time.perf_counter()
        with profiling.zone("draw"):
            image = self.render()
            with profiling.zone("device_sync"):
                self._sync()
        elapsed = time.perf_counter() - t0
        self.metrics.record(dt if dt is not None else elapsed)
        return image

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- dynamic state (reference VoxelRT update methods) ------------------------

    def update_sun(self, dt: float) -> None:
        """Advance the sun animation (VoxelRT.zig:80-83)."""
        self.sun.update(dt)

    def flush_grid(self, grid: BrickGrid) -> None:
        """Full scene re-upload from a host BrickGrid (the reference's
        debugFlushGrid, VoxelRT.zig:95-104); the records are rebuilt with
        the exact field on the next frame."""
        if grid.static != self.grid_static:
            raise ValueError("flush_grid: the grid's geometry must match")
        self.arrays = grid.arrays.to_device(self.device)
        self._track_host_grid(grid)
        self._tables = None
        self._dist = None

    def push_materials(self, materials: MaterialTable) -> None:
        """Replace the material table (VoxelRT.zig:85-88)."""
        self.materials_host = materials
        self.mats = trace_mod.materials_to_device(materials, self.device)

    def push_albedo(self, index: int, albedo) -> None:
        """Update one material's albedo (VoxelRT.zig:90-92 pushAlbedo)."""
        self.materials_host.albedo[index] = np.asarray(albedo, dtype=np.float32)
        self.mats = trace_mod.materials_to_device(self.materials_host,
                                                  self.device)

    def set_temporal(self, enabled: bool) -> None:
        """Toggle temporal accumulation (BASELINE config 4)."""
        self.temporal_enabled = bool(enabled)
        self._accum = None
        self._accum_count = 0

    def set_denoiser(self, **knobs) -> None:
        """Tune denoiser push constants (Pipeline.zig:543-557 setters)."""
        self.denoiser = dataclasses.replace(self.denoiser, **knobs)

    def set_resolutions(self, internal: Optional[Tuple[int, int]] = None,
                        output: Optional[Tuple[int, int]] = None) -> None:
        """Rescale (the swapchain-rebuild analog, Pipeline.zig:657-710);
        the camera keeps its pose."""
        if internal is not None:
            iw, ih = internal
            self.internal_resolution = (int(iw), int(ih))
            old = self.camera
            self.camera = Camera(self.VFOV_DEGREES, iw, ih, self.config.camera)
            self.camera.yaw = old.yaw
            self.camera.pitch = old.pitch
            self.camera.d_camera.origin = old.d_camera.origin
            self.camera.d_camera.samples_per_pixel = old.d_camera.samples_per_pixel
            self.camera.d_camera.max_bounce = old.d_camera.max_bounce
            self.camera.propagate_pitch_change()
            self.metrics.rays_per_frame = (
                int(iw) * int(ih) * int(self.camera.d_camera.samples_per_pixel))
        if output is not None:
            self.output_resolution = (int(output[0]), int(output[1]))

    # -- voxel edits (reference C4 call stack) -----------------------------------

    def _cells_of(self, xyz: np.ndarray) -> np.ndarray:
        """Grid cell ids (Y-flipped, Grid.zig:135/:206-211) for a batch."""
        st = self.grid_static
        fy = (st.voxel_dims[1] - 1) - xyz[:, 1]
        return grid_at(st, xyz[:, 0], fy, xyz[:, 2]).astype(np.int32)

    def _edit_batch(self, xyz) -> np.ndarray:
        xyz = np.atleast_2d(np.asarray(xyz, dtype=np.int32))
        if xyz.shape[1] != 3:
            raise ValueError("voxel coordinates must be [N, 3]")
        if xyz.size and ((xyz < 0).any()
                         or (xyz >= np.asarray(self.grid_static.voxel_dims)).any()):
            raise IndexError("voxel out of grid bounds")
        return xyz

    def insert_voxels(self, xyz, material_index) -> None:
        """Insert voxels on the device (the updateGridDelta analog,
        VoxelRT.zig:107-172): `core.grid.apply_edits`, then the cached
        records' refresh (`ops.trace.refresh_tables_after_insert`).

        Raises MemoryError, before touching the scene, if the batch could
        exhaust `brick_alloc`. The check is a host-side bound (each distinct
        touched cell may need one new brick); only when the bound trips is
        the device read for the exact count."""
        xyz = self._edit_batch(xyz)
        mats = np.asarray(material_index, dtype=np.uint8).ravel()
        if mats.shape[0] != xyz.shape[0]:
            raise ValueError("one material index per voxel")
        st = self.grid_static
        cells = self._cells_of(xyz)
        uniq_cells = np.unique(cells)
        if self._bricks_upper + uniq_cells.size > st.brick_alloc:
            statuses = self.arrays.statuses.cpu().numpy().view(np.uint32)
            loaded = (statuses[uniq_cells // 32]
                      >> (uniq_cells % 32).astype(np.uint32)) & 1
            actually_new = int((loaded == 0).sum())
            active = int(self.arrays.active_bricks)
            if active + actually_new > st.brick_alloc:
                raise MemoryError(
                    f"brick allocation exhausted: {active} active "
                    f"+ {actually_new} new > brick_alloc={st.brick_alloc}")
            self._bricks_upper = active + actually_new
        else:
            self._bricks_upper += uniq_cells.size
        # roamability bookkeeping after the capacity guard: a rejected
        # batch marks no region
        self._nonempty_regions.update(
            _regions_of_cells(st, uniq_cells).tolist())
        dev = self.device
        valid = torch.ones(xyz.shape[0], dtype=torch.bool, device=dev)
        table = self.materials_host
        with profiling.zone("edit_insert"):
            self.arrays = apply_edits(
                st, self.arrays, torch.from_numpy(xyz).to(dev),
                torch.from_numpy(mats).to(dev), valid,
                torch.from_numpy(np.asarray(table.mtype)
                                 == MAT_DIELECTRIC).to(dev),
                torch.from_numpy(np.asarray(table.type_data,
                                            dtype=np.float32)).to(dev))
        if self._tables is not None:
            with profiling.zone("refresh_tables_insert"):
                self._tables, self._dist = (
                    trace_mod.refresh_tables_after_insert(
                        st, self.arrays, self._tables,
                        torch.from_numpy(cells).to(dev), valid,
                        use_skip=self._tables_skip))

    def remove_voxels(self, xyz) -> None:
        """Remove voxels on the device (BASELINE config 3):
        `core.grid.remove_edits`, then the touched records' refresh with
        the cached skip field (bricks are never freed)."""
        xyz = self._edit_batch(xyz)
        dev = self.device
        valid = torch.ones(xyz.shape[0], dtype=torch.bool, device=dev)
        with profiling.zone("edit_remove"):
            self.arrays = remove_edits(self.grid_static, self.arrays,
                                       torch.from_numpy(xyz).to(dev), valid)
        if self._tables is not None:
            self._tables = trace_mod.refresh_tables_after_remove(
                self.grid_static, self.arrays, self._tables, self._dist,
                torch.from_numpy(self._cells_of(xyz)).to(dev), valid)

    def nonempty_region_fraction(self) -> float:
        """The share of 4x16x16-cell regions that hold a loaded cell: the
        direct measure of how far empty-space roaming has collapsed."""
        return len(self._nonempty_regions) / max(1, self._n_regions)

    def _scene_degraded(self) -> bool:
        """True when more than `degraded_nonempty_fraction` of the regions
        hold a loaded cell (the BASELINE config-3 regime: random sprays
        mark most regions). The JAX package switches its region serve on
        it; here only the reports read it."""
        return (self.nonempty_region_fraction()
                > float(self.trace_config.degraded_nonempty_fraction))

    # -- benchmark (reference VoxelRT.createBenchmark, VoxelRT.zig:72-74) --------

    def create_benchmark(self, duration: float = 60.0) -> Benchmark:
        return Benchmark(self.camera, self.grid_static,
                         bool(self.sun.device_data.enabled), duration=duration)

    def run_benchmark(self, duration: float = 60.0,
                      max_frames: Optional[int] = None,
                      verbose: bool = True,
                      fixed_dt: Optional[float] = None) -> Benchmark:
        """Run the fly-through to completion (ImguiGui.zig:154-163 loop).

        `fixed_dt` advances the path by a fixed virtual dt per frame
        instead of wall time, so the whole path is covered in
        duration/fixed_dt frames on any hardware; the report still records
        the measured frame times and says how many frames back them."""
        bench = self.create_benchmark(duration)
        self.render()  # warm-up frame outside the timing
        self._sync()
        frames = 0
        prev = time.perf_counter()
        done = False
        while not done and (max_frames is None or frames < max_frames):
            now = time.perf_counter()
            dt = now - prev
            prev = now
            path_dt = fixed_dt if fixed_dt is not None else dt
            self.update_sun(path_dt)
            self.draw(dt)
            # frame 0's dt is the time since `prev` was set, not a frame:
            # advance the path but record no sample
            done = bench.update(path_dt if frames > 0 else 1e-3,
                                record_dt=dt if frames > 0 else -1.0)
            frames += 1
        self.camera.reset()
        if verbose:
            bench.print_report(device_name(self.device))
        return bench

    # -- scene save/load (superset feature; SURVEY.md §5.4) ----------------------

    def save_scene(self, path: str) -> None:
        """Write the scene as it stands on the device, with the material
        table, in the JAX package's .npz format (io.scene_io)."""
        from ..io.scene_io import save_scene

        save_scene(path, self.grid_static, self.arrays, self.materials_host)

    def device_image_to_host(self, image) -> np.ndarray:
        return image.cpu().numpy()


def device_name(device) -> str:
    """The name the benchmark report prints for `device`."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (cuda)"
    return f"{device.type} ({device.type})"


def _region_occupancy(static, statuses: np.ndarray):
    """(n_regions, set of region ids holding a loaded cell) from host
    status bits (zig_vulkan_tpu/engine/engine.py:615-628)."""
    ry, rz, rx = REGION_CELLS
    ny, nz, nx = region_grid(static)
    cells = static.dim_x * static.dim_y * static.dim_z
    bits = np.unpackbits(statuses.view(np.uint8), bitorder="little")[:cells]
    vol = np.zeros((ny * ry, nz * rz, nx * rx), dtype=bool)
    vol[:static.dim_y, :static.dim_z, :static.dim_x] = (
        bits.reshape(static.dim_y, static.dim_z, static.dim_x))
    nonempty = vol.reshape(ny, ry, nz, rz, nx, rx).any(axis=(1, 3, 5))
    return ny * nz * nx, set(np.flatnonzero(nonempty.reshape(-1)).tolist())


def _regions_of_cells(static, cells: np.ndarray) -> np.ndarray:
    """Region ids (x fastest) of grid cell ids."""
    ry, rz, rx = REGION_CELLS
    ny, nz, nx = region_grid(static)
    cy = cells // (static.dim_x * static.dim_z)
    cz = (cells // static.dim_x) % static.dim_z
    cx = cells % static.dim_x
    return ((cx // rx) + nx * ((cz // rz) + nz * (cy // ry))).astype(np.int64)
