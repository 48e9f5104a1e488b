"""VoxelRT — the engine facade on torch.

The torch counterpart of `zig_vulkan_tpu.engine.engine.VoxelRT` (the
reference's public renderer API, src/modules/VoxelRT.zig, with the
per-frame orchestration of voxel_rt/Pipeline.zig). A frame is one compiled
step on one device, as the JAX engine's:

    trace (ops.trace.render_rows: kernels A and B on CUDA)
      -> temporal running mean (when enabled)
      -> denoise + resample (ops.denoise)

`_step_key()` holds the frame's static configuration, `_step_cache` the
current key's step (`_build_step`, `engine.step.Step`), and `_push_constants()`
packs every per-frame value (camera, sun, sample base, temporal count) into
one f32[24] array in the JAX engine's layout: one host-to-device copy a
frame, so a new pose, a moving sun or a new count needs no new step. On a
CUDA device a step is captured once as a CUDA graph and replayed every
frame after; on the CPU its body runs op by op. `render_op_by_op()` calls
the same body op by op on any device (for checks that hook the kernel
wrappers, which a replay does not call).

A graph bakes in the addresses of the scene's tensors. The edits write
into them in place, so a replay sees them; `flush_grid` and a rebuild of
the records (first frame, `empty_skip` flipped) drop every step and every
edit graph, and `push_materials` / `push_albedo` write into the material
table and its device-side dielectric classification in place.

The scene's per-cell traversal records are built once, on the first frame,
with the exact distance field, and cached. Voxel edits (`insert_voxels`,
`remove_voxels`) update the scene arrays on the device and bring the cached
records up to date in place, with the fast conservative field (the
reference's dirty-range uploads, VoxelRT.zig:107-172). As in the JAX
engine, a batch is padded to `_EDIT_PAD` lanes times a power of two, and
each padded size is an `engine.step.EditStep`: one pinned upload a batch
and, on a CUDA device, one graph for each (insert or remove, records or
none, their `empty_skip`) holding the edit and the refresh, captured once
and replayed (the edit body never waits for the card). The cache keeps
`_EDIT_SIZES` sizes, least recently used first out. `insert_voxels_op_by_op`
and `remove_voxels_op_by_op` call the same bodies op by op. With
`TraceConfig(empty_skip=False)` the frame runs the exact DDA and the records
carry no distance field. Host-side mutable state is the camera and sun (the
reference's push constants), the roamability mirror, the brick-count bound
and the metrics ring.

The profiling zones (`utils.profiling.zone`) carry the JAX engine's names:
draw, device_sync, render_step, build_tables, edit_insert (the edit and its
refresh, one graph), edit_remove.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DenoiserConfig, EngineConfig
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
from .step import (EditStep, GraphedCall, PushRing, Step, StepKey,
                   pack_frame, trace_from_pc)


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
        # the edits' material classification, written in place on a push
        is_diel, ir = _classification(materials)
        self._mat_is_diel = torch.from_numpy(is_diel).to(self.device)
        self._mat_ir = torch.from_numpy(ir).to(self.device)

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
        # seeds per frame; `_accum` is the last temporal step's accumulator
        self.temporal_enabled = False
        self._accum = None
        self._accum_count = 0
        self._pose_key = None

        self._step_cache = {}
        self._push = PushRing(self.device)
        self._edit_cache = collections.OrderedDict()  # padded size -> EditStep

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
            # the steps' and edits' graphs read the records they were
            # captured with
            self._step_cache.clear()
            self._edit_cache.clear()
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
        """Render one frame; returns the device image f32[out_h, out_w, 3],
        which later frames leave as it is. On a CUDA device the step of the
        current key is captured once and replayed. In debug mode
        (`utils.validation.enable_debug_mode`) a frame with non-finite or
        out-of-range pixels raises SceneValidationError."""
        return _checked(self._render(Step.__call__))

    def render_op_by_op(self):
        """The same frame as `render()`, through the same step's body called
        op by op on any device (no graph): each kernel launch goes through
        its wrapper. Advances the temporal count as `render()` does."""
        return _checked(self._render(Step.op_by_op))

    def step(self) -> Step:
        """The current key's step, built (not captured) on first use. The
        cache keeps the current key's step alone: a new key (a denoiser
        slider makes one a value) frees the old step, its graph and the
        graph's memory pool."""
        self.tables()
        key = self._step_key()
        step = self._step_cache.get(key)
        if step is None:
            self._step_cache.clear()
            step = self._step_cache[key] = self._build_step(key)
        return step

    def _render(self, run):
        """One frame of the current step through `run(step)`."""
        step = self.step()
        if step.accum is not None:
            d, sun = self.camera.d_camera, self.sun.device_data
            pose = (tuple(np.asarray(d.origin).tolist()),
                    tuple(np.asarray(d.lower_left_corner).tolist()),
                    tuple(np.asarray(sun.position).tolist()))
            # the running mean goes on into a new step of the same
            # resolution (a denoiser change), as the JAX engine's does
            carry = (self._accum is not None and pose == self._pose_key
                     and self._accum.shape == step.accum.shape)
            if self._accum is not step.accum:
                if carry:
                    step.accum.copy_(self._accum)
                self._accum = step.accum
            if not carry:
                step.accum.zero_()
                self._accum_count = 0
            self._pose_key = pose
        self._push.upload(self._push_constants(), step.pc)
        with profiling.zone("render_step"):
            image = run(step)
        if step.accum is not None:
            self._accum_count += 1
        return image

    def _step_key(self) -> StepKey:
        """The frame's static configuration (the JAX engine's `_step_key`
        less the fields not ported, plus the denoiser's runtime values; see
        `engine.step.StepKey`)."""
        iw, ih = self.internal_resolution
        ow, oh = self.output_resolution
        d = self.camera.d_camera
        dn, tc = self.denoiser, self.trace_config
        return StepKey(
            iw, ih, ow, oh, int(d.samples_per_pixel), int(d.max_bounce),
            bool(self.sun.device_data.enabled), bool(dn.enabled),
            float(dn.pixel_multiplier), int(tc.max_steps),
            bool(tc.empty_skip), bool(self.temporal_enabled),
            bool(tc.sun_in_kernel), int(dn.samples),
            float(dn.distribution_bias), float(dn.inverse_hue_tolerance))

    def _build_step(self, key: StepKey) -> Step:
        """The step of `key` over the scene's current tensors: camera rays
        from pc[0:12], the trace with the sun from pc[12:19] and the sample
        base from pc[21], the temporal mean through pc[22], then
        `denoise.postprocess` with the key's denoiser."""
        static = self.grid_static
        tables = self._tables
        material_indices = self.arrays.material_indices
        mats = self.mats
        denoiser = DenoiserConfig(
            samples=key.denoiser_samples,
            distribution_bias=key.distribution_bias,
            pixel_multiplier=key.pixel_multiplier,
            inverse_hue_tolerance=key.inverse_hue_tolerance,
            enabled=key.denoiser_enabled)

        def body(pc, accum):
            img = trace_from_pc(
                pc, static, tables, material_indices, mats,
                key.internal_width, key.internal_height,
                key.samples_per_pixel, key.max_bounce, key.sun_enabled,
                max_steps=key.max_steps, shadow_probe=key.sun_in_kernel,
                use_skip=key.empty_skip)
            if accum is not None:
                # running mean over pose-static frames, in place
                accum.add_(trace_mod._div(img - accum, pc[22] + 1.0))
                img = accum
            return denoise_mod.postprocess(img, denoiser, key.output_height,
                                           key.output_width)

        accum_shape = ((key.internal_height, key.internal_width, 3)
                       if key.temporal else None)
        return Step(key, body, self.device, accum_shape)

    def _push_constants(self) -> np.ndarray:
        """Per-frame values packed into one f32[24] array, the JAX engine's
        layout: camera origin, horizontal, vertical, lower-left corner
        (0-11), sun position (12-14), colour (15-17), radius (18), denoiser
        distribution bias (19) and inverse hue tolerance (20), sample base
        (21), temporal count (22), denoiser samples clipped to
        MAX_RUNTIME_SAMPLES (23). The port's step reads 0-18, 21 and 22;
        its key holds the denoiser's values."""
        d = self.camera.d_camera
        sun = self.sun.device_data
        spp = int(d.samples_per_pixel)
        pc = pack_frame(trace_mod.camera_basis(d), sun.position, sun.color,
                        sun.radius, self._accum_count * spp
                        if self.temporal_enabled else 0.0)
        pc[19] = np.float32(self.denoiser.distribution_bias)
        pc[20] = np.float32(self.denoiser.inverse_hue_tolerance)
        pc[22] = np.float32(self._accum_count)
        pc[23] = np.float32(min(int(self.denoiser.samples),
                                denoise_mod.MAX_RUNTIME_SAMPLES))
        return pc

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
        self._step_cache.clear()
        self._edit_cache.clear()

    def push_materials(self, materials: MaterialTable) -> None:
        """Replace the material table (VoxelRT.zig:85-88), written into the
        device table and the edits' dielectric classification in place: the
        steps and the edits keep their graphs."""
        self.materials_host = materials
        self.mats.copy_(trace_mod.materials_to_device(materials, self.device))
        is_diel, ir = _classification(materials)
        self._mat_is_diel.copy_(torch.from_numpy(is_diel))
        self._mat_ir.copy_(torch.from_numpy(ir))

    def push_albedo(self, index: int, albedo) -> None:
        """Update one material's albedo (VoxelRT.zig:90-92 pushAlbedo), in
        place as `push_materials`."""
        self.materials_host.albedo[index] = np.asarray(albedo, dtype=np.float32)
        self.push_materials(self.materials_host)

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

    _EDIT_PAD = 1024  # lanes of the smallest padded batch (the JAX engine's)
    _EDIT_SIZES = 4   # padded sizes whose buffers and graphs are kept

    def _cells_of(self, xyz: np.ndarray) -> np.ndarray:
        """Grid cell ids (Y-flipped, Grid.zig:135/:206-211) for a batch."""
        st = self.grid_static
        fy = (st.voxel_dims[1] - 1) - xyz[:, 1]
        return grid_at(st, xyz[:, 0], fy, xyz[:, 2]).astype(np.int32)

    def _padded(self, n: int) -> int:
        """The batch's padded size: `_EDIT_PAD` times a power of two."""
        size = self._EDIT_PAD
        while size < n:
            size *= 2
        return size

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
        records' refresh (`ops.trace.refresh_tables_after_insert`), one
        replayed graph on a CUDA device.

        Raises MemoryError, before touching the scene, if the batch could
        exhaust `brick_alloc`. The check is a host-side bound (each distinct
        touched cell may need one new brick); only when the bound trips is
        the device read for the exact count."""
        self._insert(xyz, material_index, GraphedCall.__call__)

    def insert_voxels_op_by_op(self, xyz, material_index) -> None:
        """`insert_voxels` through the same body called op by op (no graph)."""
        self._insert(xyz, material_index, _call_body)

    def remove_voxels(self, xyz) -> None:
        """Remove voxels on the device (BASELINE config 3):
        `core.grid.remove_edits`, then the touched records' refresh with
        the cached skip field (bricks are never freed), one replayed graph
        on a CUDA device."""
        self._remove(xyz, GraphedCall.__call__)

    def remove_voxels_op_by_op(self, xyz) -> None:
        """`remove_voxels` through the same body called op by op."""
        self._remove(xyz, _call_body)

    def _insert(self, xyz, material_index, run) -> None:
        xyz = self._edit_batch(xyz)
        mats = np.asarray(material_index, dtype=np.uint8).ravel()
        if mats.shape[0] != xyz.shape[0]:
            raise ValueError("one material index per voxel")
        st = self.grid_static
        uniq_cells = np.unique(self._cells_of(xyz))
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
        with profiling.zone("edit_insert"):
            self._edit("insert", xyz, mats, run)

    def _remove(self, xyz, run) -> None:
        xyz = self._edit_batch(xyz)
        with profiling.zone("edit_remove"):
            self._edit("remove", xyz, None, run)

    def _edit(self, op: str, xyz, mats, run) -> None:
        """Upload the batch into its padded size's buffer and run the edit
        graph of (`op`, the records' state) through `run`."""
        size = self._padded(xyz.shape[0])
        step = self._edit_cache.pop(size, None)
        if step is None:
            step = EditStep(size, self.device)
        self._edit_cache[size] = step  # the most recently used, last
        while len(self._edit_cache) > self._EDIT_SIZES:
            self._edit_cache.popitem(last=False)
        step.upload(xyz, mats)
        records = self._tables is not None
        key = (op, records, self._tables_skip if records else None)
        run(step.graph(key, lambda: self._edit_body(*key)))

    def _edit_body(self, op: str, records: bool, skip):
        """The edit of `op` over an `EditStep`'s buffer, with the records'
        refresh when they exist, on the scene's current tensors (whose
        addresses a graph keeps). The body holds no reference to its step,
        so an evicted step goes (and its graph's pool with it) at once."""
        st = self.grid_static
        arrays, tables, dist = self.arrays, self._tables, self._dist
        is_diel, ir = self._mat_is_diel, self._mat_ir

        def body(buf):
            xyz, mats, live = EditStep.lanes(buf)
            x, y, z = (xyz[:, i].to(torch.int64) for i in range(3))
            cells = grid_at(st, x, (st.voxel_dims[1] - 1) - y, z)
            if op == "insert":
                apply_edits(st, arrays, xyz, mats, live, is_diel, ir)
                if records:
                    trace_mod.refresh_tables_after_insert(
                        st, arrays, tables, cells, live, use_skip=skip,
                        dist=dist)
            else:
                remove_edits(st, arrays, xyz, live)
                if records:
                    trace_mod.refresh_tables_after_remove(
                        st, arrays, tables, dist, cells, live)

        return body

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


def _call_body(graphed: GraphedCall):
    """`graphed`'s body on its arguments, op by op (no graph)."""
    return graphed.body(*graphed.args)


def _classification(materials: MaterialTable):
    """(bool[256] dielectric, f32[256] ir) of a material table: what the
    edits maintain `diel_mask` and `brick_ir` from."""
    return (np.asarray(materials.mtype) == MAT_DIELECTRIC,
            np.asarray(materials.type_data, dtype=np.float32))


def _checked(image):
    """`image`, after the debug-mode check of its pixels
    (`utils.validation.enable_debug_mode`)."""
    if validation.debug_mode_enabled():
        validation.check_image(image)
    return image


def both_routes(rt: VoxelRT):
    """(`render()`'s image, `render_op_by_op()`'s image) of one frame of
    `rt` from the same state: the temporal accumulator and count are put
    back between the two. On a CUDA device the first is a replay (after
    the step's capture frame), the second the body op by op."""
    saved = (None if rt._accum is None else rt._accum.clone(),
             rt._accum_count)
    want = rt.render_op_by_op()
    if saved[0] is not None:
        rt._accum.copy_(saved[0])
    rt._accum_count = saved[1]
    return rt.render(), want


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
