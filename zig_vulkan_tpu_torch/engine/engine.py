"""VoxelRT — the engine facade on torch.

The torch counterpart of `zig_vulkan_tpu.engine.engine.VoxelRT` (the
reference's public renderer API, src/modules/VoxelRT.zig, with the
per-frame orchestration of voxel_rt/Pipeline.zig). A frame is one compiled
step on one device, as the JAX engine's:

    trace (ops.trace.render_rows: kernels A and B on CUDA)
      -> temporal running mean (when enabled)
      -> denoise + resample (ops.denoise)

`_step_key()` holds the frame's static configuration, `_step_cache` every
key's step (`_build_step`, `engine.step.Step`), kept as the JAX engine keeps
its jitted steps, and `_push_constants()`
packs every per-frame value (camera, sun, sample base, temporal count, the
denoiser's samples, distribution bias and hue tolerance) into one f32[24]
array in the JAX engine's layout: one host-to-device copy a frame, so a new
pose, a moving sun, a new count or a move of a denoiser slider needs no new
step. On a
CUDA device a step is captured once as a CUDA graph and replayed every
frame after; on the CPU its body runs op by op. `render_op_by_op()` calls
the same body op by op on any device (for checks that hook the kernel
wrappers, which a replay does not call).

A graph bakes in the addresses of the scene's tensors, so every write to
them is in place and every graph stays valid: the edits, `flush_grid` (the
new grid's arrays copied into the scene's tensors), a rebuild of the
records after a flush (the exact field, into the records' tensors),
`push_materials` and `push_albedo` (the material table and its device-side
dielectric classification). The frame and edit graphs of an engine share
one memory pool (`engine.step.GraphPool`), so a key or a size kept costs
its static output, not a pool.

The scene's per-cell traversal records are built once, on the first frame
(and the first after a flush), with the exact distance field, and cached,
whatever `empty_skip` is, as the JAX engine's. Voxel edits
(`insert_voxels`, `remove_voxels`) update the scene arrays on the device
and bring the cached records up to date in place, an insert with the fast
conservative field (the reference's dirty-range uploads,
VoxelRT.zig:107-172). As in the JAX engine, a batch is padded to
`_EDIT_PAD` lanes times a power of two, and each padded size is an
`engine.step.EditStep`: one pinned upload a batch and, on a CUDA device,
one graph for each (insert or remove, records current or not) holding the
edit and the refresh, captured once and replayed (the edit body never
waits for the card). On a card the edit and the refresh are the
hand-written kernels of `ops.edit` (csrc/edit.cu); on the CPU their plain
body, `core.grid.apply_edits` / `remove_edits` and the refreshes of
`ops.trace`. Each edit counts `edit_kernel` 1 where its graph or body
ran the kernels, 0 where it ran the plain body: the route the body took
when it ran (a graph keeps what its capture returned). Every padded size is kept, as the JAX
engine's jit keeps each shape. `insert_voxels_op_by_op` and
`remove_voxels_op_by_op` call the same bodies op by op.
`TraceConfig(empty_skip=False)` picks only
the frame's traversal, the exact DDA, which never reads the records'
distance lane: a flip of it keeps the records and the field, and returns
to a key the engine holds by a replay. Host-side mutable state is the
camera and sun (the reference's push constants), the brick-count bound
and the metrics ring. The roamability report (`nonempty_region_fraction`)
reads the scene's status bits from the device when it is asked.

The profiling zones (`utils.profiling.zone`) carry the JAX engine's names
(draw, device_sync, render_step, build_tables, edit_insert, edit_remove)
and split them where the host's work is: a frame's step_lookup and
push_constants, an edit's edit_guard, edit_upload and edit_launch; the
edit graphs mark their span (edit_graph) and the insert's field rebuild
(edit_field) on the card; a temporal frame's carry or reset of the running
mean is the zone temporal, counted under temporal_frames and
temporal_resets, and its frame graph marks the mean (temporal) on the
card; each frame counts kernel A's launches (trace_launches) and those
that took a queue of live lanes (trace_queued), and kernel D's
(shade_launches, shade_queued), as the frame's body reported them (a
replay what its capture's body did); a frame under another step than the
frame before it counts a key switch (key_switches), and a return to a kept
step besides (key_returns). `utils.profiling` lists them all.

With `EngineConfig(cards=n)`, n > 1, the frame's rows are split over a
mesh of n shards (`mesh_devices`: shard i on `cuda:i`, or every shard on
the CPU), and a key's step is a `parallel.mesh.ShardedStep`: each shard
traces its band of rows and post-processes its output rows (the halo rows
crossing between neighbouring cards) through graphs replayed on its own
stream, and the bands are put together on the first card, where `draw()`
waits for the joined frame. Each card holds a replica of the scene, the
material table and the records: the first card's are the engine's own, each
other card's those of an engine of one card on it (`_mirrors`), which the
edits, `flush_grid` and the material pushes reach after the engine's own,
so the replicas never diverge. The per-frame values are the same push
constants (`_push_constants`); the temporal mean is not drawn on a mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DenoiserConfig, EngineConfig, TraceConfig
from ..core.camera import Camera
from ..core.grid import BrickGrid, grid_at
from ..core.materials import MAT_DIELECTRIC, MaterialTable
from ..core.sun import Sun
from ..ops import denoise as denoise_mod
from ..ops import edit as edit_ops
from ..ops import trace as trace_mod
from ..parallel import mesh as pmesh
from ..utils import profiling, validation
from .benchmark import Benchmark
from .metrics import FrameMetrics
from .step import (EditStep, GraphedCall, GraphPool, PushRing, Step,
                   StepKey, pack_frame, trace_from_pc)


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
        # False until the first frame builds the records, and after a flush
        self._records_current = False
        # host-side bound on the active bricks: the edit path never reads
        # the device unless the bound says a batch could exhaust brick_alloc
        self._bricks_upper = int(grid.arrays.active_bricks)

        # temporal accumulation (BASELINE config 4): running mean of traced
        # frames while the camera and sun pose stay put, with fresh jitter
        # seeds per frame; `_accum` is the last temporal step's accumulator
        self.temporal_enabled = False
        self._accum = None
        self._accum_count = 0
        self._pose_key = None

        # every key's step and every padded edit size, their graphs in
        # one pool (None on the CPU, where nothing is captured)
        self._graphs = (GraphPool(self.device) if self.device.type == "cuda"
                        else None)
        self._step_cache = {}
        self._push = PushRing(self.device)
        self._edit_cache = {}  # padded size -> EditStep
        self._drawn = None  # the step of the last frame drawn

        # the mesh of cards > 1 (None on one card), the engines of one card
        # that hold the other cards' replicas, and each shard's owner of its
        # replica
        self.mesh = None
        self._mirrors = ()
        self._owners = ()
        if int(config.cards) > 1:
            self._split(grid, materials, int(config.cards))

    def _split(self, grid: BrickGrid, materials: MaterialTable,
               cards: int) -> None:
        """The mesh of `cards` shards and a replica of the scene on each of
        its devices: the engine's own on the first, an engine of one card
        on each other (from the same host grid)."""
        self.mesh = pmesh.make_mesh(mesh_devices(self.device, cards))
        one = dataclasses.replace(self.config, cards=1,
                                  debug_validation=False)
        owners = {self.mesh.devices[0]: self}
        for dev in self.mesh.distinct[1:]:
            owners[dev] = VoxelRT(grid, materials, one, dev)
        self._mirrors = tuple(owners[d] for d in self.mesh.distinct[1:])
        self._owners = tuple(owners[d] for d in self.mesh.devices)

    def tables(self):
        """The scene's per-cell traversal records, built on first use with
        the exact distance field (ops.trace.build_trace_tables), whatever
        `empty_skip` is, and kept up to date by the edits, as the JAX
        engine keeps its records. After a `flush_grid` the records and the
        field are built again, into the same tensors: the graphs that read
        them stay. Nothing else rebuilds them: `empty_skip` picks only the
        frame's traversal."""
        if not self._records_current:
            st = self.grid_static
            with profiling.wait("build_tables"):
                dist = trace_mod.distance_field(st, self.arrays, exact=True)
                tables = trace_mod.build_trace_tables(st, self.arrays, dist)
                if self._tables is None:
                    self._tables, self._dist = tables, dist
                else:
                    self._tables.copy_(tables)
                    self._dist.copy_(dist)
            self._records_current = True
        return self._tables

    def render(self):
        """Render one frame; returns the device image f32[out_h, out_w, 3],
        which later frames leave as it is. On a CUDA device the step of the
        current key is captured once and replayed. In debug mode
        (`utils.validation.enable_debug_mode`) a frame with non-finite or
        out-of-range pixels raises SceneValidationError."""
        return _checked(self._render(True))

    def render_op_by_op(self):
        """The same frame as `render()`, through the same step's body called
        op by op on any device (no graph): each kernel launch goes through
        its wrapper. Advances the temporal count as `render()` does."""
        return _checked(self._render(False))

    def step(self):
        """The current key's step (a `parallel.mesh.ShardedStep` on a
        mesh), built (not captured) on first use and kept: a return to a
        key replays its graph."""
        self.tables()
        for mirror in self._mirrors:
            mirror.tables()
        key = self._step_key()
        step = self._step_cache.get(key)
        if step is None:
            step = self._step_cache[key] = self._build_step(key)
        return step

    def _render(self, graphed: bool):
        """One frame of the current step, through its graph or op by op."""
        with profiling.zone("step_lookup"):
            kept = len(self._step_cache)
            step = self.step()
            if step is not self._drawn:
                # a frame under another step than the frame before it: a
                # return where the key's step was kept (its graph replays)
                self._drawn = step
                profiling.count("key_switches")
                profiling.count("key_returns",
                                len(self._step_cache) == kept)
        if self.mesh is not None:
            return self._render_sharded(step, graphed)
        with profiling.zone("push_constants"):
            if step.accum is not None:
                with profiling.zone("temporal"):
                    self._carry_or_reset(step)
            self._push.upload(self._push_constants(), step.pc)
        with profiling.zone("render_step"):
            image = step() if graphed else step.op_by_op()
        if step.accum is not None:
            self._accum_count += 1
        return image

    def _render_sharded(self, step, graphed: bool):
        """One frame of a mesh's step over every card's replica and
        records, from the engine's push constants."""
        with profiling.zone("push_constants"):
            pc = self._push_constants()
        owners = self._owners
        with profiling.zone("render_step"):
            return step.frame(tuple(o.arrays for o in owners),
                              tuple(o.mats for o in owners), pc,
                              tuple(o._tables for o in owners), graphed)

    def _carry_or_reset(self, step: Step) -> None:
        """Point the running mean at `step`'s accumulator: carried over
        while the pose key (camera origin, lower-left corner, sun position)
        holds, zeroed with the count after a move. Counted under
        `temporal_frames` and `temporal_resets`."""
        d, sun = self.camera.d_camera, self.sun.device_data
        pose = (tuple(np.asarray(d.origin).tolist()),
                tuple(np.asarray(d.lower_left_corner).tolist()),
                tuple(np.asarray(sun.position).tolist()))
        # the running mean goes on into another temporal step of the same
        # resolution and pose (a new key, or one kept from before), as the
        # JAX engine's one accumulator does
        carry = (self._accum is not None and pose == self._pose_key
                 and self._accum.shape == step.accum.shape)
        if self._accum is not step.accum:
            if carry:
                step.accum.copy_(self._accum)
            self._accum = step.accum
        if not carry:
            step.accum.zero_()
            self._accum_count = 0
            profiling.count("temporal_resets")
        profiling.count("temporal_frames")
        self._pose_key = pose

    def _step_key(self) -> StepKey:
        """The frame's static configuration (the JAX engine's `_step_key`
        less the fields not ported; see `engine.step.StepKey`)."""
        iw, ih = self.internal_resolution
        ow, oh = self.output_resolution
        d = self.camera.d_camera
        dn, tc = self.denoiser, self.trace_config
        return StepKey(
            iw, ih, ow, oh, int(d.samples_per_pixel), int(d.max_bounce),
            bool(self.sun.device_data.enabled), bool(dn.enabled),
            float(dn.pixel_multiplier), int(tc.max_steps),
            bool(tc.empty_skip), bool(self.temporal_enabled),
            bool(tc.sun_in_kernel))

    def _build_step(self, key: StepKey):
        """The step of `key` (on a mesh, `_build_sharded_step`'s) over the
        scene's current tensors: camera rays from pc[0:12], the trace with
        the sun from pc[12:19] and the sample base from pc[21], the
        temporal mean through pc[22], then
        `denoise.postprocess` on the runtime path (as the JAX step's
        `denoise(..., max_samples=MAX_RUNTIME_SAMPLES)`) with the denoiser's
        samples, distribution bias and hue tolerance read from pc[23],
        pc[19] and pc[20]."""
        if self.mesh is not None:
            return self._build_sharded_step(key)
        static = self.grid_static
        tables = self._tables
        material_indices = self.arrays.material_indices
        mats = self.mats
        report = {}  # the body's kernel A and D counts, as its last run did

        def body(pc, accum):
            report.clear()
            img = trace_from_pc(
                pc, static, tables, material_indices, mats,
                key.internal_width, key.internal_height,
                key.samples_per_pixel, key.max_bounce, key.sun_enabled,
                max_steps=key.max_steps, shadow_probe=key.sun_in_kernel,
                use_skip=key.empty_skip, report=report)
            if accum is not None:
                # running mean over pose-static frames, in place, between
                # the `temporal` device marks
                profiling.device_mark("temporal", accum.device)
                accum.add_(trace_mod._div(img - accum, pc[22] + 1.0))
                profiling.device_mark("temporal", accum.device)
                img = accum
            # 0-d views of the push constants: kernel F's runtime build
            # reads them in place, so a replay takes each frame's values
            denoiser = DenoiserConfig(
                samples=pc[23], distribution_bias=pc[19],
                pixel_multiplier=key.pixel_multiplier,
                inverse_hue_tolerance=pc[20], enabled=key.denoiser_enabled)
            return denoise_mod.postprocess(
                img, denoiser, key.output_height, key.output_width,
                max_samples=denoise_mod.MAX_RUNTIME_SAMPLES)

        accum_shape = ((key.internal_height, key.internal_width, 3)
                       if key.temporal else None)
        return Step(key, body, self.device, accum_shape, self._graphs,
                    report)

    def _build_sharded_step(self, key: StepKey):
        """The mesh's step of `key`: the frame of `_build_step` with the
        rows split over the shards, the post-process on the denoiser's
        runtime path with its knobs read from the same push constants."""
        return pmesh.build_sharded_step(
            self.mesh, self.grid_static, width=key.internal_width,
            height=key.internal_height, spp=key.samples_per_pixel,
            max_bounce=key.max_bounce, sun_enabled=key.sun_enabled,
            out_width=key.output_width, out_height=key.output_height,
            denoiser=DenoiserConfig(pixel_multiplier=key.pixel_multiplier,
                                    enabled=key.denoiser_enabled),
            trace_config=TraceConfig(max_steps=key.max_steps,
                                     empty_skip=key.empty_skip,
                                     sun_in_kernel=key.sun_in_kernel),
            max_samples=denoise_mod.MAX_RUNTIME_SAMPLES)

    def _push_constants(self) -> np.ndarray:
        """Per-frame values packed into one f32[24] array, the JAX engine's
        layout: camera origin, horizontal, vertical, lower-left corner
        (0-11), sun position (12-14), colour (15-17), radius (18), denoiser
        distribution bias (19) and inverse hue tolerance (20), sample base
        (21), temporal count (22), denoiser samples clipped to
        MAX_RUNTIME_SAMPLES (23). The step reads all of them."""
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
        debugFlushGrid, VoxelRT.zig:95-104), copied into the scene's
        tensors: every step and edit graph stays. The records are rebuilt
        with the exact field on the next frame."""
        if grid.static != self.grid_static:
            raise ValueError("flush_grid: the grid's geometry must match")
        host = grid.arrays.to_device("cpu")
        pairs = [(f.name, getattr(self.arrays, f.name), getattr(host, f.name))
                 for f in dataclasses.fields(self.arrays)]
        for name, dst, src in pairs:
            if dst.shape != src.shape:
                raise ValueError(f"flush_grid: {name} has shape "
                                 f"{tuple(src.shape)}, the scene's "
                                 f"{tuple(dst.shape)}")
        for _, dst, src in pairs:
            dst.copy_(src)
        self._bricks_upper = int(grid.arrays.active_bricks)
        self._records_current = False
        for mirror in self._mirrors:
            mirror.flush_grid(grid)

    def push_materials(self, materials: MaterialTable) -> None:
        """Replace the material table (VoxelRT.zig:85-88), written into the
        device table and the edits' dielectric classification in place: the
        steps and the edits keep their graphs."""
        self.materials_host = materials
        self.mats.copy_(trace_mod.materials_to_device(materials, self.device))
        is_diel, ir = _classification(materials)
        self._mat_is_diel.copy_(torch.from_numpy(is_diel))
        self._mat_ir.copy_(torch.from_numpy(ir))
        for mirror in self._mirrors:
            mirror.push_materials(materials)

    def push_albedo(self, index: int, albedo) -> None:
        """Update one material's albedo (VoxelRT.zig:90-92 pushAlbedo), in
        place as `push_materials`."""
        self.materials_host.albedo[index] = np.asarray(albedo, dtype=np.float32)
        self.push_materials(self.materials_host)

    def set_temporal(self, enabled: bool) -> None:
        """Toggle temporal accumulation (BASELINE config 4). Not on a
        mesh: the running mean is drawn on one card."""
        if enabled and self.mesh is not None:
            raise ValueError("set_temporal: the temporal mean is not drawn "
                             "on a mesh of cards; build the engine with "
                             "cards=1")
        self.temporal_enabled = bool(enabled)
        self._accum = None
        self._accum_count = 0

    def set_denoiser(self, **knobs) -> None:
        """Tune denoiser push constants (Pipeline.zig:543-557 setters):
        `samples`, `distribution_bias` and `inverse_hue_tolerance` reach the
        next frame through its push constants, on the same step and graph;
        `pixel_multiplier` and `enabled` make a new step key."""
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
        VoxelRT.zig:107-172) through `ops.edit.insert`, with the cached
        records' refresh: on a CUDA device one replayed graph of the
        hand-written edit kernels (csrc/edit.cu), on the CPU their plain
        body.

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
        of one edit kernel on a CUDA device (`ops.edit.remove`)."""
        self._remove(xyz, GraphedCall.__call__)

    def remove_voxels_op_by_op(self, xyz) -> None:
        """`remove_voxels` through the same body called op by op."""
        self._remove(xyz, _call_body)

    def _insert(self, xyz, material_index, run) -> None:
        with profiling.zone("edit_insert"):
            with profiling.zone("edit_guard"):
                xyz, mats = self._insert_guard(xyz, material_index)
            self._edit("insert", xyz, mats, run)

    def _insert_guard(self, xyz, material_index):
        """The insert batch (int32[n, 3], uint8[n]) once validated and held
        to `brick_alloc`."""
        xyz = self._edit_batch(xyz)
        mats = np.asarray(material_index, dtype=np.uint8).ravel()
        if mats.shape[0] != xyz.shape[0]:
            raise ValueError("one material index per voxel")
        st = self.grid_static
        uniq_cells = np.unique(self._cells_of(xyz))
        if self._bricks_upper + uniq_cells.size > st.brick_alloc:
            statuses = self._host_statuses()
            loaded = (statuses[uniq_cells // 32]
                      >> (uniq_cells % 32).astype(np.uint32)) & 1
            actually_new = int((loaded == 0).sum())
            with profiling.wait("guard_active_bricks"):
                active = int(self.arrays.active_bricks)
            if active + actually_new > st.brick_alloc:
                raise MemoryError(
                    f"brick allocation exhausted: {active} active "
                    f"+ {actually_new} new > brick_alloc={st.brick_alloc}")
            self._bricks_upper = active + actually_new
        else:
            self._bricks_upper += uniq_cells.size
        return xyz, mats

    def _host_statuses(self) -> np.ndarray:
        """The scene's status bits read to the host (uint32 words): a host
        wait on the card."""
        with profiling.wait("guard_statuses"):
            return self.arrays.statuses.cpu().numpy().view(np.uint32)

    def _remove(self, xyz, run) -> None:
        with profiling.zone("edit_remove"):
            with profiling.zone("edit_guard"):
                xyz = self._edit_batch(xyz)
            self._edit("remove", xyz, None, run)

    def _edit(self, op: str, xyz, mats, run) -> None:
        """Upload the batch into its padded size's buffer and run the edit
        graph of (`op`, the records' state) through `run`."""
        size = self._padded(xyz.shape[0])
        step = self._edit_cache.get(size)
        if step is None:
            step = self._edit_cache[size] = EditStep(size, self.device,
                                                     self._graphs)
        with profiling.zone("edit_upload"):
            step.upload(xyz, mats)
        profiling.count("edit_lanes", xyz.shape[0])
        profiling.count("edit_padded", size)
        # the records are refreshed while they are current (not before
        # their first build, nor after a flush: the next frame rebuilds
        # them), whatever empty_skip is, as the JAX engine's edits
        key = (op, self._records_current)
        with profiling.zone("edit_launch"):
            kernels = run(step.graph(key, lambda: self._edit_body(*key)))
        profiling.count("edit_kernel", int(kernels))
        # the same edit on the other cards' replicas, untraced: the edit's
        # zones, counters and device spans stay those of one edit of the
        # scene (its `edit_insert` / `edit_remove` zone covers them all)
        with profiling.untraced():
            for mirror in self._mirrors:
                mirror._edit(op, xyz, mats, run)
                mirror._bricks_upper = self._bricks_upper

    def _edit_body(self, op: str, records: bool):
        """The edit of `op` over an `EditStep`'s buffer (`ops.edit.insert`
        / `remove`: csrc/edit.cu on a CUDA device, the plain body on the
        CPU), with the records' refresh when they are current (an insert
        writes the conservative field), on the scene's tensors (whose
        addresses a graph keeps). Its first and last ops are `edit_graph`
        device marks: in a graph, the card's time of each replay. It
        returns the route `ops.edit` took: True for the kernels."""
        st, arrays = self.grid_static, self.arrays
        is_diel, ir = self._mat_is_diel, self._mat_ir
        cached = (self._tables, self._dist) if records else None

        def body(buf):
            profiling.device_mark("edit_graph", buf.device)
            if op == "insert":
                kernels = edit_ops.insert(st, arrays, buf, is_diel, ir,
                                          cached)
            else:
                kernels = edit_ops.remove(st, arrays, buf, cached)
            profiling.device_mark("edit_graph", buf.device)
            return kernels

        return body

    def nonempty_region_fraction(self) -> float:
        """The share of 4x16x16-cell regions that hold a loaded cell: the
        direct measure of how far empty-space roaming has collapsed. Read
        from the scene's status bits on the device when asked."""
        n, nonempty = _region_occupancy(self.grid_static,
                                        self._host_statuses())
        return len(nonempty) / max(1, n)

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


def mesh_devices(device, cards: int):
    """The devices of an engine's mesh of `cards` shards on `device`: on a
    card, `cards` cards from the device's on (shard i on `cuda:i` from
    `cuda:0`); on the CPU every shard on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * cards
    first = (torch.cuda.current_device() if device.index is None
             else device.index)
    if first + cards > torch.cuda.device_count():
        raise ValueError(f"cards={cards} from cuda:{first}: this machine has "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return [torch.device("cuda", first + i) for i in range(cards)]


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


# region edge lengths in grid cells (y, z, x) of the JAX package's TPU
# kernel's region blocks (zig_vulkan_tpu/ops/tile_tracer.py:98): the
# roamability report counts regions of this size
REGION_CELLS = (4, 16, 16)


def _region_occupancy(static, statuses: np.ndarray):
    """(n_regions, set of region ids holding a loaded cell) from host
    status bits (zig_vulkan_tpu/engine/engine.py:615-628); the grid's dims
    are padded up to whole regions."""
    ry, rz, rx = REGION_CELLS
    ny, nz, nx = (-(-static.dim_y // ry), -(-static.dim_z // rz),
                  -(-static.dim_x // rx))
    cells = static.dim_x * static.dim_y * static.dim_z
    bits = np.unpackbits(statuses.view(np.uint8), bitorder="little")[:cells]
    vol = np.zeros((ny * ry, nz * rz, nx * rx), dtype=bool)
    vol[:static.dim_y, :static.dim_z, :static.dim_x] = (
        bits.reshape(static.dim_y, static.dim_z, static.dim_x))
    nonempty = vol.reshape(ny, ry, nz, rz, nx, rx).any(axis=(1, 3, 5))
    return ny * nz * nx, set(np.flatnonzero(nonempty.reshape(-1)).tolist())
