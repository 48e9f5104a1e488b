"""Row-sharded rendering across devices.

The torch counterpart of `zig_vulkan_tpu.parallel.mesh`: framebuffer rows
are sharded across the devices of a 1-D mesh with the scene replicated, and
the image is gathered only at assembly. The JAX module runs one program
under `jax.shard_map` (a single controller: one process, N devices) and
gets the denoiser's halo exchange from XLA's partitioner. The same model
here is one process that owns a tuple of `torch.device`s:

- every distinct device holds one replica of the scene (`replicate_scene`);
- the per-frame values (camera, sun, sample base) go to every distinct
  device as one f32[24] of push constants in the engine's layout
  (`engine.step`): one pinned upload a frame, then a copy between cards;
- shard `i` traces rows `[i*rows, (i+1)*rows)` with `ops.trace.render_rows`
  on its device, under a CUDA stream of its own (kernels A and B launch on
  that stream);
- with the denoiser on, a shard takes the halo rows it needs from its
  neighbours' traced bands (`ops.denoise.band_input_rows`), read in place
  on its own card or copied from another card, and post-processes its band
  of output rows;
- the bands are put together in one image on the mesh's first device.

On CUDA devices each shard's trace and post-process are CUDA graphs
(`engine.step.GraphedCall`), captured on the first call for the replicas
and records it is given and replayed on the shard's own stream; a post
graph reads its neighbours' traced bands on its card where they lie, and
a band from another card through a static slab that a copy fills between
the replays. `ShardedStep.op_by_op` runs the same bodies op by op (on the
CPU every call does).

A device may appear in the mesh more than once: several shards of one card,
each on its own stream (what the JAX package's virtual CPU devices are to
its tests). A mesh of `cpu` devices runs the same code without streams.

Ordering on CUDA is fork-join with events, never a device-wide
synchronize: each shard's stream first waits for the caller's current
stream of its device; a shard that reads a neighbour's band waits for the
event recorded after that band's trace; at the end the caller's stream of
every device waits for the shards' last events, and the first device's for
every shard's. The streams belong to the step, so a buffer that one stream
allocated and another read is reused only by a later step, which starts
behind that join. The assembly then copies each band into its rows of a
fresh image on the first device: a band from another card by a copy
between cards, which runs on that card's current stream and is fenced both
ways against the first device's current stream.

The engine (`engine.engine.VoxelRT` with `EngineConfig(cards=n)`) draws
through `ShardedStep.frame`, with its own push constants and
`max_samples`: the post-process then reads the denoiser's samples,
distribution bias and hue tolerance from them, as the engine's one-card
step does. While tracing is on (`utils.profiling`), a frame is the zone
`mesh_dispatch`; each shard's trace and post-process are each between a
pair of device marks `mesh_shard.<i>` on the shard's stream (after the
halo waits, so a shard's span is its own work), and the assembly between
the marks `mesh_assemble` on the first device's stream; a frame counts
`mesh_shards`, `mesh_halo_bytes` (halo rows copied between cards) and
`mesh_assembled_bytes` (band bytes copied onto the first device from
others), and adds each shard's kernel A and D counts (`trace_launches`,
`trace_queued`, `shade_launches`, `shade_queued`), as its trace body
reported them, as the engine's one-card step does.

The host dispatches the shards in turn from one thread; a thread per shard
was timed on the H100 and lost (CHANGES.md, the entry of the row-sharded
bring-up: "a thread a shard was timed ... and lost").

    python -m zig_vulkan_tpu_torch.parallel.mesh [n] [--device cpu]

runs `dryrun_multichip(n)`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DenoiserConfig, TraceConfig
from ..core.grid import GridArrays, GridStatic
from ..engine.step import (PUSH_CONSTANTS, GraphedCall, PushRing,
                           pack_frame, trace_from_pc)
from ..ops import denoise as denoise_mod
from ..ops import trace as trace_mod
from ..utils import profiling
from ..utils.device import NoCudaDevice, cli_main

TILE_AXIS = "tiles"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over framebuffer tiles (rows): one `torch.device` per
    shard, in row order."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (TILE_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices` (anything `torch.device` takes; a device may
    repeat), by default every visible CUDA device. Without CUDA there is no
    default: pass the devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise NoCudaDevice("make_mesh: no CUDA device is visible; pass "
                               "the devices of the mesh (--device cpu to "
                               "run on the CPU)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(_canonical(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices)


def _canonical(device) -> torch.device:
    """`cuda` names the current card; give it its index, so that equal
    devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def map_replicas(mesh: Mesh, fn, *replicated):
    """Call `fn(*values)` once for each distinct device, with that device's
    entries of the `replicated` per-shard tuples, and return the results as
    a per-shard tuple (shards of one device share one result)."""
    first = {dev: mesh.devices.index(dev) for dev in mesh.distinct}
    done = {dev: fn(*(r[i] for r in replicated)) for dev, i in first.items()}
    return tuple(done[dev] for dev in mesh.devices)


def _to(device, value):
    """A copy of a host array or a tensor on `device` (always a copy: a
    replica never aliases its source)."""
    if torch.is_tensor(value):
        return value.to(device, copy=True)
    return torch.from_numpy(np.array(value)).to(device)


def replicate_scene(mesh: Mesh, arrays: GridArrays, mats):
    """One replica of the scene arrays and the material table on each
    distinct device of the mesh. `arrays` are host arrays
    (`BrickGrid.arrays`) or device tensors; `mats` is
    `ops.trace.materials_to_device`'s table. Returns two per-shard tuples
    (`arrays_r[i]`, `mats_r[i]` are shard i's; shards of one device share
    one replica)."""
    host = not torch.is_tensor(arrays.statuses)
    per_device = {}
    for dev in mesh.distinct:
        if host:
            a = GridArrays.to_device(arrays, dev)
        else:
            a = GridArrays(**{f.name: _to(dev, getattr(arrays, f.name))
                              for f in dataclasses.fields(GridArrays)})
        per_device[dev] = (a, _to(dev, mats))
    return (tuple(per_device[d][0] for d in mesh.devices),
            tuple(per_device[d][1] for d in mesh.devices))


def build_sharded_step(mesh: Mesh, static: GridStatic, *,
                       width: int, height: int, spp: int, max_bounce: int,
                       sun_enabled: bool,
                       out_width: Optional[int] = None,
                       out_height: Optional[int] = None,
                       denoiser: DenoiserConfig = DenoiserConfig(),
                       trace_config: TraceConfig = TraceConfig(),
                       max_samples: Optional[int] = None):
    """Build a multi-device render step.

    Returns a `ShardedStep`: step(arrays_r, mats_r, cam, sun_position,
    sun_color, sun_radius, tables=None, sample_base=0.0) -> f32[out_h,
    out_w, 3] on the mesh's first device. `arrays_r` and `mats_r` are
    `replicate_scene`'s per-shard tuples; `cam` is `ops.trace.camera_vectors`'
    dict (on any device); the sun values and `sample_base` are the host's;
    `tables` is a per-shard tuple of traversal records (`map_replicas` of
    `ops.trace.build_trace_tables`), built here, outside the graphs, for
    every replica when the caller brings none: engines and benchmarks pass
    the cache, so that a frame costs the trace alone.

    `step.frame(arrays_r, mats_r, pc, tables)` draws the same frame from
    push constants the caller packed (the engine's). With `max_samples` the
    post-process takes the denoiser's runtime path (`denoise.postprocess(
    ..., max_samples=)`), its samples, distribution bias and hue tolerance
    read from pc[23], pc[19] and pc[20].

    The image equals the unsharded `render_rows` + `denoise.postprocess` bit
    for bit. `trace_config.max_steps`, `empty_skip` and `sun_in_kernel` act
    as in the engine. The JAX step's `use_pallas`, `tile_interpret`,
    `region_blocks` and `degraded` select among TPU kernel builds and
    serves; kernel A has one build for all of them, so they are left out."""
    return ShardedStep(mesh, static, width=width, height=height, spp=spp,
                       max_bounce=max_bounce, sun_enabled=sun_enabled,
                       out_width=out_width, out_height=out_height,
                       denoiser=denoiser, trace_config=trace_config,
                       max_samples=max_samples)


class BandPlan:
    """What a shard computes: the frame's static configuration, each
    shard's rows, and the bodies of its trace and post-process. Graphs are
    built over these bodies; the plan holds no graph, so a graph that goes
    away takes no cycle of references with it."""

    def __init__(self, static: GridStatic, n: int, *, width, height, spp,
                 max_bounce, sun_enabled, out_width, out_height, denoiser,
                 trace_config, max_samples=None):
        if height % n != 0:
            raise ValueError(f"internal height {height} must divide the "
                             f"mesh size {n}")
        self.static = static
        self.width, self.height = int(width), int(height)
        self.spp, self.max_bounce = int(spp), int(max_bounce)
        self.sun_enabled = bool(sun_enabled)
        self.rows = self.height // n
        self.out_w = int(out_width or width)
        self.out_h = int(out_height or height)
        self.denoiser = denoiser
        self.max_samples = max_samples
        self.trace_config = trace_config
        self.use_skip = bool(trace_config.empty_skip)
        # output rows of shard i, and the input rows they read
        self.out_rows = [(i * self.out_h // n, (i + 1) * self.out_h // n)
                         for i in range(n)]
        self.in_rows = [denoise_mod.band_input_rows(
            r0, r1, self.out_h, self.height, denoiser, max_samples)
            for r0, r1 in self.out_rows]
        # without the denoiser at the same size, shard i's output rows are
        # its traced rows
        self.traced_is_output = (not denoiser.enabled and (
            self.out_h, self.out_w) == (self.height, self.width))
        # shard i's kernel A and D counts, as its trace body's last run
        # reported them (`ops.trace.render_rows`' `report`)
        self.reports = [{} for _ in range(n)]

    def trace(self, i, pc, tables, material_indices, mats):
        """Shard i's band of traced rows over its push constants `pc`."""
        tc = self.trace_config
        report = self.reports[i]
        report.clear()
        return trace_from_pc(
            pc, self.static, tables, material_indices, mats, self.width,
            self.height, self.spp, self.max_bounce, self.sun_enabled,
            max_steps=int(tc.max_steps), shadow_probe=bool(tc.sun_in_kernel),
            use_skip=self.use_skip, row0=i * self.rows, rows=self.rows,
            report=report)

    def post(self, i, *pieces, pc=None):
        """Shard i's output rows from the pieces of its input rows; with
        `max_samples` the denoiser's knobs are read from its push constants
        `pc` (0-d views, read in place by a replay)."""
        a = self.in_rows[i][0]
        slab = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        denoiser = self.denoiser
        if self.max_samples is not None:
            denoiser = dataclasses.replace(
                denoiser, samples=pc[23], distribution_bias=pc[19],
                inverse_hue_tolerance=pc[20])
        return denoise_mod.postprocess(
            slab, denoiser, self.out_h, self.out_w,
            band=denoise_mod.Band(*self.out_rows[i], a, self.height),
            max_samples=self.max_samples)

    def sources(self, i):
        """(shard j, its input rows [r0, r1)) whose traced rows shard i's
        post-process reads."""
        a, b = self.in_rows[i]
        rows = self.rows
        return [(j, max(a, j * rows), min(b, (j + 1) * rows))
                for j in range(a // rows, (b - 1) // rows + 1)]


class ShardedStep:
    """The row-sharded frame of `build_sharded_step` (the JAX package's
    jitted `shard_map` step, zig_vulkan_tpu/parallel/mesh.py:127-134).

    Calling it runs each shard's trace graph, then each shard's post-process
    graph, on the shard's stream (captured on the first call, or on the
    first call with other replicas or records: one set of graphs is kept;
    op by op on the CPU). `op_by_op` calls the same bodies on the same
    inputs without graphs. `frame` is either route over push constants the
    caller packed. Each returns a fresh image."""

    def __init__(self, mesh: Mesh, static: GridStatic, **frame):
        self.mesh = mesh
        self.plan = BandPlan(static, mesh.size, **frame)
        self.cuda = [dev for dev in mesh.distinct if dev.type == "cuda"]
        self.streams = [torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None for dev in mesh.devices]
        self.graphed = all(dev.type == "cuda" for dev in mesh.devices)
        # the per-frame values on each distinct device, in the engine's
        # push-constant layout (`engine.step.pack_frame`)
        self.pcs = {dev: torch.zeros(PUSH_CONSTANTS, dtype=torch.float32,
                                     device=dev) for dev in mesh.distinct}
        self.push = PushRing(mesh.devices[0])
        self.slabs = {}       # (shard, source shard) -> its halo rows' copy
        self._inputs = None   # the replicas and records the graphs read
        self._trace = None    # shard -> GraphedCall of its trace
        self._post = None     # shard -> GraphedCall of its post-process
        self.marks = tuple(f"mesh_shard.{i}" for i in range(mesh.size))
        # bytes of the bands that the assembly copies onto the first device
        # from another
        first, plan = mesh.devices[0], self.plan
        self.assembled_bytes = sum(
            (r1 - r0) * plan.out_w * 3 * 4
            for (r0, r1), dev in zip(plan.out_rows, mesh.devices)
            if dev != first)
        if self.cuda:
            from .. import _build

            _build.library()  # built before the first frame, not inside it

    def __call__(self, arrays_r, mats_r, cam, sun_position, sun_color,
                 sun_radius, tables=None, sample_base=0.0):
        return self._frame(arrays_r, mats_r, tables, self.graphed,
                           *self._packed(cam, sun_position, sun_color,
                                         sun_radius, sample_base))

    def op_by_op(self, arrays_r, mats_r, cam, sun_position, sun_color,
                 sun_radius, tables=None, sample_base=0.0):
        """The same frame with each shard's bodies called op by op (no
        graph): every kernel launch goes through its wrapper."""
        return self._frame(arrays_r, mats_r, tables, False,
                           *self._packed(cam, sun_position, sun_color,
                                         sun_radius, sample_base))

    def frame(self, arrays_r, mats_r, pc: np.ndarray, tables,
              graphed: bool = True):
        """The frame over host push constants `pc` (f32[PUSH_CONSTANTS] in
        the engine's layout: `engine.engine.VoxelRT._push_constants`) and
        the per-shard records `tables`, through the graphs where the mesh
        has them and `graphed`, else op by op."""
        return self._frame(arrays_r, mats_r, tables,
                           graphed and self.graphed, pc)

    def _on(self, i):
        """Shard i's device and stream as the current ones."""
        if self.streams[i] is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[i])

    def _recorded(self, i):
        return (None if self.streams[i] is None
                else self.streams[i].record_event())

    def _frame(self, arrays_r, mats_r, tables, graphed, pc, basis=None):
        with profiling.zone("mesh_dispatch"):
            return self._dispatch(arrays_r, mats_r, tables, graphed, pc,
                                  basis)

    def _dispatch(self, arrays_r, mats_r, tables, graphed, pc, basis):
        mesh, plan, devices = self.mesh, self.plan, self.mesh.devices
        if tables is None:
            tables = map_replicas(
                mesh, lambda a: trace_mod.one_shot_tables(
                    plan.static, a, plan.use_skip), arrays_r)
        self._upload(pc, basis)
        profiling.count("mesh_shards", mesh.size)
        callers = {dev: torch.cuda.current_stream(dev) for dev in self.cuda}
        for i, stream in enumerate(self.streams):
            if stream is not None:
                stream.wait_stream(callers[devices[i]])
        inputs = tuple((self.pcs[devices[i]], tables[i],
                        arrays_r[i].material_indices, mats_r[i])
                       for i in range(mesh.size))
        if graphed:
            self._hold(inputs)
        traced, traced_at = [], []
        for i in range(mesh.size):
            with self._on(i):
                profiling.device_mark(self.marks[i], devices[i])
                traced.append(self._traced(i, inputs[i], graphed))
                profiling.device_mark(self.marks[i], devices[i])
                traced_at.append(self._recorded(i))
        # each shard's kernel A and D counts (a replay its capture's)
        for report in plan.reports:
            for name, n in report.items():
                profiling.count(name, n)
        # every band is traced (its event recorded) before any shard reads
        # its neighbours' rows
        bands, done_at = traced, traced_at
        if not plan.traced_is_output:
            bands, done_at = [], []
            for i in range(mesh.size):
                with self._on(i):
                    pieces = [self._piece(i, j, r0, r1, traced, traced_at)
                              for j, r0, r1 in plan.sources(i)]
                    profiling.device_mark(self.marks[i], devices[i])
                    bands.append(self._posted(i, inputs[i][0], pieces,
                                              graphed))
                    profiling.device_mark(self.marks[i], devices[i])
                    done_at.append(self._recorded(i))
        first = devices[0]
        for i, dev in enumerate(devices):
            if self.streams[i] is not None:
                callers[dev].wait_event(done_at[i])
                if dev != first:
                    callers[first].wait_event(done_at[i])
        return self._assemble(bands)

    def _assemble(self, bands):
        """A fresh image on the first device with each shard's band in its
        output rows, the copies between the `mesh_assemble` marks on the
        first device's stream, behind every shard's last event."""
        plan, first = self.plan, self.mesh.devices[0]
        profiling.count("mesh_assembled_bytes", self.assembled_bytes)
        with (torch.cuda.device(first) if first.type == "cuda"
              else contextlib.nullcontext()):
            image = torch.empty((plan.out_h, plan.out_w, 3),
                                dtype=torch.float32, device=first)
            profiling.device_mark("mesh_assemble", first)
            for (r0, r1), band in zip(plan.out_rows, bands):
                image[r0:r1].copy_(band, non_blocking=True)
            profiling.device_mark("mesh_assemble", first)
        return image

    def _hold(self, inputs):
        """Graphs over `inputs`: kept while a call brings the same tensors,
        made anew (captured on their first call) when it brings others."""
        held = self._inputs
        if held is not None and all(x is y for got, want in zip(inputs, held)
                                    for x, y in zip(got, want)):
            return
        self._inputs = inputs
        self._trace = [GraphedCall(functools.partial(self.plan.trace, i),
                                   *inputs[i])
                       for i in range(self.mesh.size)]
        self._post = [None] * self.mesh.size

    def _traced(self, i, args, graphed):
        """Shard i's traced band: its body's, or its graph's static band."""
        if not graphed:
            return self.plan.trace(i, *args)
        g = self._trace[i]
        band = g()
        if band is not g.out:
            # the capture call returns its warm-up's band: the static band
            # the post graphs read holds it too
            g.out.copy_(band)
        return g.out

    def _posted(self, i, pc, pieces, graphed):
        """Shard i's output rows: its body's, or its graph's, a graph over
        the pieces of the call that captures it and its push constants
        `pc`."""
        if not graphed:
            return self.plan.post(i, *pieces, pc=pc)
        if self._post[i] is None:
            self._post[i] = GraphedCall(
                functools.partial(self.plan.post, i, pc=pc), *pieces)
        return self._post[i]()

    def _piece(self, i, j, r0, r1, traced, traced_at):
        """Image rows [r0, r1) of shard j's traced band for shard i's
        post-process, ordered behind shard j's trace; called with shard i's
        stream current. On shard i's device the piece is a view; from
        another card a copy fills shard i's static slab for shard j (the
        slab a post graph reads)."""
        rows = self.plan.rows
        piece = traced[j][r0 - j * rows:r1 - j * rows]
        dev = self.mesh.devices[i]
        if j == i:
            return piece
        if piece.device == dev:
            if self.streams[i] is not None:
                self.streams[i].wait_event(traced_at[j])
            return piece
        slab = self.slabs.get((i, j))
        if slab is None:
            slab = self.slabs[(i, j)] = torch.empty(
                piece.shape, dtype=piece.dtype, device=dev)
        # a copy between cards runs on the source card's current stream;
        # with shard j's stream current there it is ordered behind shard j's
        # trace, and shard i's stream (still current on `dev`) waits for it
        with self._on(j):
            slab.copy_(piece, non_blocking=True)
        profiling.count("mesh_halo_bytes", piece.numel() * piece.element_size())
        return slab

    def _packed(self, cam, sun_position, sun_color, sun_radius,
                sample_base):
        """(the frame's push constants, the camera basis where it lies on
        a card, else None): `pack_frame`'s values and the denoiser's knobs
        (pc[19], pc[20], pc[23]) of the step's configuration."""
        basis = torch.cat([cam[k].reshape(3)
                           for k in trace_mod.CAMERA_BASIS])
        on_host = basis.device.type == "cpu"
        pc = pack_frame(basis.numpy() if on_host else None, sun_position,
                        sun_color, sun_radius, sample_base)
        dn = self.plan.denoiser
        pc[19] = np.float32(dn.distribution_bias)
        pc[20] = np.float32(dn.inverse_hue_tolerance)
        pc[23] = np.float32(min(int(dn.samples),
                                denoise_mod.MAX_RUNTIME_SAMPLES))
        return pc, None if on_host else basis

    def _upload(self, pc, basis):
        """The frame's push constants to every distinct device: one upload
        from pinned memory (the camera basis, when it lies on a card,
        copied there on the card), then a copy to each other card."""
        devices = self.mesh.distinct
        self.push.upload(pc, self.pcs[devices[0]])
        if basis is not None:
            self.pcs[devices[0]][0:12].copy_(basis)
        for dev in devices[1:]:
            self.pcs[dev].copy_(self.pcs[devices[0]], non_blocking=True)


def render_image_sharded(mesh: Mesh, static: GridStatic, arrays: GridArrays,
                         mats, camera_device, sun_device, *,
                         sun_enabled: Optional[bool] = None,
                         denoiser: DenoiserConfig = DenoiserConfig(enabled=False),
                         trace_config: TraceConfig = TraceConfig(),
                         out_size: Optional[tuple] = None):
    """Convenience one-shot sharded render from host camera/sun state."""
    d = camera_device
    ow, oh = out_size if out_size is not None else (None, None)
    step = build_sharded_step(
        mesh, static,
        width=int(d.image_width), height=int(d.image_height),
        spp=int(d.samples_per_pixel), max_bounce=int(d.max_bounce),
        sun_enabled=bool(sun_device.enabled if sun_enabled is None
                         else sun_enabled),
        out_width=ow, out_height=oh,
        denoiser=denoiser, trace_config=trace_config)
    arrays_r, mats_r = replicate_scene(mesh, arrays, mats)
    return step(arrays_r, mats_r,
                trace_mod.camera_vectors(d, mesh.devices[0]),
                sun_device.position, sun_device.color, sun_device.radius)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the whole sharded frame on an `n_devices`-shard mesh at a small
    size: a sharded render with the denoiser, voxel edits on every replica
    with the records' refresh, and a second render; each image must equal
    the unsharded render of the same scene bit for bit.

    The shards go round the visible CUDA devices (n shards of one card
    where there is one), or all onto `device` when one is named."""
    from ..config import CameraConfig, SunConfig
    from ..core.camera import Camera
    from ..core.materials import MAT_DIELECTRIC
    from ..core.sun import Sun
    from ..models.scenes import small_test_scene
    from ..ops import edit as edit_ops

    if device is None:
        cards = make_mesh().devices
        mesh = make_mesh([cards[i % len(cards)] for i in range(n_devices)])
    else:
        mesh = make_mesh([device] * n_devices)
    first = mesh.devices[0]

    sc = small_test_scene()
    static = sc.grid.static
    width, height = 32, 4 * n_devices  # rows divide the mesh
    spp, max_bounce = 1, 2
    cam = Camera(75.0, width, height,
                 CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=spp,
                              max_bounce=max_bounce - 1))
    sun = Sun(SunConfig(enabled=True)).device_data
    denoiser = DenoiserConfig(enabled=True, samples=4)

    step = build_sharded_step(
        mesh, static, width=width, height=height, spp=spp,
        max_bounce=max_bounce, sun_enabled=True, denoiser=denoiser)
    arrays_r, mats_r = replicate_scene(
        mesh, sc.grid.arrays, trace_mod.materials_to_device(sc.materials, first))

    def build_records(a):
        dist = trace_mod.distance_field(static, a)
        return trace_mod.build_trace_tables(static, a, dist), dist

    records = map_replicas(mesh, build_records, arrays_r)
    tables = tuple(r[0] for r in records)
    cam_vecs = trace_mod.camera_vectors(cam.d_camera, first)

    def sharded():
        return step(arrays_r, mats_r, cam_vecs, sun.position, sun.color,
                    sun.radius, tables=tables)

    def unsharded():
        img = trace_mod.render_rows(
            static, tables[0], arrays_r[0].material_indices, mats_r[0],
            cam_vecs, width, height, spp, max_bounce, sun.position,
            sun.color, sun.radius, True)
        return denoise_mod.postprocess(img, denoiser, height, width)

    def check(img, what):
        if tuple(img.shape) != (height, width, 3) or img.device != first:
            raise AssertionError(f"dryrun_multichip: {what}: shape "
                                 f"{tuple(img.shape)} on {img.device}")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"dryrun_multichip: {what}: not finite")
        if not torch.equal(img, unsharded()):
            raise AssertionError(f"dryrun_multichip: {what}: the sharded "
                                 f"image differs from the unsharded one")

    img = sharded()
    check(img, "first render")

    # the same edits on every replica, with the records' refresh, through
    # the engine's route (`ops.edit.insert`), in place (a wall between the
    # camera and the scene's cube, in view of even a 4-row frame)
    ex, ey, ez = np.meshgrid(np.arange(2, 30), np.arange(4, 28),
                             np.arange(22, 24), indexing="ij")
    xyz = np.stack([ex.ravel(), ey.ravel(), ez.ravel()], -1).astype(np.int32)
    mats_e = np.where(ey.ravel() % 2 == 0, 3, 4).astype(np.uint8)
    table = sc.materials
    buf = edit_ops.pack(xyz.shape[0], xyz, mats_e)

    def edit(arrays, recs):
        dev = arrays.statuses.device
        edit_ops.insert(
            static, arrays, torch.from_numpy(buf).to(dev),
            torch.from_numpy(np.asarray(table.mtype) == MAT_DIELECTRIC).to(dev),
            torch.from_numpy(np.asarray(table.type_data,
                                        dtype=np.float32)).to(dev), recs)

    map_replicas(mesh, edit, arrays_r, records)
    img2 = sharded()
    check(img2, "render after the edits")
    if torch.equal(img, img2):
        raise AssertionError("dryrun_multichip: the edits changed no pixel")

    print(f"dryrun_multichip({n_devices}): OK - sharded render "
          f"{tuple(img.shape)} with the denoiser's halo, edits on "
          f"{len(mesh.distinct)} replica(s) and a second render, each equal "
          f"to the unsharded render bit for bit, on "
          f"{[str(d) for d in mesh.devices]}", flush=True)


@cli_main
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Dry run of the row-sharded frame at a small size.")
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="number of shards (default 8)")
    ap.add_argument("--device", default=None,
                    help="put every shard on this device (e.g. cpu); by "
                         "default the shards go round the CUDA devices")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
