"""The compiled frame step and edit steps: each captured once as a CUDA graph.

The JAX engine compiles its frame into one program (`_build_step` under
`jax.jit`), fed by one host-to-device transfer of packed push constants a
frame. Here the same frame body is a plain torch function of static device
tensors. On a CUDA device `GraphedCall` warms it up once on a side stream
(that call's result is the frame's), captures it as a `torch.cuda.CUDAGraph`,
and replays the graph for every later call; on the CPU it calls the body.
There is no fallback: a capture that fails raises.

The kernels' launch counters (`ops.tile_tracer.grid_hit_tiles.launches`,
`ops.lookup.table_lookup.launches`) move where a wrapper launches its
kernel: in the warm-up, and once more in the capture, which records that
launch into the graph. A replay runs the graph's kernels without calling a
wrapper, so it moves no counter; a profiler trace of the card counts the
kernels a replay runs (`utils.profiling.kernel_launches`).

`PushRing` makes each frame's push-constant upload a copy from pinned host
memory on the current stream, without a synchronize.

`EditStep` does the same for the voxel edits (the JAX engine's jitted
`apply_edits` / `remove_edits` and records refresh): a batch padded to a
fixed number of lanes is uploaded in one pinned copy into a static device
buffer, and one graph per edit kind replays the edit and the refresh over
it.
"""

from __future__ import annotations

import gc
from typing import NamedTuple

import numpy as np
import torch

from ..ops import trace as trace_mod

PUSH_CONSTANTS = 24  # float32 values a frame (the JAX engine's layout)
PUSH_SLOTS = 4       # pinned host buffers behind the uploads


def pack_frame(basis, sun_position, sun_color, sun_radius,
               sample_base) -> np.ndarray:
    """The values a frame's trace reads, as a new f32[PUSH_CONSTANTS] in the
    JAX engine's layout: camera origin, horizontal, vertical, lower-left
    corner (0-11; `ops.trace.camera_basis`' array, or None to leave them 0),
    sun position (12-14), colour (15-17), radius (18), sample base (21).
    The engine adds the denoiser's and the temporal slots (19, 20, 22,
    23)."""
    pc = np.zeros(PUSH_CONSTANTS, dtype=np.float32)
    if basis is not None:
        pc[0:12] = basis
    pc[12:15] = np.asarray(sun_position, np.float32)
    pc[15:18] = np.asarray(sun_color, np.float32)
    pc[18] = np.float32(sun_radius)
    pc[21] = np.float32(sample_base)
    return pc


def trace_from_pc(pc, static, tables, material_indices, mats, width, height,
                  spp, max_bounce, sun_enabled, **rows):
    """`ops.trace.render_rows` with the camera, the sun and the sample base
    read from the device push constants `pc` (`pack_frame`'s layout);
    `rows` are its keyword arguments (max_steps, shadow_probe, use_skip, a
    band's row0 and rows)."""
    return trace_mod.render_rows(
        static, tables, material_indices, mats,
        trace_mod.basis_views(pc[0:12]), width, height, spp, max_bounce,
        pc[12:15], pc[15:18], pc[18], sun_enabled, sample_base=pc[21],
        **rows)


class StepKey(NamedTuple):
    """A step's static configuration: one step, and one capture, a key.

    The fields of the JAX engine's key (`zig_vulkan_tpu/engine/engine.py:
    226-273`) that exist in the port, plus `sun_in_kernel`, which the port
    reads when it builds the frame. Left out with the features not ported:
    `row_bands`, `use_pallas`, `degraded`, `bin_incoherent`,
    `bounce_concurrent`, `n_serve`.

    Unlike the JAX key, this one holds the denoiser's `samples`,
    `distribution_bias` and `inverse_hue_tolerance`, which the JAX step
    reads from its push constants (pc[23], pc[19], pc[20]) while running
    MAX_RUNTIME_SAMPLES + 1 taps and masking the rest. The port computes
    each tap's weight on the host and runs exactly `samples + 1` taps, so a
    change of any of the three costs one new capture, and the default
    frame keeps its 21 taps. The output is the same bit for bit (a masked
    tap adds exactly zero)."""

    internal_width: int
    internal_height: int
    output_width: int
    output_height: int
    samples_per_pixel: int
    max_bounce: int
    sun_enabled: bool
    denoiser_enabled: bool
    pixel_multiplier: float
    max_steps: int
    empty_skip: bool
    temporal: bool
    sun_in_kernel: bool
    denoiser_samples: int
    distribution_bias: float
    inverse_hue_tolerance: float


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


class GraphedCall:
    """`body(*args)` over static tensors `args` (their addresses are baked
    into the graph: later calls see what was written into them in place).

    On the CPU every call runs the body. On a CUDA device the first call
    runs it on a side stream, returns that result and captures the body as
    a graph; every later call replays the graph and returns the static
    output, which the next call overwrites. `captures` counts the captures
    of every GraphedCall in the process."""

    captures = 0

    def __init__(self, body, *args):
        self.body = body
        self.args = args
        self.device = next(_tensors(args)).device
        self.graph = None
        self.out = None

    def __call__(self):
        if self.device.type != "cuda":
            return self.body(*self.args)
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        return self.out

    def _capture(self):
        # the capture stream is opened on the current device: make it ours
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                result = self.body(*self.args)  # the warm-up: this frame
            current.wait_stream(side)
            for t in _tensors(result):
                t.record_stream(current)
            graph = torch.cuda.CUDAGraph()
            # captured on a stream of this device (torch's default capture
            # stream belongs to the device of the process's first capture),
            # with the garbage collector held: a collection could free
            # another graph, and a graph may not be destroyed while a
            # stream captures (that invalidates the capture)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=side):
                    out = self.body(*self.args)
            finally:
                if collecting:
                    gc.enable()
        self.graph, self.out = graph, out
        GraphedCall.captures += 1
        return result


class PushRing:
    """Uploads of a frame's push constants (or of any host array of `numel`
    `dtype` values): a ring of PUSH_SLOTS pinned host buffers, each behind
    the event of its last copy. A call writes the next buffer once the copy
    that last read it has run (so frames issued back to back without a
    synchronize never rewrite a buffer a pending copy still reads), then
    copies it to the device tensor with `non_blocking` on the current
    stream. The host waits only when it runs PUSH_SLOTS uploads ahead of
    the card. On the CPU it is a plain copy."""

    def __init__(self, device, numel=PUSH_CONSTANTS, dtype=torch.float32):
        self.device = torch.device(device)
        self.next = 0
        if self.device.type == "cuda":
            self.host = [torch.empty(numel, dtype=dtype, pin_memory=True)
                         for _ in range(PUSH_SLOTS)]
            self.events = [torch.cuda.Event() for _ in range(PUSH_SLOTS)]

    def upload(self, values: np.ndarray, dst: torch.Tensor) -> None:
        if self.device.type != "cuda":
            dst.copy_(torch.from_numpy(values))
            return
        i = self.next
        self.next = (i + 1) % PUSH_SLOTS
        self.events[i].synchronize()  # returns at once if never recorded
        self.host[i].numpy()[:] = values
        dst.copy_(self.host[i], non_blocking=True)
        self.events[i].record(torch.cuda.current_stream(self.device))


class Step:
    """One compiled step (the JAX engine's `_build_step(key)`): the frame
    `body(pc, accum)`, its static push constants `pc` (f32[24]), the
    temporal accumulator `accum` (None unless the key is temporal) and the
    graph over them. `__call__` runs the frame through the graph (the body
    on the CPU); `op_by_op` calls the body directly. Both return a fresh
    image: later frames do not overwrite it."""

    def __init__(self, key, body, device, accum_shape=None):
        self.key = key
        self.body = body
        self.pc = torch.zeros(PUSH_CONSTANTS, dtype=torch.float32,
                              device=device)
        self.accum = (None if accum_shape is None else
                      torch.zeros(accum_shape, dtype=torch.float32,
                                  device=device))
        self.graphed = GraphedCall(body, self.pc, self.accum)

    def __call__(self):
        return self.graphed().clone()

    def op_by_op(self):
        return self.body(self.pc, self.accum).clone()


class EditStep:
    """The edits of one padded batch size (the JAX engine's jitted
    `apply_edits` / `remove_edits` at one batch shape): a static device
    buffer int32[4 * size + 1] holding the lanes' voxel coordinates
    ([size, 3]), their materials ([size]) and the count of live lanes, the
    pinned ring that uploads a batch into it (one host-to-device copy an
    edit), and one `GraphedCall` over the buffer for each edit kind the
    caller names (`graph(key, make_body)`)."""

    def __init__(self, size: int, device):
        self.size = int(size)
        self.buf = torch.zeros(4 * self.size + 1, dtype=torch.int32,
                               device=device)
        self.ring = PushRing(device, self.buf.numel(), torch.int32)
        self.graphs = {}

    def upload(self, xyz: np.ndarray, mats=None) -> None:
        """Write a batch (int32[n, 3], uint8[n] or None) into the buffer;
        the lanes from n on are zeros."""
        s, n = self.size, xyz.shape[0]
        host = np.zeros(4 * s + 1, dtype=np.int32)
        host[:3 * n] = xyz.reshape(-1)
        if mats is not None:
            host[3 * s:3 * s + n] = mats
        host[4 * s] = n
        self.ring.upload(host, self.buf)

    @staticmethod
    def lanes(buf):
        """(xyz int32[size, 3], materials int32[size], live bool[size]) as
        views and device ops over an edit buffer `buf`."""
        s = (buf.numel() - 1) // 4
        live = torch.arange(s, device=buf.device) < buf[4 * s]
        return buf[:3 * s].view(s, 3), buf[3 * s:4 * s], live

    def graph(self, key, make_body) -> GraphedCall:
        """The `GraphedCall` of `key`, over the buffer, its body made by
        `make_body()` on first use."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = GraphedCall(make_body(), self.buf)
        return g
