"""The compiled frame step: a frame captured once as a CUDA graph.

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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PUSH_CONSTANTS = 24  # float32 values a frame (the JAX engine's layout)
PUSH_SLOTS = 4       # pinned host buffers behind the uploads


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
            with torch.cuda.graph(graph):
                out = self.body(*self.args)
        self.graph, self.out = graph, out
        GraphedCall.captures += 1
        return result


class PushRing:
    """Uploads of a frame's push constants: a ring of PUSH_SLOTS pinned host
    buffers, each behind the event of its last copy. A frame writes the
    next buffer once the copy that last read it has run (so frames issued
    back to back without a synchronize never rewrite a buffer a pending
    copy still reads), then copies it to the step's device tensor with
    `non_blocking` on the current stream. The host waits only when it runs
    PUSH_SLOTS frames ahead of the card. On the CPU it is a plain copy."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.next = 0
        if self.device.type == "cuda":
            self.host = [torch.empty(PUSH_CONSTANTS, dtype=torch.float32,
                                     pin_memory=True)
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
