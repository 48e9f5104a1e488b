"""temporal.device_ms: the card's ms a frame in the temporal running mean
(zig_vulkan_tpu_torch/engine/engine.py: `_build_step`'s body, `accum +=
(img - accum) / (count + 1)` inside the replayed frame graph): the time
between the program's `temporal` device marks (timing events recorded by
the graph around the mean), summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count. The mean's kernels are generic ATen kernels that
a trace cannot attribute by name. Nothing to read where the program keeps
no such store, drew no frame or replayed no marked mean (a frame that is
not temporal, or a program without the marks). It moves frame_ms."""

from rtbench import program_store

NAME = "temporal.device_ms"
UNIT = "ms"
LAYER = "engine: the temporal mean (engine.py _build_step body, _render)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_emissive_1080p"]


def read(stretch):
    return program_store.per_frame(lambda s: s.device_ms("temporal"))
