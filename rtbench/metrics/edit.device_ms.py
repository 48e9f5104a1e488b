"""edit.device_ms: the card's ms a frame in the edit graphs
(zig_vulkan_tpu_torch/engine/engine.py: _edit_body, replayed by
engine/step.py: EditStep): the time between each replay's first and last
nodes, the program's `edit_graph` device marks (timing events recorded by
the graph), summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count. The graphs' kernels are generic ATen kernels that
a trace cannot attribute by name. Nothing to read where the program keeps
no such store, drew no frame or replayed no marked edit graph. It moves
frame_ms."""

from rtbench import program_store

NAME = "edit.device_ms"
UNIT = "ms"
LAYER = (
    "edits (engine.py insert_voxels/remove_voxels, engine/step.py EditStep)")
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["edit_brush_1080p"]


def read(stretch):
    return program_store.per_frame(lambda s: s.device_ms("edit_graph"))
