"""edit.field_ms: the card's ms a frame in the inserts' rebuild of the
conservative distance field (zig_vulkan_tpu_torch/ops/trace.py:
refresh_tables_after_insert, inside the insert graphs of engine/step.py:
EditStep): the time between the program's two `edit_field` device marks of
each replay, summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count; a part of edit.device_ms. Nothing to read where
the program keeps no such store, drew no frame or replayed no marked
insert. It moves frame_ms."""

from rtbench import program_store

NAME = "edit.field_ms"
UNIT = "ms"
LAYER = (
    "edits (engine.py insert_voxels/remove_voxels, engine/step.py EditStep)")
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["edit_brush_1080p"]


def read(stretch):
    return program_store.per_frame(lambda s: s.device_ms("edit_field"))
