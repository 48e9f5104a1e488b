"""edit.host_ms: the host's ms a frame in the edit calls
(zig_vulkan_tpu_torch/engine/engine.py: insert_voxels, remove_voxels -> the
guard, the upload and the launch of engine/step.py: EditStep's graph): the
program's zones `edit_insert` and `edit_remove`, each a whole call, summed
over the traced stretch (`zig_vulkan_tpu_torch.utils.profiling.snapshot()`)
and divided by the store's own `draw` count. Nothing to read where the
program keeps no such store, drew no frame or made no edit. It moves
frame_ms: the card waits while the host prepares an edit."""

from rtbench import program_store

NAME = "edit.host_ms"
UNIT = "ms"
LAYER = (
    "edits (engine.py insert_voxels/remove_voxels, engine/step.py EditStep)")
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["edit_brush_1080p"]


def read(stretch):
    return program_store.per_frame(
        lambda s: s.zone_ms("edit_insert", "edit_remove"))
