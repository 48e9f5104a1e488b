"""edit.ms: ms a frame of the edit calls (zig_vulkan_tpu_torch/engine/
engine.py: insert_voxels, remove_voxels -> engine/step.py: EditStep), on
the card's clock: CUDA events the harness records on the current stream
right before and right after each call in the traced stretch, summed over
the batches and divided by the stretch's frames. The card is idle when a
frame's edit begins (the frame before ended in a synchronize), so this is
what the edit adds to a frame: the program's host work before its upload
and graph launch, and the edit's device work. Nothing to read without
edits. It moves frame_ms."""

NAME = "edit.ms"
UNIT = "ms"
LAYER = (
    "edits (engine.py insert_voxels/remove_voxels, engine/step.py EditStep)")
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["edit_brush_1080p"]


def read(stretch):
    ms = stretch.action_ms.get("edit")
    if not ms:
        return None
    return sum(ms) / stretch.frames
