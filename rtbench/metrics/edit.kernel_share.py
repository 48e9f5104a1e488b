"""edit.kernel_share: the share of the edits whose graph holds the
hand-written edit kernels (zig_vulkan_tpu_torch/ops/edit.py, csrc/edit.cu,
called from engine/engine.py: VoxelRT._edit_body), in %: the program's
counter `edit_kernel` over the count of its zones `edit_insert` and
`edit_remove`, over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`). An edit that takes the
plain body (ATen op by op, the CPU's route) adds 0 to the counter, so a
program with the kernels always has it: 100 where every edit ran them.
Nothing to read where the program keeps no such store, drew no frame, made
no edit or has no such counter (a program without the kernels). It moves
frame_ms: the kernels are what take the edit graph's card time off the
frame."""

from rtbench import program_store

NAME = "edit.kernel_share"
UNIT = "%"
LAYER = (
    "edits (engine.py insert_voxels/remove_voxels, engine/step.py EditStep)")
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["edit_brush_1080p"]


def read(stretch):
    held = program_store.store()
    if held is None:
        return None
    edits = held.zone_count("edit_insert") + held.zone_count("edit_remove")
    kernel = held.snap["counters"].get("edit_kernel")
    if not edits or kernel is None:
        return None
    return 100.0 * kernel / edits
