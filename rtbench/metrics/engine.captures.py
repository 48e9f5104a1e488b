"""engine.captures: the CUDA graphs the program captured in the traced
stretch (zig_vulkan_tpu_torch/engine/step.py: GraphedCall's warm-up and
capture, a frame step's or an edit size's first call): the count of the
program's zone `capture` (`zig_vulkan_tpu_torch.utils.profiling
.snapshot()`). After the warm-up every key and edit size is held, so it
reads 0. Nothing to read where the program keeps no such store or drew no
frame. It moves frame_p99_ms: a capture costs its frame 13-50 ms."""

from rtbench import program_store

NAME = "engine.captures"
UNIT = "captures"
LAYER = "engine (engine.py VoxelRT.draw/render, engine/step.py Step, PushRing)"
SOURCE = "program_counter"
MOVES = "frame_p99_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    held = program_store.store()
    return None if held is None else held.zone_count("capture")
