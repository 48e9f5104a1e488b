"""engine.host_waits: the host's waits on the card a frame, other than the
frame's own synchronize: the program's counter `host_waits`, which each
wait site adds to (zig_vulkan_tpu_torch/engine/engine.py: the records'
first build, the brick-capacity guard's two reads; engine/step.py:
PushRing's upload finding its slot in use; utils/profiling.py: device marks
read before the card ran them), over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`), divided by the store's
own `draw` count. Nothing to read where the program keeps no such store or
drew no frame. It moves frame_p99_ms: a wait stalls the frame it falls
in."""

from rtbench import program_store

NAME = "engine.host_waits"
UNIT = "waits/frame"
LAYER = "engine (engine.py VoxelRT.draw/render, engine/step.py Step, PushRing)"
SOURCE = "program_counter"
MOVES = "frame_p99_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    return program_store.per_frame(lambda s: s.counter("host_waits"))
