"""engine.host_ms: the host's ms a frame in the engine's frame call
(zig_vulkan_tpu_torch/engine/engine.py: VoxelRT.draw -> render, the step
lookup, the push constants and their upload, engine/step.py: Step's replay
and the image's clone), less the wait for the frame's end: the program's
zones `draw` less its child `device_sync`, summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count. Nothing to read where the program keeps no such
store or drew no frame. It moves frame_ms: the card waits while the host
enqueues a frame."""

from rtbench import program_store

NAME = "engine.host_ms"
UNIT = "ms"
LAYER = "engine (engine.py VoxelRT.draw/render, engine/step.py Step, PushRing)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    return program_store.per_frame(
        lambda s: s.zone_ms("draw") - (s.zone_ms("device_sync") or 0.0))
