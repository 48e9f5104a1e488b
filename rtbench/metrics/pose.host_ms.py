"""pose.host_ms: the host's ms a frame in the camera's pose update
(zig_vulkan_tpu_torch/core/camera.py: Camera.propagate_pitch_change, numpy):
the program's zone `pose`, summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count. Nothing to read where the program keeps no such
store, drew no frame or recorded no pose. It moves frame_ms: the card
waits while the host works out the pose."""

from rtbench import program_store

NAME = "pose.host_ms"
UNIT = "ms"
LAYER = "engine: the pose (core/camera.py Camera.propagate_pitch_change)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    return program_store.per_frame(lambda s: s.zone_ms("pose"))
