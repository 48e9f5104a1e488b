"""shade.ms: device ms a frame of kernels B to E, the material lookup and
the shading (zig_vulkan_tpu_torch/ops/lookup.py, ops/shade.py ->
csrc/lookup.cu, camera.cu, shade.cu, resolve.cu), in the traced stretch.
It moves frame_ms."""

NAME = "shade.ms"
UNIT = "ms"
LAYER = "kernels B-E (ops/lookup.py, ops/shade.py)"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    ms = stretch.kernel_ms({"B", "C", "D", "E"})
    return ms if ms > 0 else None
