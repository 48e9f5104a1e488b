"""traverse.ms: device ms a frame of kernel A, the traversal
(zig_vulkan_tpu_torch/ops/tile_tracer.py -> csrc/traverse.cu): every launch
of `traverse_kernel`, every build, in the traced stretch. It moves
frame_ms."""

NAME = "traverse.ms"
UNIT = "ms"
LAYER = "kernel A (ops/tile_tracer.py, csrc/traverse.cu)"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    ms = stretch.kernel_ms({"A"})
    return ms if ms > 0 else None
