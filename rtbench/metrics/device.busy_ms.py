"""device.busy_ms: the union of the card's kernel, copy and memset
intervals over the traced stretch, a frame, in ms (`rtbench.devtrace`). It
moves frame_ms: it is the least a frame can take while nothing overlaps
frames."""

NAME = "device.busy_ms"
UNIT = "ms"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    if stretch.busy_us <= 0:
        return None
    return stretch.busy_us / 1e3 / stretch.frames
