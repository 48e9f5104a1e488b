"""device.idle_share: the share of the traced stretch in which no kernel,
copy or memset ran on the card, in %: 100 * (1 - busy / window), both from
the profiler's trace between the stretch's marker kernels
(`rtbench.devtrace`). It moves frame_ms: a frame the host holds back leaves
the card idle."""

NAME = "device.idle_share"
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    if stretch.window_us <= 0:
        return None
    return 100.0 * (1.0 - stretch.busy_us / stretch.window_us)
