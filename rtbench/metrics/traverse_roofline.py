"""traverse_roofline: kernel A's share of its roofline, in %: the least time
of the traversal's work for one frame of the configuration at the card's
published bandwidth over kernel A's device ms a frame in the traced
stretch (zig_vulkan_tpu_torch/ops/tile_tracer.py -> csrc/traverse.cu, every
build, `traverse.ms`).

The work: the frame's wavefront (`internal_resolution_width x height x
samples_per_pixel` lanes) traced once, each lane's ray read (origin,
direction, the active byte: `RAY_IN_BYTES`) and its hit written (found; t,
the hit point and normal; the index: `HIT_OUT_BYTES`), 58 bytes a lane
(481,075,200 bytes at 3840x2160 and 1 spp, 0.1436 ms at 3.35 TB/s). The
hits' material bytes, the records' gathers and every later level (bounce
and shadow launches) are left out, so the bound is low, never high, in any
cell. Nothing to read where the trace shows no kernel A. It moves
frame_ms."""

from rtbench.roofline import bound_ms

NAME = "traverse_roofline"
UNIT = "%"
LAYER = "kernel A (ops/tile_tracer.py, csrc/traverse.cu)"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["stream_4k"]

# zig_vulkan_tpu_torch/utils/roofline.py:72-75
RAY_IN_BYTES = 6 * 4 + 1       # origin, direction, active
HIT_OUT_BYTES = 1 + 7 * 4 + 4  # found; t, px..pz, nx..nz; index


def lanes(engine: dict) -> int:
    """Lanes of one frame's first wavefront for configuration `engine`."""
    return (engine["internal_resolution_width"]
            * engine["internal_resolution_height"]
            * engine["camera"]["samples_per_pixel"])


def traverse_bytes(engine: dict) -> int:
    return lanes(engine) * (RAY_IN_BYTES + HIT_OUT_BYTES)


def traverse_bound_ms(engine: dict) -> float:
    """Kernel A's least time for one frame of configuration `engine`."""
    return bound_ms(traverse_bytes(engine), 0)


def read(stretch):
    engine = stretch.engine
    if not engine:
        return None
    ms = stretch.kernel_ms({"A"})
    if ms <= 0:
        return None
    return 100.0 * traverse_bound_ms(engine) / ms
