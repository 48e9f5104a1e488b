"""temporal_roofline: the temporal running mean's share of its roofline, in
%: the least time of the mean's work for one frame of the configuration at
the card's published peaks (`rtbench.roofline.bound_ms`) over its card ms
a frame (`temporal.device_ms`: the program's `temporal` device marks,
zig_vulkan_tpu_torch/engine/engine.py `_build_step`'s body). The work:
the traced image read, the accumulator read and written, 4 bytes a
float32 channel each (3 x 1920 x 1080 x 3 x 4 = 74,649,600 bytes at
1080p, 0.02228 ms at the peak's bandwidth), and a subtraction, a
division and an addition a channel. Nothing to read where
`temporal.device_ms` reads nothing. It moves frame_ms."""

from rtbench import program_store
from rtbench.roofline import bound_ms

NAME = "temporal_roofline"
UNIT = "%"
LAYER = "engine: the temporal mean (engine.py _build_step body, _render)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_emissive_1080p"]

CHANNEL_BYTES = 4
PASSES = 3  # the image read, the accumulator read and written
CHANNEL_OPS = 3  # img - accum, / (count + 1), accum +


def temporal_bytes(engine: dict) -> int:
    """Bytes of one frame's running mean for configuration `engine` (its
    "engine" entry)."""
    return PASSES * CHANNEL_BYTES * _channels(engine)


def temporal_ops(engine: dict) -> int:
    return CHANNEL_OPS * _channels(engine)


def _channels(engine: dict) -> int:
    return (engine["internal_resolution_width"]
            * engine["internal_resolution_height"] * 3)


def read(stretch):
    engine = stretch.engine
    if not engine or not engine.get("temporal"):
        return None
    ms = program_store.per_frame(lambda s: s.device_ms("temporal"))
    if not ms:
        return None
    return 100.0 * bound_ms(temporal_bytes(engine), temporal_ops(engine)) / ms
