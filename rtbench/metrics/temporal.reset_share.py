"""temporal.reset_share: the share of the temporal frames whose running
mean was zeroed, in %: the program's counter `temporal_resets` over its
counter `temporal_frames` (zig_vulkan_tpu_torch/engine/engine.py:
`_carry_or_reset`, a frame drawn with a temporal key), over the traced
stretch (`zig_vulkan_tpu_torch.utils.profiling.snapshot()`). The traffic
fixes it: one reset a hold, so 1 / `hold_frames`, plus the stretch's lead
frame, which starts a hold (129 of 1,025 frames, 12.59%, at 8-frame
holds); 100 where the mean is never carried. Nothing to read where the
program keeps no such store, drew no frame or has no such counter (a
program without it, or no temporal frame). It moves frame_p99_ms: a reset
adds the accumulator's zeroing, a fill of 24.9 MB at 1080p, to its frame."""

from rtbench import program_store

NAME = "temporal.reset_share"
UNIT = "%"
LAYER = "engine: the temporal mean (engine.py _build_step body, _render)"
SOURCE = "program_counter"
MOVES = "frame_p99_ms"
WORKLOADS = ["pathtraced_emissive_1080p"]


def read(stretch):
    held = program_store.store()
    if held is None:
        return None
    frames = held.snap["counters"].get("temporal_frames")
    if not frames:
        return None
    return 100.0 * held.counter("temporal_resets") / frames
