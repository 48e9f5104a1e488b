"""traverse.queued_share: the share of kernel A's launches that took a queue
of live lanes (zig_vulkan_tpu_torch/ops/trace.py: _trace_levels, the queues
kernel D fills in csrc/shade.cu, read by csrc/traverse.cu), in %: the
program's counter `trace_queued` over its counter `trace_launches`, over
the traced stretch (`zig_vulkan_tpu_torch.utils.profiling.snapshot()`;
each frame adds what its body reported, a replay what its capture's body
did). Every launch of a frame after its first scatter launch takes a
queue, so a frame of L levels reads 100 (2L - 1) / 2L with a shadow
launch a level and 100 (L - 1) / L without. Nothing to read where the
program keeps no such store, drew no frame or has no such counter (a
program without the queues). It moves frame_ms: a queued launch reads and
writes only its live lanes, not the whole wavefront's masked ones."""

from rtbench import program_store

NAME = "traverse.queued_share"
UNIT = "%"
LAYER = "kernel A (ops/tile_tracer.py, csrc/traverse.cu)"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p",
             "pathtraced_emissive_1080p"]


def read(stretch):
    held = program_store.store()
    if held is None:
        return None
    counters = held.snap["counters"]
    launches = counters.get("trace_launches")
    queued = counters.get("trace_queued")
    if not launches or queued is None:
        return None
    return 100.0 * queued / launches
