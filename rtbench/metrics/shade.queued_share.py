"""shade.queued_share: the share of kernel D's launches that took a queue
of live lanes (zig_vulkan_tpu_torch/ops/trace.py: _trace_levels, the
queues kernel D fills and, from a frame's second level on, reads in
csrc/shade.cu), in %: the program's counter `shade_queued` over its
counter `shade_launches`, over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`; each frame adds what
its body reported, a replay what its capture's body did). Every level's
launch after a frame's first takes a queue, so a frame of L levels reads
100 (L - 1) / L. Nothing to read where the program keeps no such store,
drew no frame or has no such counter (a program whose kernel D shades
every lane). It moves frame_ms: a queued launch reads and writes only the
lanes the previous level left with work, not the whole wavefront."""

from rtbench import program_store

NAME = "shade.queued_share"
UNIT = "%"
LAYER = "kernels B-E (ops/lookup.py, ops/shade.py)"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p",
             "pathtraced_emissive_1080p"]


def read(stretch):
    held = program_store.store()
    if held is None:
        return None
    counters = held.snap["counters"]
    launches = counters.get("shade_launches")
    queued = counters.get("shade_queued")
    if not launches or queued is None:
        return None
    return 100.0 * queued / launches
