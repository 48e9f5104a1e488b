"""mesh.lead_ms: how long the row-sharded frame's last card to start waits
before its shard's trace, in ms a frame: the largest over shards of the
time between the program's device marks `mesh_lead.<i>`
(zig_vulkan_tpu_torch/parallel/mesh.py: ShardedStep), on shard i's card
from the frame's start (the card idle: `draw()` synchronizes) to the start
of shard i's trace on its stream. It covers the push constants' upload,
their copy between cards and the host's issue of the shards' graphs before
it; the shards are issued in order, so the last reads the largest. Summed
over the traced stretch (`zig_vulkan_tpu_torch.utils.profiling.snapshot()`)
and divided by the store's own `draw` count. Nothing to read where the
program marks no lead (one card, or a program without the marks). It
moves frame_ms: a band that starts late ends late."""

from rtbench import program_store

NAME = "mesh.lead_ms"
UNIT = "ms"
LAYER = "engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py ShardedStep)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_4k_4cards"]


def largest_ms(held, prefix: str):
    """The largest total card ms of the store's spans `<prefix><i>`, or
    None where it holds none."""
    spans = [span["total_ms"] for name, span in held.snap["device"].items()
             if name.startswith(prefix)]
    return max(spans) if spans else None


def read(stretch):
    return program_store.per_frame(lambda s: largest_ms(s, "mesh_lead."))
