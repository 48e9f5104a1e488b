"""mesh.frame_device_ms: the cards' ms a frame of the row-sharded frame
(zig_vulkan_tpu_torch/parallel/mesh.py: ShardedStep), from before the push
constants' upload to the end of the assembly: the time between the
program's device marks `mesh_frame` on the first card's stream, which the
upload to every other card follows and the assembly, behind every shard's
last event, precedes. Summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count. Nothing to read where the program marks no such
frame (one card, or a program without the marks). It moves frame_ms: the
frame is this span plus the host's time around it."""

from rtbench import program_store

NAME = "mesh.frame_device_ms"
UNIT = "ms"
LAYER = "engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py ShardedStep)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_4k_4cards"]


def read(stretch):
    return program_store.per_frame(lambda s: s.device_ms("mesh_frame"))
