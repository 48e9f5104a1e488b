"""mesh.halo_wait_ms: how long a shard of the row-sharded frame waits
between its trace and its post-process, in ms a frame: the largest over
shards of the time between the program's device marks
`mesh_halo_wait.<i>` (zig_vulkan_tpu_torch/parallel/mesh.py: ShardedStep),
on shard i's stream from the end of its trace to the start of its
post-process. It covers the neighbours' traces whose rows the shard's
denoiser reads, the halo copies between cards and the host's issue up to
the shard's post-process graph. Summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count. Nothing to read where the program marks no such
wait (one card, a frame without a post-process, or a program without the
marks). It moves frame_ms: the post-process, and so the band, ends that
much later."""

from rtbench import program_store, spec

NAME = "mesh.halo_wait_ms"
UNIT = "ms"
LAYER = "engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py ShardedStep)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_4k_4cards"]


def read(stretch):
    largest_ms = spec.reader("mesh.lead_ms").largest_ms
    return program_store.per_frame(
        lambda s: largest_ms(s, "mesh_halo_wait."))
