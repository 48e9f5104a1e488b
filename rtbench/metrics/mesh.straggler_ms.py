"""mesh.straggler_ms: how long the first card waits for the slowest band of
the row-sharded frame before the assembly, in ms a frame: the time between
the program's device marks `mesh_straggler`
(zig_vulkan_tpu_torch/parallel/mesh.py: ShardedStep), on the first card
from the end of shard 0's last work (its post-process, or its trace where
there is none) to the start of the assembly, which waits for every
shard's last event. Summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count. On the first card `mesh.frame_device_ms` is
`mesh_lead.0` + `mesh_shard.0` + `mesh_halo_wait.0` + this wait +
`mesh.assemble_ms`. Nothing to read where the program marks no such wait
(one card, or a program without the marks). It moves frame_ms: the frame
ends with its slowest band."""

from rtbench import program_store

NAME = "mesh.straggler_ms"
UNIT = "ms"
LAYER = "engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py ShardedStep)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_4k_4cards"]


def read(stretch):
    return program_store.per_frame(lambda s: s.device_ms("mesh_straggler"))
