"""mesh.host_ms: the host's ms a frame issuing the row-sharded frame
(zig_vulkan_tpu_torch/parallel/mesh.py: ShardedStep, which
engine/engine.py VoxelRT.draw runs with `cards` > 1): the push constants'
upload to every card, each shard's trace and post-process graph, the halo
copies between cards and the assembly's copies onto the first card, all
issued from one host thread. The program's zone `mesh_dispatch`, summed over
the traced stretch (`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and
divided by the store's own `draw` count. Nothing to read where the program
keeps no such zone (one card, or a program without the mesh's zone). It
moves frame_ms: the cards wait while the host issues shard after shard."""

from rtbench import program_store

NAME = "mesh.host_ms"
UNIT = "ms"
LAYER = "engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py ShardedStep)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_4k_4cards"]


def read(stretch):
    return program_store.per_frame(lambda s: s.zone_ms("mesh_dispatch"))
