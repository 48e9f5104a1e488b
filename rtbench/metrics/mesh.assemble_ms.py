"""mesh.assemble_ms: the first card's ms a frame putting the row-sharded
frame together (zig_vulkan_tpu_torch/parallel/mesh.py:
ShardedStep._assemble): every band copied into its rows of the image on the
first card, the other cards' bands by copies between cards, after every
shard's last event. The time between the program's device marks
`mesh_assemble` on the first card's stream, summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`) and divided by the
store's own `draw` count. Nothing to read where the program marks no
assembly (one card, or a program without the marks). It moves frame_ms:
the assembly follows the slowest shard."""

from rtbench import program_store

NAME = "mesh.assemble_ms"
UNIT = "ms"
LAYER = "engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py ShardedStep)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_4k_4cards"]


def read(stretch):
    return program_store.per_frame(lambda s: s.device_ms("mesh_assemble"))
