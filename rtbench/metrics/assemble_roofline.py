"""assemble_roofline: the row-sharded frame's assembly's share of its
roofline, in %: the least time of the bytes that land on the first card
from the others, at the published NVLink bandwidth into one card, over the
card's ms between the `mesh_assemble` marks (`mesh.assemble_ms`).

The bytes are the program's counter `mesh_assembled_bytes`
(zig_vulkan_tpu_torch/parallel/mesh.py: ShardedStep, the bands of the
shards on other cards, 12 bytes a pixel: 74,649,600 bytes a frame for three
of four 540-row bands at 3840 wide), at `NVLINK_BYTES_PER_S`: 0.1561 ms a
frame. That rate is H100 SXM5's 18 NVLink 4 links into one card at the
26.5625 GB/s a link and direction that `nvidia-smi nvlink -s` reports
(53.125 Gb/s a lane, four lanes), 478.125 GB/s, and not the published
450 GB/s (25 GB/s a link): of the two the link state is the higher
ceiling, so the bound is the smaller and the share reads the lower. There
is no join kernel: each band is copied into its rows of the image, and the
first card's own band's device copy, which runs beside the others', is
left out of the bound, as is the copies' start-up; every copy lies between
the marks, so the share reads low, never high. Both are summed over the
traced stretch (`zig_vulkan_tpu_torch.utils.profiling.snapshot()`).
Nothing to read where the program counts no such bytes or marks no
assembly. It moves frame_ms."""

from rtbench import program_store

NAME = "assemble_roofline"
UNIT = "%"
LAYER = "engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py ShardedStep)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_4k_4cards"]

NVLINK_BYTES_PER_S = 18 * 26.5625e9


def assemble_bound_ms(nbytes: float) -> float:
    """The least time of `nbytes` landing on one card over NVLink."""
    return nbytes / NVLINK_BYTES_PER_S * 1e3


def read(stretch):
    held = program_store.store()
    if held is None:
        return None
    ms = held.device_ms("mesh_assemble")
    nbytes = held.counter("mesh_assembled_bytes")
    if not ms or not nbytes:
        return None
    return 100.0 * assemble_bound_ms(nbytes) / ms
