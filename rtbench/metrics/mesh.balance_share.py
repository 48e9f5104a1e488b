"""mesh.balance_share: how evenly the row-sharded frame's work falls on its
shards, in %: the mean over shards of each shard's card ms over the
largest (100: even bands). A shard's card ms is the time between its device
marks `mesh_shard.<i>` (zig_vulkan_tpu_torch/parallel/mesh.py: ShardedStep,
one pair around the shard's trace and one around its post-process, on the
shard's stream, after its halo waits), summed over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`). The frame waits for
the slowest shard, so a share of s% leaves the others idle for (100 - s)%
of its time. Nothing to read where the program marks no shard (one card,
or a program without the marks). It moves frame_ms."""

from rtbench import program_store

NAME = "mesh.balance_share"
UNIT = "%"
LAYER = "engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py ShardedStep)"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["pathtraced_4k_4cards"]

PREFIX = "mesh_shard."


def shard_ms(held) -> list:
    """Each marked shard's card ms in the store, by shard."""
    spans = {int(name[len(PREFIX):]): span["total_ms"]
             for name, span in held.snap["device"].items()
             if name.startswith(PREFIX)}
    return [spans[i] for i in sorted(spans)]


def read(stretch):
    held = program_store.store()
    spans = [] if held is None else shard_ms(held)
    if not spans or max(spans) <= 0:
        return None
    return 100.0 * sum(spans) / len(spans) / max(spans)
