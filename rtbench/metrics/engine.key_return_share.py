"""engine.key_return_share: the share of the traced stretch's key switches
that returned to a kept step, in % (zig_vulkan_tpu_torch/engine/engine.py:
VoxelRT._render counts `key_switches`, a frame drawn under another step
than the frame before it, and `key_returns`, such a frame whose key's step
was already kept, so that its graph replays; read through
`zig_vulkan_tpu_torch.utils.profiling.snapshot()`). After a warm-up that
drew every key of the traffic, each switch is a return: it reads 100.
Nothing to read where the program keeps no store, has no such counter (a
program older than it) or switched no key in the stretch. It moves
frame_p99_ms: a switch to a key with no kept step builds and captures it,
13-50 ms in its frame."""

from rtbench import program_store

NAME = "engine.key_return_share"
UNIT = "%"
LAYER = "engine (engine.py VoxelRT.draw/render, engine/step.py Step, PushRing)"
SOURCE = "program_counter"
MOVES = "frame_p99_ms"
WORKLOADS = ["default_settings"]


def read(stretch):
    held = program_store.store()
    if held is None:
        return None
    counters = held.snap["counters"]
    switches = counters.get("key_switches")
    returns = counters.get("key_returns")
    if not switches or returns is None:
        return None
    return 100.0 * returns / switches
