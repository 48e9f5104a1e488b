"""pose.native_share: the share of the camera's poses that the native routine
took (zig_vulkan_tpu_torch/core/camera.py: Camera.propagate_pitch_change
through core/pose_host.py, csrc/pose_host.cpp), in %: the program's counter
`pose_native` over its zone `pose`'s count, over the traced stretch
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`). A pose the numpy twin
took adds 0 to the counter, so a program with the routine always has it:
100 where every pose took the routine, lower where the library did not load
or a pose was not float32. Nothing to read where the program keeps no such
store, drew no frame, recorded no pose or has no such counter (a program
without the routine). It moves frame_ms: the routine is what takes the
pose's host time off the frame."""

from rtbench import program_store

NAME = "pose.native_share"
UNIT = "%"
LAYER = "engine: the pose (core/camera.py Camera.propagate_pitch_change)"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough", "edit_brush_1080p", "fly_1080p"]


def read(stretch):
    held = program_store.store()
    if held is None:
        return None
    poses = held.zone_count("pose")
    native = held.snap["counters"].get("pose_native")
    if not poses or native is None:
        return None
    return 100.0 * native / poses
