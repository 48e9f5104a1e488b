"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (from process start to the first timed frame: `setup_s`): the
program is imported, the scene file is loaded (built into `.rtbench_cache/`
on a checkout's first run by the configuration's scene generator), the
traffic tables are made from the seed by the mix's generator, the engine is
built from the configuration's whole "engine" entry, one frame draws the
first pose (the records are built and the frame is captured as a CUDA
graph; the kernel library is built on a checkout's first run), and the
warm-up runs the traffic's warm-up frames (with edits, whole edit cycles
covering at least one loop of the path, so every edit graph is captured
and every brick the edits touch is loaded).

The window (`--trace 0`): one closed-loop viewer. Each frame makes its
actions through the program's public API (an edit:
`VoxelRT.insert_voxels` / `remove_voxels`), hands the program its pose
(the camera's origin and yaw, then `propagate_pitch_change`) and its sun,
calls `VoxelRT.draw()` and synchronizes; the harness's own host work is an
index into the tables. The window runs until `--seconds` have passed and
reports `frame_ms` (the window's seconds over its frames) and
`frame_p99_ms` (the 99th percentile of every frame's latency, from the
frame's start to the end of its synchronize).

`--trace 1`: the same set-up, then a stretch of whole traffic periods (at
least `TRACE_FRAMES` frames) under `torch.profiler` with the program's
zones on, read by `rtbench.devtrace` and the cell's per-layer readers.

Either way the images of the frames the seed picked are kept. Once the
window has closed the peak memory is read, the program is handed the
actions up to the traffic's fullest scene (no draws) and its scene is
decoded, the program is freed, and the reference engine
(`rtbench/references/<reference>.py`) replays the actions on its own copy
of the set-up scene, renders the same frames and decodes its scene
(`rtbench.check` compares). The run exits non-zero, printing no result,
without a CUDA device (or with fewer than the cell asks for), or if `jax`,
`jaxlib`, `flax`, `zig_vulkan_tpu` or `benchmarks` are loaded once the
window has closed.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (/proc), or 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# set-up is timed from the process's start: the interpreter's start and
# this module's imports (torch's among them) count
_T_START = time.monotonic()
_AGE_AT_START = _process_age()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rtbench import check, devtrace, scene, spec, traffic  # noqa: E402
from rtbench.ref.core.grid import dense_materials  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "zig_vulkan_tpu", "benchmarks")
TRACE_FRAMES = 960  # least frames of a traced stretch (whole periods)
EXIT_NO_DEVICE = 3
EXIT_FORBIDDEN = 4
EXIT_USAGE = 2


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = scene.CACHE_DIR
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules():
    """The top-level names of `FORBIDDEN` that `sys.modules` holds."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def engine_config(e: dict):
    """The port's EngineConfig of a configuration's "engine" entry, whose
    keys are EngineConfig's fields (a nested group by its dataclass's
    fields); a key that is no field is a setting made after the engine is
    built (`engine_setters`)."""
    from zig_vulkan_tpu_torch import config as pc

    def make(cls, entry):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in entry.items():
            if k not in fields:
                continue
            sub = getattr(pc, str(fields[k].type), None)
            if isinstance(v, dict):
                if not dataclasses.is_dataclass(sub):
                    raise ValueError(f"{k!r} is no group of {cls.__name__}")
                kw[k] = make(sub, v)
            else:
                kw[k] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)

    return make(pc.EngineConfig, e)


def engine_setters(rt, e: dict) -> None:
    """The keys of a configuration's "engine" entry that are no field of
    EngineConfig, each made as `rt.set_<key>(value)` (`temporal`:
    `VoxelRT.set_temporal`)."""
    from zig_vulkan_tpu_torch import config as pc

    fields = {f.name for f in dataclasses.fields(pc.EngineConfig)}
    for k, v in e.items():
        if k not in fields:
            getattr(rt, f"set_{k}")(v)


class Program:
    """The system under test behind its public API: `step(frame)` makes the
    frame's actions, hands the engine its pose and sun, and returns
    `draw()`'s image."""

    def __init__(self, rt):
        from rtbench.ref.utils import quat

        self.rt = rt
        self.identity = quat.quat_identity()

    def act(self, frame) -> None:
        for action in frame.actions:
            action.program(self.rt)

    def pose(self, frame) -> None:
        cam = self.rt.camera
        cam.d_camera.origin = frame.origin
        cam.yaw = frame.yaw
        cam.pitch = self.identity
        cam.propagate_pitch_change()
        sun = self.rt.sun.device_data
        sun.position = frame.sun_position
        sun.color = frame.sun_color

    def step(self, frame):
        for action in frame.actions:
            action.program(self.rt)
        self.pose(frame)
        return self.rt.draw()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _window(program, tables, g0, seconds, device):
    """The timed window from frame g0: (frames, seconds, latencies, kept
    images by frame)."""
    checked = {tables.warmup + k for k in tables.checked}
    lat, kept = [], {}
    g = g0
    t_begin = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        img = program.step(tables.frame(g))
        _sync(device)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if g in checked:
            kept[g] = img
        g += 1
        if t1 - t_begin >= seconds:
            break
    return g - g0, t1 - t_begin, lat, kept


def _traced(program, tables, g0, device, engine):
    """A traced stretch from frame g0: (Stretch, frames run, kept images
    by frame)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from zig_vulkan_tpu_torch.utils import profiling

    checked = {tables.warmup + k for k in tables.checked}
    n = tables.period * -(-TRACE_FRAMES // tables.period)
    kept, g = {}, g0

    def frame(acts):
        nonlocal g
        fr = tables.frame(g)
        with record_function("rtbench.frame"):
            for action in fr.actions:
                begin = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with record_function(f"rtbench.{action.name}"):
                    begin.record()
                    action.program(program.rt)
                    end.record()
                acts.append((action.name, begin, end))
            with record_function("rtbench.pose"):
                program.pose(fr)
            img = program.rt.draw()
            with record_function("rtbench.sync"):
                _sync(device)
        if g in checked and g not in kept:
            kept[g] = img
        g += 1

    for _ in range(devtrace.TRIES):
        acts = []
        with tempfile.TemporaryDirectory() as tmp:
            was = profiling.enabled()
            profiling.enable(True)
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    time.sleep(devtrace.HEAD_S)
                    frame([])  # outside the range: the trace's first records
                    devtrace.marks(devtrace.WARM_MARKS, devtrace.MARK_CYCLES)
                    for _ in range(n):
                        frame(acts)
                    devtrace.marks(devtrace.END_MARKS,
                                   devtrace.END_MARK_CYCLES)
                    time.sleep(devtrace.TAIL_S)
            finally:
                profiling.enable(was)
            path = Path(tmp, "trace.json")
            prof.export_chrome_trace(str(path))
            action_ms = {}
            for name, b, e in acts:
                action_ms.setdefault(name, []).append(b.elapsed_time(e))
            try:
                stretch = devtrace.read_file(path, n, action_ms, engine)
            except devtrace.LostMarkers as e:
                print(f"# trace retaken: {e}", file=sys.stderr)
                continue
        return stretch, g - g0, kept
    raise devtrace.LostMarkers(f"{devtrace.TRIES} traces lost their markers")


def reference_engine(cell, scene_path, device):
    """The cell's reference engine (`rtbench/references/<reference>.py`,
    "plain" unless the configuration names another) on its own copy of
    the set-up scene."""
    grid, materials = scene.load_reference(scene_path)
    name = cell.config.get("reference", "plain")
    return spec.plugin("references", name).Engine(
        grid, materials, cell.config["engine"], device)


def reference_frames(ref, tables, frames):
    """Yield each frame g of `frames` (and no other) in order, once `ref`
    has made the actions of frames 0 .. g."""
    made = 0
    for g in sorted(frames):
        while made <= g:
            ref.advance(tables.frame(made))
            made += 1
        yield g


def fill_the_scene(program, tables, g: int) -> int:
    """After frame g, hand the program the actions of the frames after it
    (no draws) up to the next frame after the traffic's fullest phase; the
    frame whose scene is then checked."""
    if tables.fullest is None:
        return g
    while g % tables.scene_period != tables.fullest:
        g += 1
        program.act(tables.frame(g))
    return g


def reference_check(cell, scene_path, tables, kept, g_scene, program_scene,
                    device):
    """(`check.frame_gaps` of each kept frame against the reference's
    image, the voxels whose material or emptiness differs between the
    program's scene after frame `g_scene` and the reference's)."""
    t0 = time.perf_counter()
    ref = reference_engine(cell, scene_path, device)
    at = tables.same_scene(g_scene)
    gaps, wrong = [], None
    for g in reference_frames(ref, tables, set(kept) | {at}):
        if g == at:
            wrong = int((program_scene.to(device) != ref.dense()).sum())
        if g in kept:
            gaps.append(check.frame_gaps(kept[g],
                                         ref.image(tables.frame(g))))
    _sync(device)
    print(f"# reference: {len(gaps)} frames and the scene up to frame "
          f"{max(kept, default=at)}, {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    return gaps, wrong


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", readers=None) -> dict:
    """One run of `cell`: the result's fields (without `check` lines
    printed). `readers`: the per-layer readers of a traced run."""
    stages = [("interpreter", _AGE_AT_START),
              ("harness imports", time.monotonic() - _T_START)]
    t = time.monotonic()

    def stage(name):
        nonlocal t
        now = time.monotonic()
        stages.append((name, now - t))
        t = now

    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.io.scene_io import load_scene

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
    stage("program imports and the device")
    engine = cell.config["engine"]
    scene_path = scene.cached(cell.config["scene"])
    ref_grid, _ = scene.load_reference(scene_path)
    stage("scene file")
    tables = traffic.build(cell.traffic, engine, seed, ref_grid.static,
                           ref_grid.arrays)
    del ref_grid
    stage("traffic tables")
    grid, materials = load_scene(str(scene_path))
    rt = VoxelRT(grid, materials, engine_config(engine), device=device)
    engine_setters(rt, engine)
    del grid
    program = Program(rt)
    stage("engine")
    # the first frame builds the records and captures the frame's graph
    program.pose(tables.frame(0))
    rt.draw()
    stage("first frame")
    for g in range(tables.warmup):
        program.step(tables.frame(g))
    _sync(device)
    gc.collect()
    gc.freeze()
    stage("warm-up")
    setup_s = _AGE_AT_START + (time.monotonic() - _T_START)
    print("# setup: " + ", ".join(f"{n} {s:.3f} s" for n, s in stages),
          file=sys.stderr)

    out = {"metrics": {}, "device": {}}
    if trace:
        stretch, frames, kept = _traced(program, tables, tables.warmup,
                                        device, engine)
        out["metrics"] = devtrace.per_layer(stretch, readers or {})
        out["device"]["busy_s"] = stretch.busy_us / 1e6
        out["device"]["window_s"] = stretch.window_us / 1e6
        out["breakdown"] = stretch.breakdown()
    else:
        frames, window_s, lat, kept = _window(program, tables,
                                              tables.warmup, seconds, device)
        print(f"# window: {frames} frames in {window_s:.3f} s; latency ms "
              f"p10 {_percentile(lat, 10) * 1e3:.4f}, median "
              f"{_percentile(lat, 50) * 1e3:.4f}, p90 "
              f"{_percentile(lat, 90) * 1e3:.4f}, max {max(lat) * 1e3:.4f}",
              file=sys.stderr)
        out["metrics"] = {
            "frame_ms": window_s / frames * 1e3,
            "frame_p99_ms": _percentile(lat, 99.0) * 1e3,
            "setup_s": setup_s}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out["attempted"] = frames
    out["forbidden"] = forbidden_modules()
    # the scene as the program holds it, the traffic's fullest
    g_scene = fill_the_scene(program, tables, tables.warmup + frames - 1)
    program_scene = dense_materials(rt.grid_static, rt.arrays)

    # the program's state freed before the reference runs
    del program, rt
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gaps, wrong = reference_check(cell, scene_path, tables, kept, g_scene,
                                  program_scene, device)
    del program_scene
    v = check.verdict(gaps, wrong)
    out.update(correct=v["correct"], failed=v["failed"], check=v["numbers"])
    out["device"].update(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"),
        count=cell.chips, memory_peak_bytes=int(peak))
    return out


def _metric_entries(bench, workload, values, kind):
    units = {m.name: m.unit for m in spec.metrics(bench, kind)
             if m.reported_in(workload)}
    return {name: {"value": values[name], "unit": units[name]}
            for name in units if name in values}


def result_line(bench, workload, out: dict, trace: bool) -> str:
    """The result's JSON line, `check` last."""
    kind = "per_layer" if trace else "end_to_end"
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": _metric_entries(bench, workload, out["metrics"], kind),
            "device": out["device"]}
    if trace:
        line["breakdown"] = out["breakdown"]
    line["check"] = out["check"]
    return json.dumps(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    bench = spec.load()
    try:
        cell = spec.cell(bench, args.workload)
    except KeyError:
        print(f"rtbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return EXIT_USAGE
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {cards}", file=sys.stderr)
        return EXIT_NO_DEVICE
    readers = spec.readers(bench, args.workload) if args.trace else None
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
              readers)
    bad = sorted(set(out.pop("forbidden")) | set(forbidden_modules()))
    if bad:
        print(f"rtbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    line = result_line(bench, args.workload, out, bool(args.trace))
    sys.stderr.flush()
    print(line, flush=True)
    for text in check.lines(out["check"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
