"""Tracing / profiling hooks: zones, counters and device marks, kept in
memory.

The torch counterpart of `zig_vulkan_tpu.utils.profiling` (the reference's
Tracy integration, SURVEY.md §5.1: ztracy zones around every significant
scope, main.zig:39-41, Pipeline.zig:433, ...). A zone is a
`torch.profiler.record_function` range, which a `torch.profiler` trace
shows by name on the clock of the kernels it launched, plus an NVTX range
on a CUDA build (Nsight Systems shows those), and it adds its duration to
an in-memory store kept by name: count, total ms and self ms (the total
less what the zones opened inside it cover). `count` adds to a counter,
`wait` is the zone of a host wait on the card (also counted under
`host_waits`), and `device_mark` times points of the card's work, inside
CUDA graphs too. `snapshot()` reads the store as plain numbers.

Everything is a no-op unless tracing is enabled, by `enable()` or for the
scope of a `trace_session`, and inside an `untraced()` scope, where a
graph captured holds no mark either. `enable(True)` from off starts a new, empty
recording; `enable(False)` keeps it for reading. The store holds one entry
a name, and at most `MAX_PENDING` device mark pairs wait to be read, so it
stays bounded however long tracing stays on.

The zones of the engine (`engine.engine.VoxelRT`, `engine.step`,
`core.camera`):

    draw              a frame: VoxelRT.draw
      step_lookup       the records (build_tables on first use), the key,
                        the step cache
      push_constants    the frame's push constants and their upload
        temporal          a temporal key's carry or reset of the running
                          mean
      render_step       the step's replay (its capture on first use) and
                        the image's clone
      device_sync       the wait for the frame's end
    pose              Camera.propagate_pitch_change
    edit_insert,      a whole insert_voxels / remove_voxels call
    edit_remove
      edit_guard        validation, cells and the brick-capacity guard
      edit_upload       the batch's pinned upload
      edit_launch       the edit graph's replay (its capture on first use)
    capture           GraphedCall's warm-up and capture of a graph
    mesh_dispatch     a frame of the row-sharded step (parallel.mesh
                      ShardedStep: an engine with cards > 1, inside
                      render_step): the push constants' upload, the
                      shards' graphs, the copies between cards and the
                      assembly issued

the host waits (`wait`, counted under `host_waits`): build_tables (the
records' first build), guard_statuses and guard_active_bricks (the
capacity guard's reads; the roamability report reads the statuses under
guard_statuses too), push_ring (an upload that finds its pinned slot
still in use), device_marks (marks read before the card ran them); the
counters edit_lanes and edit_padded (an edit's live and padded lanes),
edit_kernel (1 an edit that ran the hand-written edit kernels, 0 an edit
that ran their plain body), pose_native (1 a pose the native routine took,
0 a pose its numpy twin took), temporal_frames and temporal_resets (1 a
frame drawn with a temporal key, 1 a frame whose running mean was zeroed),
trace_launches and trace_queued (a frame's kernel A launches, and those of
them that took a queue of live lanes; on a mesh, summed over its shards),
shade_launches and shade_queued (the same of kernel D), key_switches and
key_returns (1 a frame drawn under another key than the frame before it,
1 such a frame whose key's step was kept: a replay), mesh_shards (a sharded frame's shards), mesh_halo_bytes
(the halo rows a sharded frame copies between cards) and
mesh_assembled_bytes (the band bytes it copies onto its first card from
the others);
the device spans (`device_mark` pairs) edit_graph (an edit graph from its
first node to its last), edit_field (the insert's field rebuild; on a card
its three launches, the last of which also writes the touched rows),
temporal (the running mean inside the frame graph), mesh_shard.<i> (shard
i's trace and, a second pair, its post-process on the shard's stream) and
mesh_assemble (a sharded frame's assembly on its first card's stream).

Usage:
    with profiling.trace_session("trace_dir"):    # -Denable_ztracy analog
        engine.draw(dt)                           # zones in the trace
    profiling.snapshot()["zones"]["draw"]         # {"count", "total_ms",
                                                  #  "self_ms"}
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Iterator

import torch

_ENABLED = False
_MUTED = False  # inside `untraced()`
_NVTX = False  # whether zones push NVTX ranges: set where tracing is enabled
_OFF = contextlib.nullcontext()  # what a zone is while tracing is off

TRACE_FILE = "trace.json"  # the Chrome trace a trace_session writes
MAX_PENDING = 256  # device mark pairs that wait to be read, at most


class _Marks:
    """Device marks paired by name: `pairs` holds (name, begin event, end
    event) for each name marked twice."""

    def __init__(self):
        self.opened = {}
        self.pairs = []

    def mark(self, name: str, device) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record(torch.cuda.current_stream(device))
        begin = self.opened.pop(name, None)
        if begin is None:
            self.opened[name] = ev
        else:
            self.pairs.append((name, begin, ev))


class _Store:
    """One recording: zone totals, counters and device spans by name, the
    open zones, and the device mark pairs not read yet."""

    def __init__(self):
        self.zones = {}      # name -> [count, total s, self s]
        self.counters = {}   # name -> int
        self.device = {}     # name -> [count, total ms]
        self.open = []       # the open zones, innermost last
        self.pending = []    # (name, begin event, end event)
        self.eager = _Marks()  # marks made outside a capture

    def add(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


_store = _Store()


def enabled() -> bool:
    return _ENABLED


def enable(value: bool = True) -> None:
    """Turn tracing on or off. On from off starts a new, empty recording;
    off keeps the recording for `snapshot()`."""
    global _ENABLED, _NVTX, _store
    if value and not _ENABLED:
        _store = _Store()
        _NVTX = torch.cuda.is_available()
    _ENABLED = bool(value)


@contextlib.contextmanager
def trace_session(log_dir: str) -> Iterator[None]:
    """Capture a `torch.profiler` trace (CPU and, where there is a card,
    CUDA activity) of the enclosed scope, with tracing enabled, and write
    it to `log_dir/trace.json` as a Chrome trace (the analog of running the
    reference with Tracy attached)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = _ENABLED
    enable(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# kernel A's symbol with its template flags <SHADOW, STATS, SKIP, POW2>,
# demangled or mangled
_TRAVERSE = re.compile(
    r"traverse_kernel(?:<(true|false), (true|false), (true|false), "
    r"(?:true|false)>|ILb([01])ELb([01])ELb([01])ELb[01]E)")


# the symbols of kernels B to F (csrc/lookup.cu, camera.cu, shade.cu,
# resolve.cu, denoise.cu: F's denoiser builds, static and runtime
# (denoise_kernel_runtime), and its resample alone)
_KERNELS = (("lookup_kernel", "B"), ("camera_rays_kernel", "C"),
            ("shade_kernel", "D"), ("resolve_kernel", "E"),
            ("denoise_kernel", "F"), ("resample_kernel", "F"))


def kernel_launches(names) -> dict:
    """Launches of the port's kernels among `names`, the names of the
    kernels a trace shows on the card: kernel A per build (the build names
    of `ops.tile_tracer`) and in all ("A"), kernels B to F ("B", "C", "D",
    "E", "F"). A CUDA graph's replay runs its kernels without calling their
    wrappers, so their launch counters miss them; a trace of the card
    counts them."""
    from ..ops.tile_tracer import _BUILDS

    counts = dict(dict.fromkeys(_BUILDS, 0), A=0,
                  **dict.fromkeys((k for _, k in _KERNELS), 0))
    for name in names:
        kind, build = kernel_kind(name)
        if build is not None:
            counts[build] += 1
        if kind is not None:
            counts[kind] += 1
    return counts


def kernel_kind(name: str):
    """(the port's kernel, "A" to "F", or None; kernel A's build or None)
    of a kernel name a trace shows on the card."""
    from ..ops.tile_tracer import _build_name

    m = _TRAVERSE.search(name)
    if m:
        shadow, stats, skip = (g in ("true", "1")
                               for g in m.groups() if g is not None)
        return "A", _build_name(shadow, stats, skip)
    for symbol, key in _KERNELS:
        if symbol in name:
            return key, None
    return None, None


class _Zone:
    """An open zone: its ranges, its start and what its children took."""

    __slots__ = ("name", "store", "range", "t0", "children")

    def __init__(self, name: str):
        self.name = name
        self.store = _store

    # the profiler's range opens first and closes last, so that a trace
    # gives the zone's own upkeep to the zone and not to its parent; the
    # store's duration leaves the upkeep out
    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if _NVTX:
            torch.cuda.nvtx.range_push(self.name)
        self.children = 0.0
        self.store.open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        st = self.store
        if st.open and st.open[-1] is self:
            st.open.pop()
        if st.open:
            st.open[-1].children += dt
        rec = st.zones.get(self.name)
        if rec is None:
            rec = st.zones[self.name] = [0, 0.0, 0.0]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self.children
        if _NVTX:
            torch.cuda.nvtx.range_pop()
        self.range.__exit__(*exc)
        return False


def zone(name: str):
    """A named zone (ztracy.ZoneN analog), used as `with zone(name):`. Its
    parent is the zone open when it begins. While tracing is off it is a
    shared null context: it records nothing."""
    if not _ENABLED or _MUTED:
        return _OFF
    return _Zone(name)


def wait(site: str):
    """The zone of a host wait on the card at `site`, also counted under
    `host_waits`."""
    if not _ENABLED or _MUTED:
        return _OFF
    _store.add("host_waits", 1)
    return _Zone(site)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    if _ENABLED and not _MUTED:
        _store.add(name, int(n))


@contextlib.contextmanager
def untraced() -> Iterator[None]:
    """A scope that records nothing: no zone, wait, counter or device mark,
    and a graph captured in it holds no mark node, so that its replays add
    no device span either. The zone open around the scope still covers its
    time. (The engine's mirrors repeat an edit on the other cards' replicas
    in one: the edit's counters and spans are those of one edit.)"""
    global _MUTED
    was, _MUTED = _MUTED, True
    try:
        yield
    finally:
        _MUTED = was


# the pairs of the capture in progress (GraphedCall._capture), or None
_capture_marks = None


def device_mark(name: str, device) -> None:
    """Mark the card's stream of `device` with a timing event of `name`.
    Marks come in pairs of one name: the card's time between the two is a
    device span of that name. During a graph capture (`capture_marks`) the
    event becomes an event-record node of the graph, and every replay of
    the graph that tracing sees times the span (`replaying`); outside a
    capture the pair is timed while tracing is on. A no-op off the card."""
    if _MUTED or torch.device(device).type != "cuda":
        return
    if _capture_marks is not None:
        _capture_marks.mark(name, device)
    elif _ENABLED and not torch.cuda.is_current_stream_capturing():
        eager = _store.eager
        eager.mark(name, device)
        if eager.pairs:
            _queue(eager.pairs)
            eager.pairs = []


@contextlib.contextmanager
def capture_marks() -> Iterator[list]:
    """Collect the device mark pairs of the graph captured in the scope
    (whether or not tracing is on: the nodes stay in the graph) into the
    list it yields, for `replaying`."""
    global _capture_marks
    _capture_marks = marks = _Marks()
    try:
        yield marks.pairs
    finally:
        _capture_marks = None


def replaying(pairs: list) -> None:
    """A graph holding the mark `pairs` is about to be replayed: while
    tracing is on, queue them to be read once it has run. A replay records
    the graph's events anew, so what an earlier replay left unread is read
    first."""
    st = _store
    if st.pending and any(p[1] is pairs[0][1] for p in st.pending):
        _settle()
    if _ENABLED:
        _queue(pairs)


def _queue(pairs) -> None:
    _store.pending.extend(pairs)
    if len(_store.pending) > MAX_PENDING:
        # the older half: pairs the card has most likely run, so that a
        # frame being issued does not wait for its own marks
        _settle(len(_store.pending) - MAX_PENDING // 2)


def _settle(n: int | None = None) -> None:
    """Read the `n` oldest pending pairs (every one by default) into their
    device spans, waiting (as a host wait) for a pair the card has not run
    yet."""
    st = _store
    n = len(st.pending) if n is None else n
    for name, begin, end in st.pending[:n]:
        if not end.query():
            with wait("device_marks"):
                end.synchronize()
        rec = st.device.get(name)
        if rec is None:
            rec = st.device[name] = [0, 0.0]
        rec[0] += 1
        rec[1] += begin.elapsed_time(end)
    st.pending = st.pending[n:]


def snapshot() -> dict:
    """The recording as plain numbers: {"zones": {name: {"count",
    "total_ms", "self_ms"}}, "counters": {name: n}, "device": {name:
    {"count", "total_ms"}}}. The device mark pairs still pending are read
    first (waiting for the card where it has not run them)."""
    _settle()
    st = _store
    return {
        "zones": {n: {"count": c, "total_ms": t * 1e3, "self_ms": s * 1e3}
                  for n, (c, t, s) in st.zones.items()},
        "counters": dict(st.counters),
        "device": {n: {"count": c, "total_ms": t}
                   for n, (c, t) in st.device.items()},
    }
