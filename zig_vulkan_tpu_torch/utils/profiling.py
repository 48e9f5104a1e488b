"""Tracing / profiling hooks.

The torch counterpart of `zig_vulkan_tpu.utils.profiling` (the reference's
Tracy integration, SURVEY.md §5.1: ztracy zones around every significant
scope, main.zig:39-41, Pipeline.zig:433, ...). A zone is a
`torch.profiler.record_function` range, which a `torch.profiler` trace
shows by name, plus an NVTX range on a CUDA build, with the zone names the
JAX engine uses. Zones are no-ops unless profiling is enabled, by
`enable()` or for the scope of a `trace_session`.

Usage:
    with profiling.trace_session("trace_dir"):    # -Denable_ztracy analog
        with profiling.zone("draw"):
            engine.draw(dt)
    profiling.frame_mark()   # per-frame marker (ztracy.FrameMark analog)
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Iterator

import torch

_ENABLED = False
_frame_counter = 0
_log_fn = None

TRACE_FILE = "trace.json"  # the Chrome trace a trace_session writes


def enabled() -> bool:
    return _ENABLED


def enable(value: bool = True) -> None:
    global _ENABLED
    _ENABLED = value


@contextlib.contextmanager
def trace_session(log_dir: str) -> Iterator[None]:
    """Capture a `torch.profiler` trace (CPU and, where there is a card,
    CUDA activity) of the enclosed scope, with the zones enabled, and write
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


@contextlib.contextmanager
def zone(name: str) -> Iterator[None]:
    """A named profiling zone (ztracy.ZoneN analog). A no-op unless
    profiling is enabled."""
    if not _ENABLED:
        yield
        return
    nvtx = torch.cuda.is_available()
    t0 = time.perf_counter()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    _log(name, time.perf_counter() - t0)


def frame_mark() -> None:
    """Per-frame marker (ztracy.FrameMark, reference main.zig:194)."""
    global _frame_counter
    _frame_counter += 1
    if _ENABLED:
        _log("frame", 0.0, extra=f"#{_frame_counter}")


def set_log_fn(fn) -> None:
    global _log_fn
    _log_fn = fn


def _log(name: str, dt: float, extra: str = "") -> None:
    if _log_fn is not None:
        _log_fn(name, dt, extra)
