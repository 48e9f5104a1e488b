"""A traced stretch of frames, read from a `torch.profiler` Chrome trace.

The arithmetic is a copy of `chip_smoke.py:device_trace`'s. A trace may lose
its first and its last device records, and its device timestamps may sit
earlier than the host's, so the stretch is read between marker kernels on
the card's own clock: `WARM_MARKS` short `torch.cuda._sleep` kernels
(`spin_kernel`) before the frames, after one frame outside the range, and
`END_MARKS` long ones after them, told apart by their duration; the trace
is open `HEAD_S` before the card's first work and `TAIL_S` after its last,
and a trace that lost its markers is taken again (`TRIES`). The busy time
is the union of the kernel, copy and memset intervals between the markers;
the window is the markers' distance.

Kernel names map to the port's kernels A-F by a frozen copy of
`zig_vulkan_tpu_torch/utils/profiling.py:kernel_kind`'s table. Idle gaps
are named by the innermost host range open at each 2 us of the gap: the
program's zones (`draw`, `render_step`, `device_sync`, `edit_insert`,
`edit_remove`, `build_tables`) and the harness's own (`rtbench.*`).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

WARM_MARKS = 64
MARK_CYCLES = 1000
END_MARKS = 8
END_MARK_CYCLES = 20_000
END_MARK_MIN_US = 5.0
HEAD_S = 0.05
TAIL_S = 0.05
TRIES = 3
MARKER = "spin_kernel"
ON_CARD = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list
GAP_SAMPLE_US = 2.0  # idle time is named this many us at a time

# kernel A's symbol with its template flags, demangled or mangled, and the
# symbols of kernels B to F (csrc/*.cu)
_TRAVERSE = re.compile(r"traverse_kernel(?:<|I)")
_KERNELS = (("lookup_kernel", "B"), ("camera_rays_kernel", "C"),
            ("shade_kernel", "D"), ("resolve_kernel", "E"),
            ("denoise_kernel", "F"), ("resample_kernel", "F"))


def kernel_kind(name: str) -> Optional[str]:
    """The port's kernel ("A" to "F") of a kernel name, or None."""
    if _TRAVERSE.search(name):
        return "A"
    for symbol, kind in _KERNELS:
        if symbol in name:
            return kind
    return None


def marks(n: int, cycles: int) -> None:
    """The card synchronized, `n` marker kernels, synchronized again."""
    import torch

    torch.cuda.synchronize()
    for _ in range(n):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


class LostMarkers(RuntimeError):
    """The trace lost the marker kernels that bound the stretch."""


@dataclasses.dataclass
class Stretch:
    """What a traced stretch of `frames` frames shows, and what the harness
    measured beside it (`action_ms`: CUDA event ms of each action call,
    by the action's name, such as "edit"; `engine`: the configuration's
    "engine" entry)."""

    frames: int
    window_us: float
    busy_us: float
    kernels: List[Tuple[str, float, float]]   # (name, start, duration) us
    gaps: List[Tuple[float, float, str]]      # (start, length us, host)
    action_ms: Dict[str, List[float]]
    engine: dict

    def kernel_ms(self, kinds) -> float:
        """Device ms a frame of the port's kernels `kinds`."""
        us = sum(d for name, _, d in self.kernels
                 if kernel_kind(name) in kinds)
        return us / 1e3 / self.frames

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for name, _, d in self.kernels:
            ops[name] += d / 1e6
        idle = collections.Counter()
        for _, length, host in self.gaps:
            idle[host] += length / 1e6
        return {"device_ops": [[n[:120], s] for n, s in ops.most_common(TOP)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)]}


def _union(spans) -> float:
    busy, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + (hi - lo if hi is not None else 0.0)


def _host_at(zones, starts, t) -> str:
    """The innermost host range open at time t (the latest begun)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 400), -1):
        ts, end, name = zones[j]
        if ts <= t < end:
            best = name
            break
    return best or "no host range"


def _split(zones, starts, a, b):
    """The idle interval [a, b) as (start, length, host range) pieces: the
    innermost host range open at each of its `GAP_SAMPLE_US` steps."""
    n = max(1, int((b - a) // GAP_SAMPLE_US))
    step = (b - a) / n
    pieces = collections.Counter()
    for i in range(n):
        pieces[_host_at(zones, starts, a + (i + 0.5) * step)] += step
    return [(a, length, host) for host, length in pieces.items()]


def read(events: List[dict], frames: int, action_ms=None, engine=None
         ) -> Stretch:
    """The stretch of a trace's `traceEvents`. Raises LostMarkers where the
    range cannot be found."""
    on_card = [e for e in events if e.get("cat") in ON_CARD]
    warm, end = [], []
    for e in on_card:
        if e["cat"] == "kernel" and MARKER in e["name"]:
            (end if e["dur"] >= END_MARK_MIN_US else warm).append(e)
    if not warm:
        raise LostMarkers(f"no warm-up marker among {len(on_card)} records")
    last_warm = max(warm, key=lambda e: e["ts"])
    lo = last_warm["ts"] + last_warm["dur"]
    after = [e["ts"] for e in end if e["ts"] > lo]
    if not after:
        raise LostMarkers(f"no end marker after the warm-up ones "
                          f"({len(on_card)} records)")
    hi = min(after)
    dev = [e for e in on_card
           if MARKER not in e["name"] and lo <= e["ts"] < hi]
    spans = [(e["ts"], min(e["ts"] + e["dur"], hi)) for e in dev]
    if not spans:
        raise LostMarkers("no device activity between the markers")
    zones = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                   for e in events if e.get("cat") == "user_annotation")
    starts = [z[0] for z in zones]
    gaps, t = [], lo
    for a, b in sorted(spans) + [(hi, hi)]:
        if a > t:
            gaps.extend(_split(zones, starts, t, a))
        t = max(t, b)
    kernels = [(e["name"], e["ts"], e["dur"]) for e in dev
               if e["cat"] == "kernel"]
    return Stretch(frames=frames, window_us=hi - lo, busy_us=_union(spans),
                   kernels=kernels, gaps=gaps,
                   action_ms=dict(action_ms or {}),
                   engine=engine or {})


def read_file(path, frames: int, action_ms=None, engine=None) -> Stretch:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return read(events, frames, action_ms, engine)


def per_layer(stretch: Stretch, readers: Dict) -> Dict[str, float]:
    """Each reader's value; a reader that finds nothing gives None and its
    metric is left out."""
    out = {}
    for name, module in readers.items():
        value = module.read(stretch)
        if value is not None:
            out[name] = float(value)
    return out
