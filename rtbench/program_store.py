"""The program's own spans and counters, as the per-layer readers of
`rtbench/metrics/` read them: the store of
`zig_vulkan_tpu_torch.utils.profiling.snapshot()`, which covers the traced
stretch (the harness turns the program's tracing on for each try and off
after it, so the store holds the last try's stretch and its lead frame).
A reader divides by the store's own `draw` count, not by the stretch's
frames. Where the program keeps no store (a program older than its
`snapshot()`) or drew no frame in it, there is nothing to read."""

from __future__ import annotations

from typing import Callable, Optional


class Store:
    """A snapshot of the program's store that holds at least one frame."""

    def __init__(self, snap: dict):
        self.snap = snap
        self.frames = snap["zones"]["draw"]["count"]

    def zone_ms(self, *names: str) -> Optional[float]:
        """Total host ms of the zones `names` that were entered, or None
        where none was."""
        zones = [self.snap["zones"][n] for n in names
                 if n in self.snap["zones"]]
        return sum(z["total_ms"] for z in zones) if zones else None

    def zone_count(self, name: str) -> int:
        return self.snap["zones"].get(name, {}).get("count", 0)

    def counter(self, name: str) -> int:
        return self.snap["counters"].get(name, 0)

    def device_ms(self, name: str) -> Optional[float]:
        """Total card ms between the device marks `name`, or None where
        no pair of them was read."""
        span = self.snap["device"].get(name)
        return span["total_ms"] if span else None


def store() -> Optional[Store]:
    """The program's store, or None where the program keeps none or drew
    no frame in it."""
    from zig_vulkan_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    draw = snap.get("zones", {}).get("draw")
    if not draw or not draw["count"]:
        return None
    return Store(snap)


def per_frame(total: Callable[[Store], Optional[float]]) -> Optional[float]:
    """`total(store)` over the store's frames; None where there is no
    store or `total` finds nothing."""
    held = store()
    value = None if held is None else total(held)
    return None if value is None else value / held.frames
