"""Traffic generator `settings_flips`: one closed-loop viewer on the
reference's benchmark path (`path_loop`'s poses and sun) who moves one
setting of the reference GUI every `flip_frames` frames, in the order of
the port's key tour (zig_vulkan_tpu_torch/engine/key_tour.py: its setting
moves, a frozen copy of their order and values):

    sun off, sun on; spp 1, 3, 1, back; bounce 2, 3, 2, back; pixel
    multiplier 1.5, 2.0, 1.5, back; denoiser off, on; sun_in_kernel
    flipped, back; empty_skip flipped, back

(bounce counts levels, the GUI slider's value: the engine entry's
`max_bounce` + 1). The tour's temporal, camera, edit and flush moves are
left out: the plain reference has no temporal mean, and the path moves
the camera. Each group ends where the configuration started, so the
settings repeat every `len(moves) * flip_frames` frames.

A move is a `Setting` action: through the program, the reference GUI's
`ControlPanel` (sun, samples, bounces, denoiser) or `rt.trace_config`
(sun_in_kernel, empty_skip); in the reference, the same key set in a copy
of `ref.engine`, which it reads on every frame.

`--seed` picks the first pose of the loop and the frames checked. The
period is the least common multiple of the path's poses and the settings'
cycle; the warm-up is one whole period, so every key the moves select is
met (its step built and captured) before the window, and the window only
returns to keys. Checked: `check_frames` of the window's first period, one
of them under settings other than the configuration's own.
"""

import copy
import dataclasses
import math

from rtbench import traffic


@dataclasses.dataclass(frozen=True)
class Setting:
    """A settings move (the key tour's `label`): the configuration's
    "engine" entry's `group`/`key` set to `value`."""

    label: str
    group: str
    key: str
    value: object
    name = "settings"

    def program(self, rt) -> None:
        from zig_vulkan_tpu_torch.engine.controls import ControlPanel

        ui = ControlPanel(rt)
        if self.group == "sun":
            ui.set_sun_enabled(self.value)
        elif self.key == "samples_per_pixel":
            ui.set_samples_per_pixel(self.value)
        elif self.key == "max_bounce":
            ui.set_max_bounce(self.value + 1)  # the slider's levels
        elif self.group == "denoiser":
            ui.set_denoiser(**{self.key: self.value})
        else:
            rt.trace_config = dataclasses.replace(
                rt.trace_config, **{self.key: self.value})

    def reference(self, ref) -> None:
        engine = copy.deepcopy(ref.engine)
        engine[self.group][self.key] = self.value
        ref.engine = engine


def moves(engine: dict):
    """The tour's setting moves from configuration `engine`'s settings."""
    cam, dn, tc = engine["camera"], engine["denoiser"], engine["trace"]
    spp, bounce = cam["samples_per_pixel"], cam["max_bounce"]
    probe, skip = bool(tc["sun_in_kernel"]), bool(tc["empty_skip"])
    out = [Setting("sun off", "sun", "enabled", False),
           Setting("sun on", "sun", "enabled", True)]
    out += [Setting(f"spp {n}", "camera", "samples_per_pixel", n)
            for n in (1, 3, 1, spp)]
    out += [Setting(f"bounce {n + 1}", "camera", "max_bounce", n)
            for n in (1, 2, 1, bounce)]
    out += [Setting(f"pixel_multiplier {m}", "denoiser", "pixel_multiplier",
                    m) for m in (1.5, 2.0, 1.5, dn["pixel_multiplier"])]
    out += [Setting("denoiser off", "denoiser", "enabled", False),
            Setting("denoiser on", "denoiser", "enabled", True),
            Setting("sun_in_kernel on", "trace", "sun_in_kernel", not probe),
            Setting("sun_in_kernel back", "trace", "sun_in_kernel", probe),
            Setting("empty_skip flipped", "trace", "empty_skip", not skip),
            Setting("empty_skip back", "trace", "empty_skip", skip)]
    return out


def _settings(engine: dict):
    return {(s.group, s.key): engine[s.group][s.key] for s in moves(engine)}


def build(tr: dict, engine: dict, seed: int, static=None, arrays=None):
    n_poses = int(round(tr["path_duration_s"] / tr["path_dt_s"]))
    origins, yaws = traffic.path_poses(n_poses, tr["path_dt_s"],
                                       tr["path_duration_s"])
    sun_pos, sun_col = traffic.sun_states(n_poses, tr["sun_dt_s"],
                                          engine["sun"])
    tour, every = moves(engine), int(tr["flip_frames"])
    cycle = every * len(tour)
    period = n_poses * cycle // math.gcd(n_poses, cycle)
    offset = int(traffic.rng(seed, 0).integers(0, n_poses))

    start = _settings(engine)
    now, own, frames = dict(start), [], []
    for g in range(period):
        p = (offset + g) % n_poses
        acts = ()
        if g % every == 0:
            move = tour[(g // every) % len(tour)]
            now[(move.group, move.key)] = move.value
            acts = (move,)
        own.append(now == start)
        frames.append(traffic.Frame(origins[p], yaws[p], sun_pos[p],
                                    sun_col[p], acts))
    if now != start:
        raise ValueError("settings_flips: the moves do not return to the "
                         "configuration's settings")

    pick = traffic.rng(seed, 2)
    k = min(int(tr["check_frames"]), period)
    other = [w for w in range(period) if not own[w]]
    checked = {int(pick.choice(other))}
    while len(checked) < k:
        checked.add(int(pick.integers(0, period)))
    return traffic.Tables(
        period=period, warmup=period, frames=frames, checked=sorted(checked),
        poses=n_poses, offset=offset)
