"""Live terminal viewer — the interactive layer.

The reference is an *interactive* renderer: a GLFW window with WASD/mouse
camera control and an ImGui HUD (reference src/main.zig:156-195,
ImguiGui.zig:121-347). This module is the headless-environment analog: it
paints the rendered framebuffer into the terminal with 24-bit ANSI
half-block characters (two vertical pixels per character cell) and feeds
raw-tty keystrokes through the same `app.input.Input` binding table the
PNG/script modes use (WASD/space/ctrl move, shift sprints, arrows look,
ESC toggles menu mode — main.zig:198-314 semantics).

Terminals deliver key *repeats*, not press/release pairs, so held keys are
synthesized: a keystroke PRESSes its binding and auto-RELEASEs after
`HOLD_S` without a repeat. The HUD line mirrors the reference's metrics
window (frame ms + rolling sparkline, ImguiGui.zig:226-246).

A copy of `zig_vulkan_tpu.app.live`; frames come to the host through
`VoxelRT.device_image_to_host`, and screenshots go to `zvt_live/` under the
temporary directory.

Run: python -m zig_vulkan_tpu_torch.app.run --live
Keys: w/a/s/d move, space up, c down, shift+move sprint, arrows look,
      1/2 spp -/+, 3/4 bounces -/+, p screenshot, q quit.
"""

from __future__ import annotations

import os
import select
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from .input import Action, CursorShape, Input, Key

HOLD_S = 0.25  # synthesized key-hold horizon per repeat

# terminal-cell -> cursor-pixel sensitivity for real mouse motion (a GLFW
# cursor moves in pixels; a terminal reports cells)
MOUSE_CELL_PIXELS = 8.0

# CursorShape -> DECSCUSR style (the terminal's closest analog of the
# reference's 9 GLFW/ImGui cursor shapes, Input.zig:245-276)
_CURSOR_STYLES = {
    CursorShape.ARROW: 1,        # blinking block
    CursorShape.TEXT_INPUT: 5,   # blinking bar
    CursorShape.RESIZE_ALL: 2,   # steady block
    CursorShape.RESIZE_NS: 4,    # steady underline
    CursorShape.RESIZE_EW: 3,    # blinking underline
    CursorShape.RESIZE_NESW: 4,
    CursorShape.RESIZE_NWSE: 4,
    CursorShape.HAND: 6,         # steady bar
    CursorShape.NOT_ALLOWED: 2,
}

_KEYMAP = {
    "w": Key.W, "a": Key.A, "s": Key.S, "d": Key.D,
    " ": Key.SPACE, "c": Key.LEFT_CTRL,
}
_ARROW_LOOK = {  # escape-sequence suffix -> cursor delta (pixels)
    "A": (0.0, -18.0), "B": (0.0, 18.0), "C": (18.0, 0.0), "D": (-18.0, 0.0),
}


def frame_to_ansi(img: np.ndarray, max_cols: int = 160,
                  max_rows: int = 46) -> str:
    """Render an f32[H, W, 3] image (0..1) as 24-bit ANSI half blocks.

    Pure and testable: each output character encodes two vertically
    adjacent pixels (upper = foreground '▀', lower = background). The
    image is box-subsampled to fit (max_cols, 2*max_rows).
    """
    h, w = img.shape[:2]
    cols = min(max_cols, w)
    rows = min(max_rows, h // 2)
    if cols <= 0 or rows <= 0:
        return ""
    ys = (np.arange(rows * 2) * (h / (rows * 2))).astype(int)
    xs = (np.arange(cols) * (w / cols)).astype(int)
    px = np.clip(img[ys][:, xs] * 255.0, 0, 255).astype(np.uint8)
    top = px[0::2]
    bot = px[1::2]
    out = []
    for r in range(rows):
        line = []
        for cidx in range(cols):
            tr, tg, tb = (int(v) for v in top[r, cidx])
            br, bg, bb = (int(v) for v in bot[r, cidx])
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                        f"\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


class _RawTty:
    """Raw-mode stdin context; no-op when stdin isn't a tty."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._saved = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty

            self._saved = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
            # SGR any-motion mouse tracking: the terminal's cursor-pos
            # callback (reference Input.zig cursorPosCallback). 1003 =
            # report all motion, 1006 = SGR encoding (unambiguous coords).
            sys.stdout.write("\x1b[?1003h\x1b[?1006h")
            sys.stdout.flush()
        return self

    def __exit__(self, *a):
        if self._saved is not None:
            import termios

            # reset mouse tracking, cursor style AND visibility — paint()
            # hides the cursor in game mode, so exiting without ?25h would
            # leave the user's shell cursor invisible
            sys.stdout.write("\x1b[?1003l\x1b[?1006l\x1b[0 q\x1b[?25h")
            sys.stdout.flush()
            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              self._saved)
        return False

    def read_keys(self) -> list:
        """Drain pending keystrokes (non-blocking)."""
        if not self.enabled:
            return []
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":
                # arrow / SGR-mouse escape sequence?
                if select.select([sys.stdin], [], [], 0.01)[0]:
                    nxt = sys.stdin.read(1)
                    if nxt == "[" and select.select([sys.stdin], [], [], 0.01)[0]:
                        third = sys.stdin.read(1)
                        if third == "<":
                            # SGR mouse: "<b;x;y(M|m)"
                            seq = ""
                            while select.select([sys.stdin], [], [], 0.01)[0]:
                                c = sys.stdin.read(1)
                                seq += c
                                if c in "Mm":
                                    break
                            ev = parse_sgr_mouse(seq)
                            if ev is not None:
                                keys.append(ev)
                            continue
                        keys.append(("arrow", third))
                        continue
                keys.append(("esc", None))
            else:
                keys.append(("char", ch))
        return keys


def parse_sgr_mouse(seq: str):
    """Parse an SGR mouse body "b;x;y(M|m)" (after ESC[<) into a
    ("mouse", (col, row)) event. Motion and button events both carry the
    position — the cursor-pos path only needs coordinates. Returns None
    on malformed input. Pure and unit-testable."""
    if not seq or seq[-1] not in "Mm":
        return None
    parts = seq[:-1].split(";")
    if len(parts) != 3:
        return None
    try:
        _b, x, y = (int(p) for p in parts)
    except ValueError:
        return None
    return ("mouse", (float(x), float(y)))


class LiveViewer:
    """Interactive loop: render -> paint terminal -> apply keys."""

    def __init__(self, rt, out=None, max_cols: int = 160,
                 max_rows: int = 44):
        self.rt = rt
        self.out = sys.stdout if out is None else out
        self.inp = Input()
        self.max_cols = max_cols
        self.max_rows = max_rows
        self._held: dict = {}   # Key -> (expire time, mods)
        self._cursor = [0.0, 0.0]
        self._last_mouse_cell = None  # baseline for relative mouse-look
        self.frames = 0
        self.screenshot_dir = os.path.join(tempfile.gettempdir(), "zvt_live")

    # -- input synthesis -------------------------------------------------------

    def feed(self, events, now: float) -> bool:
        """Apply raw key events; returns False when the user quits."""
        for kind, val in events:
            if kind == "char":
                low = val.lower()
                if low == "q":
                    return False
                if low == "p":
                    os.makedirs(self.screenshot_dir, exist_ok=True)
                    from ..io.image import write_png

                    path = os.path.join(self.screenshot_dir,
                                        f"shot_{self.frames:04d}.png")
                    write_png(path, self.rt.device_image_to_host(
                        self.rt.render()))
                elif low == "1":
                    self._tune_spp(-1)
                elif low == "2":
                    self._tune_spp(+1)
                elif low == "3":
                    self._tune_bounce(-1)
                elif low == "4":
                    self._tune_bounce(+1)
                elif low in _KEYMAP:
                    # uppercase = sprint: hold LEFT_SHIFT alongside the key
                    if val.isupper():
                        self._hold(Key.LEFT_SHIFT, now)
                    self._hold(_KEYMAP[low], now)
            elif kind == "arrow":
                if val in _ARROW_LOOK:
                    dx, dy = _ARROW_LOOK[val]
                    self._cursor[0] += dx
                    self._cursor[1] += dy
                    self.inp.cursor_event(self._cursor[0], self._cursor[1])
            elif kind == "mouse":
                # real mouse-look: terminal cell coords scaled to cursor
                # pixels feed the same cursor-delta path as the reference
                # (main.zig:294-310). Deltas are taken against the LAST
                # MOUSE cell — arrow-look shares self._cursor, so an
                # absolute assignment here would register the whole
                # arrow-accumulated offset as one violent jump on the
                # first physical mouse motion after keyboard look.
                cx, cy = val
                if self._last_mouse_cell is not None:
                    self._cursor[0] += ((cx - self._last_mouse_cell[0])
                                        * MOUSE_CELL_PIXELS)
                    self._cursor[1] += ((cy - self._last_mouse_cell[1])
                                        * MOUSE_CELL_PIXELS)
                else:
                    # baseline event: zero delta, but still primes the
                    # input layer's previous-cursor state
                    pass
                self.inp.cursor_event(self._cursor[0], self._cursor[1])
                self._last_mouse_cell = (cx, cy)
            elif kind == "esc":
                self.inp.key_event(Key.ESCAPE, Action.PRESS)
                self.inp.key_event(Key.ESCAPE, Action.RELEASE)
        return True

    def _hold(self, key, now: float) -> None:
        if key not in self._held:
            self.inp.key_event(key, Action.PRESS)
        self._held[key] = now + HOLD_S

    def expire_holds(self, now: float) -> None:
        for key, t in list(self._held.items()):
            if now >= t:
                self.inp.key_event(key, Action.RELEASE)
                del self._held[key]

    def _tune_spp(self, d: int) -> None:
        cam = self.rt.camera.d_camera
        cam.samples_per_pixel = int(np.clip(cam.samples_per_pixel + d, 1, 32))

    def _tune_bounce(self, d: int) -> None:
        cam = self.rt.camera.d_camera
        cam.max_bounce = int(np.clip(cam.max_bounce + d, 1, 32))

    # -- frame loop ------------------------------------------------------------

    def hud(self) -> str:
        m = self.rt.metrics
        s = m.summary()
        cam = self.rt.camera.d_camera
        spark = m.sparkline() if hasattr(m, "sparkline") else ""
        return (f"frame {self.frames} | {s.get('avg_ms', 0.0):7.1f} ms "
                f"| {s.get('fps', 0.0):5.1f} fps "
                f"| {s.get('mrays_per_s', 0.0):7.2f} Mray/s "
                f"| spp {int(cam.samples_per_pixel)} "
                f"bounce {int(cam.max_bounce)} {spark}")

    def paint(self, image: np.ndarray) -> None:
        body = frame_to_ansi(image, self.max_cols, self.max_rows)
        # cursor shape/visibility analog (Input.zig updateCursor): menu
        # mode shows the terminal cursor in the GUI-selected DECSCUSR
        # style; game mode hides it (cursor "captured")
        if self.inp.cursor_visible:
            style = _CURSOR_STYLES.get(self.inp.cursor_shape, 1)
            cur = f"\x1b[{style} q\x1b[?25h"
        else:
            cur = "\x1b[?25l"
        # home the cursor instead of clearing: no flicker
        self.out.write("\x1b[H" + body + "\n" + self.hud() + "\x1b[K\n" + cur)
        self.out.flush()

    def run(self, max_frames: Optional[int] = None) -> int:
        rt = self.rt
        if sys.stdout.isatty():
            self.out.write("\x1b[2J")  # clear once
        with _RawTty() as tty_in:
            prev = time.perf_counter()
            while max_frames is None or self.frames < max_frames:
                now = time.perf_counter()
                dt = now - prev if self.frames else 1e-3
                prev = now
                if not self.feed(tty_in.read_keys(), now):
                    break
                self.expire_holds(now)
                self.inp.apply_to_camera(rt.camera, dt)
                rt.update_sun(dt)
                image = rt.draw(dt)
                self.paint(rt.device_image_to_host(image))
                self.frames += 1
        return self.frames
