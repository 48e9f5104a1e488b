"""Input system.

Re-implements the reference's input layer (reference:
src/modules/Input.zig + the key handlers in src/main.zig:198-314) for a
headless/terminal host: typed key/cursor events, swappable handler
callbacks, and the exact default bindings —

- W/S strafe forward/back (camera z -/+), A/D left/right (x -/+),
  SPACE up (y -), LEFT_CTRL down (y +), LEFT_SHIFT sprint
  (main.zig:198-266; note the reference's inverted y/z signs are kept);
- ESCAPE toggles game/menu mode, which reroutes handlers and releases the
  cursor (main.zig:226-283) — here it toggles `menu_mode`;
- cursor deltas accumulate into yaw/pitch calls with the first
  `mouse_ignore_frames` swallowed (main.zig:294-310).

There is no window system: events come from scripts, tests, or a terminal
frontend, and `apply_to_camera` drives the camera exactly like the
reference's frame loop (main.zig:162-182). A numpy copy of
`zig_vulkan_tpu.app.input`.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Callable, Optional

import numpy as np


class Key(Enum):
    W = "w"
    A = "a"
    S = "s"
    D = "d"
    SPACE = "space"
    LEFT_CTRL = "left_ctrl"
    LEFT_SHIFT = "left_shift"
    ESCAPE = "escape"


class Action(Enum):
    PRESS = "press"
    RELEASE = "release"


class CursorShape(Enum):
    """The nine ImGui cursor shapes the reference maintains
    (Input.zig:245-276: arrow, text input, resize-all, the four
    directional resizes, hand, not-allowed). The terminal frontend maps
    the active shape to a DECSCUSR style when the menu cursor is shown;
    headless hosts just observe the state."""

    ARROW = "arrow"
    TEXT_INPUT = "text_input"
    RESIZE_ALL = "resize_all"
    RESIZE_NS = "resize_ns"
    RESIZE_EW = "resize_ew"
    RESIZE_NESW = "resize_nesw"
    RESIZE_NWSE = "resize_nwse"
    HAND = "hand"
    NOT_ALLOWED = "not_allowed"


@dataclasses.dataclass
class KeyEvent:
    key: Key
    action: Action


@dataclasses.dataclass
class CursorPosEvent:
    x: float
    y: float


class Input:
    """Headless input state machine with the reference's bindings."""

    def __init__(self,
                 key_handler: Optional[Callable[[KeyEvent], None]] = None,
                 cursor_handler: Optional[Callable[[CursorPosEvent], None]] = None):
        self.call_translate = 0
        self.camera_translate = np.zeros(3, dtype=np.float32)
        self.activate_sprint = False
        self.call_yaw = False
        self.call_pitch = False
        self.mouse_delta = np.zeros(2, dtype=np.float32)
        self.mouse_ignore_frames = 5
        self.menu_mode = False
        # cursor-shape + visibility state (Input.zig:245-276 updateCursor
        # + main.zig setInputModeCursor: game mode hides/captures the
        # cursor, menu mode shows it with the GUI-selected shape)
        self.cursor_shape = CursorShape.ARROW
        self.cursor_visible = False
        self._prev_cursor: Optional[CursorPosEvent] = None
        self._key_handler = key_handler or self._game_key_handler
        self._cursor_handler = cursor_handler or self._game_cursor_handler

    # -- handler rebinding (Input.zig:126-132) ---------------------------------
    def set_key_callback(self, fn: Callable[[KeyEvent], None]) -> None:
        self._key_handler = fn

    def set_cursor_pos_callback(self, fn: Callable[[CursorPosEvent], None]) -> None:
        self._cursor_handler = fn

    # -- event ingress -----------------------------------------------------------
    def key_event(self, key: Key, action: Action) -> None:
        self._key_handler(KeyEvent(key, action))

    def cursor_event(self, x: float, y: float) -> None:
        self._cursor_handler(CursorPosEvent(x, y))

    # -- default game handlers (main.zig:198-266, :294-310) ----------------------
    _TRANSLATE = {
        Key.W: (2, -1.0),
        Key.S: (2, +1.0),
        Key.D: (0, +1.0),
        Key.A: (0, -1.0),
        Key.LEFT_CTRL: (1, +1.0),
        Key.SPACE: (1, -1.0),
    }

    def _game_key_handler(self, event: KeyEvent) -> None:
        sign = 1 if event.action == Action.PRESS else -1
        if event.key in self._TRANSLATE:
            axis, value = self._TRANSLATE[event.key]
            self.call_translate += sign
            self.camera_translate[axis] += value * sign
        elif event.key == Key.LEFT_SHIFT:
            self.activate_sprint = event.action == Action.PRESS
        elif event.key == Key.ESCAPE and event.action == Action.PRESS:
            self.menu_mode = True

    def _menu_key_handler(self, event: KeyEvent) -> None:
        if event.key == Key.ESCAPE and event.action == Action.PRESS:
            self.menu_mode = False
            self.mouse_ignore_frames = 5

    # -- cursor shape/visibility (Input.zig:245-276, main.zig:226-283) ----------
    def set_cursor_shape(self, shape: CursorShape) -> None:
        """updateCursor analog: the GUI layer selects the shape; it only
        displays while the cursor is visible (menu mode)."""
        self.cursor_shape = shape

    def update_cursor(self) -> None:
        """Per-frame cursor maintenance: visibility follows the mode
        switch (game = captured/hidden, menu = shown), as the reference
        does on every frame via setInputModeCursor + updateCursor."""
        self.cursor_visible = self.menu_mode

    def _game_cursor_handler(self, event: CursorPosEvent) -> None:
        prev = self._prev_cursor
        self._prev_cursor = event
        if self.mouse_ignore_frames == 0:
            if prev is not None:
                self.mouse_delta[0] += event.x - prev.x
                self.mouse_delta[1] += event.y - prev.y
            eps = 1e-5
            self.call_yaw = self.call_yaw or abs(self.mouse_delta[0]) > eps
            self.call_pitch = self.call_pitch or abs(self.mouse_delta[1]) > eps
        else:
            self.mouse_ignore_frames -= 1

    # -- per-frame camera drive (main.zig:162-182) --------------------------------
    def apply_to_camera(self, camera, dt: float) -> None:
        if self.menu_mode:
            key_h, cur_h = self._menu_key_handler, lambda e: None
        else:
            key_h, cur_h = self._game_key_handler, self._game_cursor_handler
        self._key_handler = key_h
        self._cursor_handler = cur_h
        self.update_cursor()

        if self.call_translate > 0:
            if self.activate_sprint:
                camera.activate_sprint()
            else:
                camera.disable_sprint()
            camera.translate(dt, self.camera_translate)
        if self.call_yaw:
            camera.turn_yaw(-float(self.mouse_delta[0]) * dt)
        if self.call_pitch:
            camera.turn_pitch(float(self.mouse_delta[1]) * dt)
        if self.call_translate > 0 or self.call_yaw or self.call_pitch:
            self.call_yaw = False
            self.call_pitch = False
            self.mouse_delta[:] = 0.0
