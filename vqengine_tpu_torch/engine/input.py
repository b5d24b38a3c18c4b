"""Input state — counterpart of reference Source/Engine/Core/Input.{h,cpp}:
per-frame key/mouse state maps with IsKeyDown (held) and IsKeyTriggered
(pressed this frame) queries and the PostUpdate frame rollover.

Headless adaptation: events arrive programmatically (scripted runs, tests,
or a future display frontend) instead of WM_INPUT.
"""
from __future__ import annotations


class Input:
    def __init__(self):
        self._down: set[str] = set()
        self._triggered: set[str] = set()
        self._released: set[str] = set()
        self.mouse_dx = 0.0
        self.mouse_dy = 0.0
        self.mouse_x = 0
        self.mouse_y = 0
        self._clicks: list[tuple[int, int, int]] = []

    # --- producers ------------------------------------------------------
    def on_key_down(self, key: str) -> None:
        key = key.lower()
        if key not in self._down:
            self._triggered.add(key)
        self._down.add(key)

    def on_key_up(self, key: str) -> None:
        key = key.lower()
        self._down.discard(key)
        self._released.add(key)

    def on_mouse_move(self, dx: float, dy: float) -> None:
        self.mouse_dx += dx
        self.mouse_dy += dy

    def on_mouse_click(self, x: int, y: int, button: int = 0) -> None:
        self._clicks.append((x, y, button))

    # --- queries (Input.h API) -------------------------------------------
    def is_key_down(self, key: str) -> bool:
        return key.lower() in self._down

    def is_key_triggered(self, key: str) -> bool:
        return key.lower() in self._triggered

    def is_key_released(self, key: str) -> bool:
        return key.lower() in self._released

    def clicks(self) -> list[tuple[int, int, int]]:
        return list(self._clicks)

    # --- frame rollover (Input::PostUpdate) ------------------------------
    def post_update(self) -> None:
        self._triggered.clear()
        self._released.clear()
        self._clicks.clear()
        self.mouse_dx = 0.0
        self.mouse_dy = 0.0

    def wasd_vector(self):
        """Local-space move vector from WASD+QE (the FPS camera contract)."""
        import numpy as np
        v = np.zeros(3, dtype=np.float32)
        if self.is_key_down("w"): v[2] += 1
        if self.is_key_down("s"): v[2] -= 1
        if self.is_key_down("d"): v[0] += 1
        if self.is_key_down("a"): v[0] -= 1
        if self.is_key_down("e"): v[1] += 1
        if self.is_key_down("q"): v[1] -= 1
        return v
