"""Immediate-mode UI panels — the counterpart of the reference's VQUI
(VQUI.h:36-66, Dear ImGui windows composited by UIPass: F1 scene
controls, F2 profiler, F3 graphics settings, F4 editor). Headless build:
panels draw straight into the finished frame with the bitmap font
(render/hud.py) and are driven by the same Input keys; value edits write
through to live engine state (GraphicsSettings / editor_set_material), so
a changed row re-specializes the next frame's render graph exactly like
toggling a VQUI checkbox re-selects a PSO permutation.

Widget vocabulary: label, checkbox, choice (enum cycler), slider (float
step). Navigation: up/down move the cursor, left/right/enter change the
focused row, F-key closes. All drawing is numpy on the readback frame —
UI cost is host-side and zero when no panel is open (UIPass is likewise
skipped when ImGui has no windows)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from .hud import stamp_text

PANEL_BG = np.asarray([0.08, 0.09, 0.12], np.float32)
PANEL_TITLE = np.asarray([0.16, 0.2, 0.3], np.float32)
ROW_FOCUS = np.asarray([0.25, 0.32, 0.5], np.float32)
TEXT = (0.92, 0.92, 0.95)
TEXT_DIM = (0.65, 0.65, 0.7)
TEXT_VAL = (1.0, 0.85, 0.4)
ROW_H = 10


@dataclass
class Widget:
    """One panel row. kind: 'label' | 'check' | 'choice' | 'slider'.
    get/set read and write the live value; choices lists enum names."""
    text: str
    kind: str = "label"
    get: Callable[[], Any] | None = None
    set: Callable[[Any], None] | None = None
    choices: list[str] | None = None
    step: float = 0.05
    lo: float = 0.0
    hi: float = 1.0

    def value_str(self) -> str:
        if self.get is None:
            return ""
        v = self.get()
        if self.kind == "check":
            return "[x]" if v else "[ ]"
        if self.kind == "choice":
            return f"< {self.choices[int(v) % len(self.choices)]} >"
        if self.kind == "slider":
            return f"{float(v):.2f}"
        return str(v)

    def adjust(self, direction: int) -> None:
        """left/right/enter on the focused row."""
        if self.get is None or self.set is None:
            return
        v = self.get()
        if self.kind == "check":
            self.set(not bool(v))
        elif self.kind == "choice":
            self.set((int(v) + direction) % len(self.choices))
        elif self.kind == "slider":
            self.set(float(np.clip(float(v) + direction * self.step,
                                   self.lo, self.hi)))


@dataclass
class Panel:
    title: str
    widgets: list[Widget] = field(default_factory=list)
    cursor: int = 0

    def interactive_rows(self) -> list[int]:
        return [i for i, w in enumerate(self.widgets) if w.kind != "label"]

    def move_cursor(self, delta: int) -> None:
        rows = self.interactive_rows()
        if not rows:
            return
        if self.cursor not in rows:
            self.cursor = rows[0]
            return
        i = rows.index(self.cursor)
        self.cursor = rows[(i + delta) % len(rows)]

    def adjust(self, direction: int) -> None:
        if 0 <= self.cursor < len(self.widgets):
            self.widgets[self.cursor].adjust(direction)


def _fill(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
          color: np.ndarray, alpha: float = 0.85) -> None:
    h, w = img.shape[:2]
    x0, x1 = max(0, x0), min(w, x1)
    y0, y1 = max(0, y0), min(h, y1)
    if x1 <= x0 or y1 <= y0:
        return
    img[y0:y1, x0:x1] = (img[y0:y1, x0:x1] * (1 - alpha)
                         + color[None, None] * alpha)


def draw_panel(img: np.ndarray, panel: Panel, x: int = 8,
               y: int = 16) -> np.ndarray:
    """Composite the panel onto img [H,W,3] float; returns a new array."""
    img = np.array(img, copy=True)
    wpx = max(180, 8 + max((len(w.text) + len(w.value_str()) + 4) * 6
                           for w in panel.widgets) if panel.widgets else 180)
    hpx = ROW_H + 6 + ROW_H * len(panel.widgets)
    _fill(img, x, y, x + wpx, y + hpx, PANEL_BG)
    _fill(img, x, y, x + wpx, y + ROW_H + 2, PANEL_TITLE, alpha=0.95)
    img = stamp_text(img, panel.title, x + 4, y + 3, color=TEXT)
    ry = y + ROW_H + 4
    for i, wd in enumerate(panel.widgets):
        if i == panel.cursor and wd.kind != "label":
            _fill(img, x + 1, ry - 1, x + wpx - 1, ry + ROW_H - 2,
                  ROW_FOCUS, alpha=0.9)
        col = TEXT if wd.kind != "label" else TEXT_DIM
        img = stamp_text(img, wd.text, x + 4, ry, color=col)
        val = wd.value_str()
        if val:
            img = stamp_text(img, val, x + wpx - 6 * len(val) - 4, ry,
                             color=TEXT_VAL)
        ry += ROW_H
    return img


# ---------------------------------------------------------------------------
# the four VQUI windows (VQUI.h:36-66), built against live engine state
# ---------------------------------------------------------------------------

def build_controls_panel() -> Panel:
    """F1: scene controls / key bindings (the reference's controls help)."""
    rows = [
        "WASD+mouse  camera",
        "1..9        switch camera",
        "PgUp/PgDn   environment map",
        "click       pick object",
        "V           cycle draw mode",
        "M           magnifier",
        "F2/F3/F4    profiler/settings/editor",
    ]
    return Panel("CONTROLS (F1)", [Widget(r) for r in rows])


def build_profiler_panel(engine) -> Panel:
    ft = engine._frame_times
    ms = (float(np.mean(ft)) * 1e3) if ft else 0.0
    stats = engine.renderer.stats
    rows = [
        f"frame {engine.num_ticks}   {ms:.2f} ms",
        f"tris {stats.num_draws}",
        f"frames rendered {stats.num_frames_rendered}",
        f"last frame {stats.last_frame_ms:.1f} ms",
        f"scene {engine.scene_name}",
    ]
    return Panel("PROFILER (F2)", [Widget(r) for r in rows])


def build_settings_panel(engine) -> Panel:
    """F3: graphics settings — edits write straight into GraphicsSettings;
    the next frame re-specializes the render graph (the PSO-permutation
    re-select a VQUI toggle causes)."""
    g = engine.gfx

    def gset(name):
        def _set(v):
            setattr(g, name, v)
        return _set

    ssao_levels = ["low", "medium", "high"]
    filters = ["esm", "pcf"]
    return Panel("GRAPHICS SETTINGS (F3)", [
        Widget("MSAA 4x", "check", lambda: g.bAntiAliasing,
               gset("bAntiAliasing")),
        Widget("Ambient occlusion", "check", lambda: g.bAmbientOcclusion,
               gset("bAmbientOcclusion")),
        Widget("Reflections (SSR)", "check",
               lambda: bool(g.Reflections),
               lambda v: setattr(g, "Reflections", int(v))),
        Widget("Motion vectors", "check", lambda: g.bMotionVectors,
               gset("bMotionVectors")),
        Widget("HDR output", "check", lambda: g.bHDR, gset("bHDR")),
        Widget("Shadow filter", "choice",
               lambda: filters.index(getattr(g, "ShadowFilter", "esm")),
               lambda v: setattr(g, "ShadowFilter", filters[int(v)]),
               choices=filters),
        Widget("SSAO quality", "choice",
               lambda: ssao_levels.index(
                   getattr(g, "SSAOQuality", "medium")),
               lambda v: setattr(g, "SSAOQuality", ssao_levels[int(v)]),
               choices=ssao_levels),
        Widget("Render scale", "slider", lambda: g.RenderScale,
               gset("RenderScale"), step=0.25, lo=0.5, hi=1.0),
        Widget("Draw mode", "choice", lambda: engine.draw_mode,
               lambda v: setattr(engine, "draw_mode", int(v)),
               choices=["off", "depth", "normals", "ao", "motion",
                        "roughness", "metallic", "objectid", "lit"]),
    ])


def build_editor_panel(engine) -> Panel:
    """F4: editor — material of the picked object, live-tweaked through
    engine.editor_set_material (the VQUI editor panels' write path)."""
    sel = engine.selected_object
    widgets = [Widget(f"selected object: {sel}")]
    mat_name = engine.editor_material_of_object(sel) if sel >= 0 else None
    if mat_name is None:
        widgets.append(Widget("(click an object to edit)"))
        return Panel("EDITOR (F4)", widgets)
    widgets.append(Widget(f"material: {mat_name}"))

    def mat_get(key, idx=0):
        def _get():
            v = engine.editor_get_material(mat_name, key)
            return float(v[idx]) if np.ndim(v) else float(v)
        return _get

    def mat_set(key):
        def _set(v):
            engine.editor_set_material(mat_name, **{key: float(v)})
        return _set

    for key in ("roughness", "metalness", "emissive_intensity"):
        widgets.append(Widget(key, "slider", mat_get(key), mat_set(key),
                              step=0.1, lo=0.0,
                              hi=1.0 if key != "emissive_intensity" else 10.0))
    return Panel("EDITOR (F4)", widgets)
