"""Headless HUD — the counterpart of the reference's ImGui overlay
(Source/Engine/UI/VQUI.cpp: Scene Controls F1, Profiler F2, Graphics
Settings F3) for a display-less runtime: a tiny bitmap-font text stamper
that renders the profiler stats into the frame, plus the loading-screen
blit (LoadingScreenRendering.cpp: fullscreen blit of a PNG while async
loads run).
"""
from __future__ import annotations

import numpy as np

# 5x7 bitmap font, columns LSB=top; covers the profiler HUD's character set
_FONT = {
    "0": "3E 51 49 45 3E", "1": "00 42 7F 40 00", "2": "42 61 51 49 46",
    "3": "21 41 45 4B 31", "4": "18 14 12 7F 10", "5": "27 45 45 45 39",
    "6": "3C 4A 49 49 30", "7": "01 71 09 05 03", "8": "36 49 49 49 36",
    "9": "06 49 49 29 1E", "A": "7E 11 11 11 7E", "B": "7F 49 49 49 36",
    "C": "3E 41 41 41 22", "D": "7F 41 41 22 1C", "E": "7F 49 49 49 41",
    "F": "7F 09 09 09 01", "G": "3E 41 49 49 7A", "H": "7F 08 08 08 7F",
    "I": "00 41 7F 41 00", "J": "20 40 41 3F 01", "K": "7F 08 14 22 41",
    "L": "7F 40 40 40 40", "M": "7F 02 0C 02 7F", "N": "7F 04 08 10 7F",
    "O": "3E 41 41 41 3E", "P": "7F 09 09 09 06", "Q": "3E 41 51 21 5E",
    "R": "7F 09 19 29 46", "S": "46 49 49 49 31", "T": "01 01 7F 01 01",
    "U": "3F 40 40 40 3F", "V": "1F 20 40 20 1F", "W": "3F 40 38 40 3F",
    "X": "63 14 08 14 63", "Y": "07 08 70 08 07", "Z": "61 51 49 45 43",
    " ": "00 00 00 00 00", ".": "00 60 60 00 00", ":": "00 36 36 00 00",
    "/": "20 10 08 04 02", "-": "08 08 08 08 08", "%": "23 13 08 64 62",
    "(": "00 1C 22 41 00", ")": "00 41 22 1C 00", ",": "00 50 30 00 00",
    "[": "00 7F 41 41 00", "]": "00 41 41 7F 00", "=": "14 14 14 14 14",
    "m": "7C 04 18 04 78", "s": "48 54 54 54 20", "x": "44 28 10 28 44",
    "f": "08 7E 09 01 02", "p": "7C 14 14 14 08", "t": "04 3F 44 40 20",
}


def _glyph(ch: str) -> np.ndarray:
    cols = _FONT.get(ch) or _FONT.get(ch.upper()) or _FONT[" "]
    out = np.zeros((7, 5), dtype=bool)
    for x, tok in enumerate(cols.split()):
        v = int(tok, 16)
        for y in range(7):
            out[y, x] = (v >> y) & 1
    return out


def stamp_text(img: np.ndarray, text: str, x: int, y: int,
               color=(1.0, 1.0, 1.0), scale: int = 1,
               shadow: bool = True) -> np.ndarray:
    """Stamp text into img [H, W, 3] (float). Returns img (modified copy)."""
    img = np.array(img, copy=True)
    h, w = img.shape[:2]
    cx = x
    col = np.asarray(color, np.float32)
    for ch in text:
        g = _glyph(ch)
        if scale > 1:
            g = np.repeat(np.repeat(g, scale, 0), scale, 1)
        gh, gw = g.shape
        if cx + gw >= w or y + gh >= h:
            break
        region = img[y:y + gh, cx:cx + gw]
        if shadow:
            sy, sx = y + 1, cx + 1
            if sy + gh < h and sx + gw < w:
                sh_reg = img[sy:sy + gh, sx:sx + gw]
                sh_reg[g] = sh_reg[g] * 0.2
        region[g] = col
        img[y:y + gh, cx:cx + gw] = region
        cx += gw + scale
    return img


def draw_profiler_hud(img: np.ndarray, stats: dict) -> np.ndarray:
    """The F2 profiler window's content as a corner overlay."""
    lines = []
    if "fps" in stats:
        lines.append(f"FPS {stats['fps']:.1f}  {stats.get('ms', 0):.2f} ms")
    if "tris" in stats:
        lines.append(f"TRIS {stats['tris']}")
    if "scene" in stats:
        lines.append(f"{stats['scene']}".upper())
    if "frame" in stats:
        lines.append(f"FRAME {stats['frame']}")
    y = 4
    for line in lines:
        img = stamp_text(img, line, 4, y, color=(1.0, 0.9, 0.3))
        y += 9
    return img


def loading_screen(width: int, height: int, data_dirs=()) -> np.ndarray:
    """Fullscreen loading-screen blit (LoadingScreenRendering.cpp:161):
    picks a PNG from Data/Textures/LoadingScreen, letterboxed; falls back
    to a dark gradient with a LOADING stamp."""
    from pathlib import Path

    from ..utils.image_io import read_png
    img = None
    for d in data_dirs:
        screens = sorted(Path(d, "Textures", "LoadingScreen").glob("*.png"))
        if screens:
            try:
                img = read_png(screens[0]).astype(np.float32) / 255.0
                break
            except (OSError, ValueError):  # unreadable: the gradient below
                pass
    if img is None:
        g = np.linspace(0.02, 0.12, height, dtype=np.float32)
        img = np.broadcast_to(g[:, None, None], (height, width, 3)).copy()
    else:
        ys = (np.arange(height) * img.shape[0] // height)
        xs = (np.arange(width) * img.shape[1] // width)
        img = img[ys][:, xs, :3]
    return stamp_text(img, "LOADING", width // 2 - 20, height - 16,
                      color=(1.0, 1.0, 1.0))
