"""The reference's stand-in for the port's host library: the levels the
benchmark renders load no texture file, so PNG decoding raises; the 2x2
box mip is the plain numpy version (scene/texture_manager.mip_box)."""
from __future__ import annotations

import numpy as np


def library() -> None:
    raise RuntimeError("the reference decodes no texture file")


def png_decode(data: bytes) -> np.ndarray:
    raise RuntimeError("the reference decodes no texture file")


def mip_box(src: np.ndarray) -> np.ndarray:
    from ..scene.texture_manager import mip_box as plain
    return plain(src)
