"""ctypes binding of the port's host library (``csrc/vq_native.cpp``): the
PNG row unfilter and the 2x2 box mip level.

Counterpart of ``vqengine_tpu/utils/native.py``. The library is compiled
with the host's C++ compiler (``g++``, else ``c++``) on first use, never at
import, into ``_build/`` next to the package, keyed by a hash of the
compiler, its flags and the source. There is no fallback: a missing
compiler or a failed build raises RuntimeError, and a PNG the decoder
cannot take raises ValueError. A call into the library releases the GIL,
so TextureManager's decode workers overlap.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from .image_io import CHANNELS, palette768, parse_png

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "vq_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# no -march=native and no contraction: the mip's sum order is its result
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-ffp-contract=off", "-Wall")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_seconds: float | None = None   # the last build's; 0.0 when cached


def compiler() -> str:
    """The host's C++ compiler."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH: the "
                       "port's host library (csrc/vq_native.cpp) cannot build")


def _run(cmd: list[str], what: str) -> subprocess.CompletedProcess:
    """Run the compiler; a failure raises RuntimeError with its stderr."""
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{what}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{what} ({res.returncode}):\n{res.stderr}")
    return res


def build() -> Path:
    """Compile ``csrc/vq_native.cpp`` into ``_build/``, cached by a hash of
    the compiler (its ``-v`` report: version and target), the flags and the
    source; a pid-suffixed temporary file is moved into place, so processes
    building at once do not collide."""
    global build_seconds
    cxx = compiler()
    what = f"{cxx} cannot build {SOURCE.name}"
    ident = _run([cxx, "-v"], what)
    h = hashlib.sha256("\n".join((ident.stdout, ident.stderr,
                                   *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libvq_native_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        build_seconds = 0.0
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        _run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], what)
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The host library, built and loaded on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.vq_png_unfilter.restype = ctypes.c_int
            lib.vq_png_unfilter.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.vq_mip_box.restype = None
            lib.vq_mip_box.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
            _lib = lib
        return _lib


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit, colour types 0/2/3/4/6, non-interlaced) -> uint8
    [H, W, C]; a paletted image comes out as RGB. Raises ValueError on a
    file it cannot decode."""
    lib = library()
    w, h, color_type, palette, raw = parse_png(data)
    channels = CHANNELS[color_type]
    pal = palette768(palette) if color_type == 3 else None
    out = np.empty((h, w, 3 if pal is not None else channels), np.uint8)
    rc = lib.vq_png_unfilter(
        raw, w, h, channels,
        None if pal is None else pal.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p))
    if rc == -6:
        raise ValueError("bad PNG filter byte")
    if rc != 0:
        raise MemoryError(f"vq_png_unfilter returned {rc}")
    return out


def mip_box(src: np.ndarray) -> np.ndarray:
    """One box-filtered mip level of f32 [H, W, C] or [H, W] -> [max(H // 2,
    1), max(W // 2, 1)(, C)]: each texel 0.25 * (((a + b) + c) + d), the
    last row and column clamped on a side of 1."""
    lib = library()
    src = np.ascontiguousarray(src, dtype=np.float32)
    if src.ndim not in (2, 3) or src.size == 0:
        raise ValueError(f"mip_box takes a non-empty [H, W] or [H, W, C] "
                         f"image, not {src.shape}")
    h, w = src.shape[:2]
    c = src.shape[2] if src.ndim == 3 else 1
    dst = np.empty((max(h // 2, 1), max(w // 2, 1), c), dtype=np.float32)
    lib.vq_mip_box(src.ctypes.data_as(ctypes.c_void_p), h, w, c,
                   dst.ctypes.data_as(ctypes.c_void_p))
    return dst if src.ndim == 3 else dst[:, :, 0]
