"""Parity of the port's host library (vqengine_tpu_torch/utils/native.py,
csrc/vq_native.cpp) with the JAX package on the CPU: the PNG decode and the
box mip level, bitwise against the port's plain versions (read_png_plain,
scene/texture_manager.mip_box) and the JAX package's read_png and, where its
own native library is built, its png_decode and mip_box.

The PNGs are crafted from a numpy seed by image_io.encode_png, which
filters each row with the filter asked for: colour types 0/2/3/4/6 x the
filters 0-4 alone and all five mixed row by row x sizes 23x37, 1x5 and 5x1.
The library builds here with the host's g++ (a fraction of a second)."""
import shutil
import struct
import subprocess
import sys
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest

from vqengine_tpu.scene import texture_manager as jtm
from vqengine_tpu.utils import image_io as jio
from vqengine_tpu.utils import native as jnative
from vqengine_tpu_torch.scene import texture_manager as ttm
from vqengine_tpu_torch.utils import image_io as tio
from vqengine_tpu_torch.utils import native

COLOR_TYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> channels
FILTERS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]
SIZES = [(23, 37), (1, 5), (5, 1)]


def crafted_png(color_type: int, filters, size, seed: int = 0):
    """-> (PNG bytes, the image it holds as uint8 [H, W, C])."""
    rng = np.random.default_rng(seed)
    h, w = size
    if color_type == 3:
        palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
        idx = rng.integers(0, 200, (h, w), dtype=np.uint8)
        return tio.encode_png(idx, filters, palette=palette), palette[idx]
    img = rng.integers(0, 256, (h, w, COLOR_TYPES[color_type]), dtype=np.uint8)
    return tio.encode_png(img, filters), img


def assert_bitwise(a: np.ndarray, b: np.ndarray, what: str) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("filters", FILTERS,
                         ids=lambda f: "f" + "".join(map(str, f)))
@pytest.mark.parametrize("color_type", sorted(COLOR_TYPES),
                         ids=lambda c: f"ct{c}")
def test_png_decode_matches(color_type, filters, size, tmp_path):
    data, img = crafted_png(color_type, filters, size)
    path = tmp_path / "crafted.png"
    path.write_bytes(data)
    got = native.png_decode(data)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the sub filter wraps silently
        plain = tio.read_png_plain(path)
    assert_bitwise(got, img, "the image encoded")
    assert_bitwise(got, plain, "read_png_plain")
    assert_bitwise(tio.read_png(path), got, "read_png")
    assert_bitwise(jio.read_png(path), got, "the JAX package's read_png")
    if jnative.available():
        assert_bitwise(jnative.png_decode(data), got,
                       "the JAX package's native png_decode")


@pytest.mark.parametrize("shape", [(7, 5, 3), (6, 6), (1, 8, 4), (8, 1, 4),
                                   (3, 3, 4)], ids=str)
def test_mip_box_matches(shape):
    src = np.random.default_rng(1).random(shape).astype(np.float32)
    got = native.mip_box(src)
    want = (max(shape[0] // 2, 1), max(shape[1] // 2, 1)) + shape[2:]
    assert got.shape == want
    assert_bitwise(ttm.mip_box(src), got, "the plain mip_box")
    if jnative.available():
        assert_bitwise(jnative.mip_box(src), got,
                       "the JAX package's native mip_box")


def test_generate_mips_matches():
    """A seeded 256^2 RGBA chain level by level: the port's native chain,
    the plain mip_box's and the JAX package's generate_mips."""
    img = np.random.default_rng(2).random((256, 256, 4)).astype(np.float32)
    got = ttm.generate_mips(img)
    assert [m.shape[0] for m in got] == [256 >> i for i in range(9)]
    plain = [img]
    while plain[-1].shape[0] > 1:
        plain.append(ttm.mip_box(plain[-1]))
    for lv, (a, b, c) in enumerate(zip(got, plain, jtm.generate_mips(img),
                                       strict=True)):
        assert_bitwise(b, a, f"plain level {lv}")
        assert_bitwise(c, a, f"JAX level {lv}")


def test_texture_manager_loads_pngs(tmp_path):
    """create_from_file's workers decode through the library: each slot
    equals the plain decode resized, and a corrupt file fails alone."""
    tm = ttm.TextureManager(size=16, num_workers=4)
    want = []
    for i, ct in enumerate((6, 2, 3, 0)):
        data, _ = crafted_png(ct, FILTERS[-1], (40, 24), seed=10 + i)
        (tmp_path / f"t{i}.png").write_bytes(data)
        want.append(ttm._resize_box(ttm._to_rgba_f32(
            tio.read_png_plain(tmp_path / f"t{i}.png")), 16))
    (tmp_path / "bad.png").write_bytes(
        crafted_png(6, (0, 7), (4, 4))[0])
    ids = [tm.create_from_file(f"t{i}.png", [tmp_path]) for i in range(4)]
    bad = tm.create_from_file("bad.png", [tmp_path])
    tm.wait_all()
    for tid, w in zip(ids, want):
        assert tm.state(tid) == ttm.ETextureState.READY
        assert_bitwise(tm._images[tid], w, f"texture {tid}")
    assert tm.state(bad) == ttm.ETextureState.FAILED


def test_bad_filter_byte_raises(tmp_path):
    data, _ = crafted_png(6, (0, 5), (3, 4))
    with pytest.raises(ValueError, match="filter"):
        native.png_decode(data)
    (tmp_path / "bad.png").write_bytes(data)
    with pytest.raises(ValueError, match="filter"):
        tio.read_png_plain(tmp_path / "bad.png")


def png_of(ihdr: bytes, idat: bytes) -> bytes:
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


ROWS = zlib.compress(bytes(2 * (1 + 2 * 4)))   # 2 rows of 2 RGBA pixels
BAD_PNGS = {
    "not a PNG": b"GIF89a" + bytes(40),
    "short IHDR": png_of(struct.pack(">IIBB", 2, 2, 8, 6), ROWS),
    "no IHDR": b"\x89PNG\r\n\x1a\n",
    "16-bit": png_of(struct.pack(">IIBBBBB", 2, 2, 16, 6, 0, 0, 0), ROWS),
    "interlaced": png_of(struct.pack(">IIBBBBB", 2, 2, 8, 6, 0, 0, 1), ROWS),
    "colour type 5": png_of(struct.pack(">IIBBBBB", 2, 2, 8, 5, 0, 0, 0), ROWS),
    "zero width": png_of(struct.pack(">IIBBBBB", 0, 2, 8, 6, 0, 0, 0), ROWS),
    "corrupt deflate": png_of(struct.pack(">IIBBBBB", 2, 2, 8, 6, 0, 0, 0),
                              ROWS[:-6] + b"\xff" * 6),
    "rows short": png_of(struct.pack(">IIBBBBB", 2, 3, 8, 6, 0, 0, 0), ROWS),
}


@pytest.mark.parametrize("name", sorted(BAD_PNGS))
def test_bad_png_raises(name, tmp_path):
    """A file the decoder cannot take raises ValueError, on both paths."""
    with pytest.raises(ValueError):
        native.png_decode(BAD_PNGS[name])
    (tmp_path / "bad.png").write_bytes(BAD_PNGS[name])
    with pytest.raises(ValueError):
        tio.read_png_plain(tmp_path / "bad.png")


@pytest.mark.parametrize("entry", ["png_decode", "mip_box",
                                   "create_from_file"])
@pytest.mark.parametrize("cxx", ["missing", "failing"])
def test_failed_build_raises(entry, cxx, tmp_path, monkeypatch):
    """No fallback: with the compiler a missing file, or one that fails,
    each entry point raises RuntimeError in its caller."""
    path = (str(tmp_path / "no-such-g++") if cxx == "missing"
            else shutil.which("false"))
    monkeypatch.setattr(native, "compiler", lambda: path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    data, _ = crafted_png(2, (4,), (4, 4))
    (tmp_path / "t.png").write_bytes(data)
    call = {"png_decode": lambda: native.png_decode(data),
            "mip_box": lambda: ttm.generate_mips(np.ones((4, 4, 4), np.float32)),
            "create_from_file": lambda: ttm.TextureManager(size=4)
            .create_from_file("t.png", [tmp_path])}[entry]
    with pytest.raises(RuntimeError, match="vq_native.cpp"):
        call()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="compiler"):
        native.compiler()


def test_native_imports_no_jax():
    code = ("import sys\n"
            "from vqengine_tpu_torch.utils import native\n"
            "native.library()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vqengine_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr
