"""Image IO — PNG read/write (zlib; the decode's row unfilter in C++,
utils/native.py) and Radiance .hdr support.

Counterpart of the reference's stb_image usage (VQUtils Image, used by
TextureManager.cpp) and the screenshot/readback paths. No external image
libraries are required.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> channels


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filters=(0,), palette=None,
               strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """PNG bytes of uint8 [H, W], [H, W, 1], [H, W, 2], [H, W, 3] or
    [H, W, 4]; row y filtered with filters[y % len(filters)] (0 none,
    1 sub, 2 up, 3 average, 4 Paeth; any other byte is written as it is,
    with the row unfiltered: a corrupt PNG). With palette ([K, 3] uint8) the
    image holds palette indices ([H, W]) and is written as colour type 3.
    The rows deflate at level 6 with the zlib strategy given (zlib.Z_RLE
    compresses filtered rows several times faster than the default)."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[c]
    cur = img.reshape(h, w * c).astype(np.int16)
    ft = np.resize(np.asarray(filters, np.uint8), h)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = ft
    rows[:, 1:] = cur
    for f in {1, 2, 3, 4} & set(ft.tolist()):
        r = np.flatnonzero(ft == f)
        x = cur[r]
        b = np.where((r > 0)[:, None], cur[r - 1], np.int16(0))
        a = np.zeros_like(x)
        a[:, c:] = x[:, :-c]
        if f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            ul = np.zeros_like(b)
            ul[:, c:] = b[:, :-c]
            pred = _paeth(a, b, ul)
        rows[r, 1:] = ((x - pred) & 0xFF).astype(np.uint8)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    deflate = zlib.compressobj(6, zlib.DEFLATED, 15, 8, strategy)
    plte = (chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
            if palette is not None else b"")
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr) + plte
            + chunk(b"IDAT", deflate.compress(rows.tobytes()) + deflate.flush())
            + chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray) -> None:
    """img: [H, W], [H, W, 1], [H, W, 3] or [H, W, 4]; uint8 or float in [0,1]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Path(path).write_bytes(encode_png(img))


def parse_png(data: bytes):
    """The chunk walk and the inflate of an 8-bit, non-interlaced PNG of
    colour type 0, 2, 3, 4 or 6 -> (w, h, color_type, palette, raw):
    palette the PLTE chunk's bytes (b"" without one), raw the inflated
    stream of h rows of (filter byte, w * channels bytes). Raises
    ValueError on a file it cannot decode."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    ihdr = None
    idat = []
    palette = b""
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"IHDR chunk of {len(body)} bytes, not 13")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, bitdepth, color_type, _, _, interlace = ihdr
    if w == 0 or h == 0:
        raise ValueError(f"PNG of {w}x{h} pixels")
    if bitdepth != 8:
        raise ValueError(f"unsupported bit depth {bitdepth}")
    if interlace != 0:
        raise ValueError("interlaced PNG unsupported")
    if color_type not in CHANNELS:
        raise ValueError(f"unsupported colour type {color_type}")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    if len(raw) != (w * CHANNELS[color_type] + 1) * h:
        raise ValueError(f"PNG data holds {len(raw)} bytes, not the "
                         f"{(w * CHANNELS[color_type] + 1) * h} of {w}x{h}")
    return w, h, color_type, palette, raw


def palette768(palette: bytes) -> np.ndarray:
    """The PLTE chunk's first 256 entries as 768 bytes, zero past its end
    (an index past the palette decodes as black)."""
    out = np.zeros(768, np.uint8)
    body = np.frombuffer(palette[:768], np.uint8)
    out[:len(body)] = body
    return out


def read_png(path: str | Path) -> np.ndarray:
    """PNG reader: 8-bit, color types 0/2/3/4/6, no interlace.
    Returns uint8 [H, W, C] (palette images as RGB). Decodes through the
    port's C++ unfilter (utils/native.py, built at first use: a failed build
    raises RuntimeError); a file it cannot decode raises ValueError."""
    from .native import png_decode
    return png_decode(Path(path).read_bytes())


def read_png_plain(path: str | Path) -> np.ndarray:
    """read_png's plain Python version (the tests and the smoke hold the
    native decoder against it)."""
    w, h, color_type, palette, raw = parse_png(Path(path).read_bytes())
    channels = CHANNELS[color_type]
    stride = w * channels
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], dtype=np.uint8).copy()
        pos += 1 + stride
        if ft == 0:
            pass
        elif ft == 1:  # sub
            for x in range(channels, stride):
                line[x] = (int(line[x]) + int(line[x - channels])) & 0xFF
        elif ft == 2:  # up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ft == 3:  # average
            for x in range(stride):
                a = int(line[x - channels]) if x >= channels else 0
                line[x] = (int(line[x]) + ((a + int(prev[x])) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for x in range(stride):
                a = int(line[x - channels]) if x >= channels else 0
                b = int(prev[x])
                c = int(out[y - 1, x - channels]) if (x >= channels and y > 0) else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ft}")
        out[y] = line
        prev = line
    img = out.reshape(h, w, channels)
    if color_type == 3:
        img = palette768(palette).reshape(256, 3)[img[:, :, 0]]
    return img


# ---------------------------------------------------------------------------
# Radiance HDR (.hdr) — the reference's HDRI environment map format
# (Data/Textures/HDRI/*.hdr; loaded via stb_image in the reference)
# ---------------------------------------------------------------------------

def read_hdr(path: str | Path) -> np.ndarray:
    """Read a Radiance RGBE .hdr file -> float32 [H, W, 3] linear."""
    data = Path(path).read_bytes()
    # header
    end = data.find(b"\n\n")
    if end < 0:
        raise ValueError("bad hdr header")
    pos = end + 2
    dim_end = data.find(b"\n", pos)
    dims = data[pos:dim_end].split()
    # expect: -Y H +X W
    h, w = int(dims[1]), int(dims[3])
    pos = dim_end + 1
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    for y in range(h):
        # check for RLE scanline
        if data[pos] == 2 and data[pos + 1] == 2 and (data[pos + 2] << 8 | data[pos + 3]) == w:
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]; pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(data[pos:pos + count], dtype=np.uint8)
                        pos += count
                        x += count
        else:  # flat scanline
            row = np.frombuffer(data[pos:pos + 4 * w], dtype=np.uint8).reshape(w, 4)
            rgbe[y] = row
            pos += 4 * w
    exp = rgbe[:, :, 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[:, :, :3].astype(np.float32) + 0.5) * scale[:, :, None] * np.where(exp[:, :, None] == 0, 0, 1)


def write_hdr(path: str | Path, img: np.ndarray) -> None:
    """Write float32 [H, W, 3] linear to a flat (non-RLE) Radiance .hdr."""
    img = np.asarray(img, dtype=np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=2)
    exp = np.zeros((h, w), dtype=np.int32)
    mant = np.zeros_like(maxc)
    nz = maxc > 1e-32
    exp[nz] = np.ceil(np.log2(maxc[nz])).astype(np.int32) + 1
    scale = np.ldexp(1.0, -exp + 8).astype(np.float32)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[:, :, :3] = np.clip(img * scale[:, :, None], 0, 255).astype(np.uint8)
    rgbe[:, :, 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    Path(path).write_bytes(header + rgbe.tobytes())
    del mant
