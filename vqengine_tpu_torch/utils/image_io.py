"""Image IO — PNG read/write (pure python: zlib) and Radiance .hdr support.

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

def write_png(path: str | Path, img: np.ndarray) -> None:
    """img: [H, W], [H, W, 1], [H, W, 3] or [H, W, 4]; uint8 or float in [0,1]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def read_png(path: str | Path) -> np.ndarray:
    """PNG reader: 8-bit, color types 0/2/3/4/6, no interlace.
    Returns uint8 [H, W, C]. (The JAX package's copy also tries its
    native decoder first; the port decodes in Python only.)"""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = bitdepth = color_type = None
    idat = b""
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
            assert bitdepth == 8, f"unsupported bit depth {bitdepth}"
            assert interlace == 0, "interlaced PNG unsupported"
        elif tag == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
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
                line[x] = (line[x] + line[x - channels]) & 0xFF
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
        img = palette[img[:, :, 0]]
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
