"""Debug visualization passes — counterpart of
``vqengine_tpu/ops/visualization.py``: Visualization.hlsl (the draw-mode
debug views: depth/normals/roughness/metallic/AO/motion/object id,
SceneRendering.cpp:2541-2576), Magnifier.hlsl (the screen-space lens,
MagnifierPass.{h,cpp}) and Outline.hlsl (the selected object's outline,
OutlinePass.{h,cpp}; the stencil becomes an object-id mask).

Rounded as the reference rounds op by op on the CPU: jnp.power is glibc's
powf (colorspace.powf), its sqrt is correctly rounded (shadow._sqrt), a
division by a Python number divides once (raster.div_true) and the
object-id hash multiplies in uint32 (here in int64, masked to 32 bits).
"""
from __future__ import annotations

import torch

from ..utils import trace
from .colorspace import powf
from .ffx import _f32
from .raster import div_true
from .shadow import _sqrt
from .ssr import _trunc_index

# EDrawMode analog (reference Settings.h / VQUI draw modes)
DRAW_MODE_LIT = 0
DRAW_MODE_DEPTH = 1
DRAW_MODE_NORMALS = 2
DRAW_MODE_ROUGHNESS = 3
DRAW_MODE_METALLIC = 4
DRAW_MODE_AO = 5
DRAW_MODE_ALBEDO = 6
DRAW_MODE_MOTION_VECTORS = 7
DRAW_MODE_OBJECT_ID = 8


def _id_hash(oid: torch.Tensor, k: int) -> torch.Tensor:
    """(oid * k mod 2^32) % 255 / 255 for 0 <= oid < 2^31 and k < 2^32: the
    reference's uint32 product, exact in int64 (k * oid < 2^63)."""
    v = ((oid * k) & 0xFFFFFFFF) % 255
    return div_true(v.to(torch.float32), 255.0)


def visualize(mode: int, ldr: torch.Tensor,
              depth: torch.Tensor | None = None,
              normals: torch.Tensor | None = None,
              roughness: torch.Tensor | None = None,
              metalness: torch.Tensor | None = None,
              ao: torch.Tensor | None = None,
              albedo: torch.Tensor | None = None,
              motion: torch.Tensor | None = None,
              object_id: torch.Tensor | None = None) -> torch.Tensor:
    """Debug-view CS equivalent: convert G-buffer channels to a displayable
    image (Visualization.hlsl behavior); a mode whose channel is not given
    returns ldr."""
    if mode == DRAW_MODE_LIT:
        return ldr
    if mode == DRAW_MODE_DEPTH and depth is not None:
        # near = white, far = black, like the reference
        d = torch.clamp(1.0 - depth, 0.0, 1.0)
        d = powf(d, 0.25)
        return torch.stack([d, d, d], dim=-1)
    if mode == DRAW_MODE_NORMALS and normals is not None:
        return normals * 0.5 + 0.5
    if mode == DRAW_MODE_ROUGHNESS and roughness is not None:
        return torch.stack([roughness] * 3, dim=-1)
    if mode == DRAW_MODE_METALLIC and metalness is not None:
        return torch.stack([metalness] * 3, dim=-1)
    if mode == DRAW_MODE_AO and ao is not None:
        return torch.stack([ao] * 3, dim=-1)
    if mode == DRAW_MODE_ALBEDO and albedo is not None:
        return albedo
    if mode == DRAW_MODE_MOTION_VECTORS and motion is not None:
        m = torch.clamp(motion * 8.0 + 0.5, 0.0, 1.0)
        return torch.cat([m, torch.full_like(m[..., :1], 0.5)], dim=-1)
    if mode == DRAW_MODE_OBJECT_ID and object_id is not None:
        oid = torch.clamp(object_id, min=0).long()
        rgb = torch.stack([_id_hash(oid, 2654435761), _id_hash(oid, 40503),
                           _id_hash(oid, 69069)], dim=-1)
        return torch.where((object_id < 0)[..., None], 0.0, rgb)
    return ldr


def magnifier(img: torch.Tensor, center_uv=(0.5, 0.5), radius: float = 0.15,
              magnification: float = 3.0,
              border_color=(1.0, 0.8, 0.1), border_px: int = 2,
              record: dict | None = None) -> torch.Tensor:
    """Magnifier lens (Magnifier.hlsl): pixels inside the lens circle sample
    the source at reduced offsets from the lens center. record (a dict)
    receives the source texel tx, ty and the masks inside and ring."""
    h, w = img.shape[:2]
    dev = img.device
    ys = div_true(torch.arange(h, dtype=torch.float32, device=dev)[:, None]
                  + 0.5, float(h))
    xs = div_true(torch.arange(w, dtype=torch.float32, device=dev)[None, :]
                  + 0.5, float(w))
    cx, cy = (_f32(v) for v in center_uv)
    dx = xs - cx
    dy = ys - cy
    # circular in screen aspect: scale x by aspect
    ax = dx * _f32(w / h)
    dist = _sqrt(ax * ax + dy * dy)
    inside = dist < _f32(radius)

    su = div_true(dx, float(magnification)) + cx
    sv = div_true(dy, float(magnification)) + cy
    tx = _trunc_index(su * float(w), w)
    ty = _trunc_index(sv * float(h), h)
    magnified = img.reshape(-1, img.shape[-1])[(ty * w + tx).long()]
    out = torch.where(inside[..., None], magnified, img)
    ring = (dist >= _f32(radius)) & (dist < _f32(radius + border_px / h))
    if record is not None:
        record.update(tx=tx.expand(h, w), ty=ty.expand(h, w),
                      inside=inside, ring=ring)
    with trace.blocking("visualization.color"):
        border = torch.tensor(border_color, dtype=torch.float32, device=dev)
    return torch.where(ring[..., None], border, out)


def outline(img: torch.Tensor, object_id: torch.Tensor, selected: int,
            color=(1.0, 0.6, 0.1), thickness: int = 2,
            record: dict | None = None) -> torch.Tensor:
    """Selected-object outline (Outline.hlsl: stencil grow): dilate the
    selection mask and draw the rim. record (a dict) receives the rim."""
    mask = object_id == selected
    grown = mask
    for _ in range(thickness):
        g = grown
        g = g | torch.roll(g, 1, 0) | torch.roll(g, -1, 0)
        g = g | torch.roll(g, 1, 1) | torch.roll(g, -1, 1)
        grown = g
    rim = grown & ~mask
    if record is not None:
        record["rim"] = rim
    with trace.blocking("visualization.color"):
        c = torch.tensor(color, dtype=torch.float32, device=img.device)
    return torch.where(rim[..., None], c, img)
