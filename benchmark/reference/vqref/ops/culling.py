"""Frustum culling + LOD selection over [N] item tensors.

Counterpart of ``vqengine_tpu/ops/culling.py`` (the reference's CPU cull,
Culling.cpp:153-173, :322-422). Every sum rounds as XLA's CPU backend
rounds the reference's einsums (raster.matvec_fma, raster.world_view_proj),
and the LOD comes from f32 area thresholds found against the reference's
log10, so visibility, LOD and area are bitwise the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .palette import palette_lookup
from .raster import div_true, matvec_fma
from .texture import log_xla


def world_aabbs(world: torch.Tensor, centers: torch.Tensor,
                extents: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Local AABBs through per-item world matrices [N, 4, 4] ->
    (world centers [N, 3], world extents [N, 3])."""
    c = matvec_fma(world[:, :3, :3], centers) + world[:, :3, 3]
    e = matvec_fma(world[:, :3, :3].abs(), extents)
    return c, e


def frustum_cull(world_centers: torch.Tensor, world_extents: torch.Tensor,
                 planes: torch.Tensor) -> torch.Tensor:
    """AABB vs frustum planes [6, 4] (inside: ax+by+cz+d >= 0) -> visible
    mask [N]."""
    d = matvec_fma(planes[:, :3], world_centers) + planes[None, :, 3]
    r = matvec_fma(planes[:, :3].abs(), world_extents)
    return (d + r >= 0.0).all(dim=1)


_SIGNS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]


def projected_bb_area(world_centers: torch.Tensor, world_extents: torch.Tensor,
                      view_proj: torch.Tensor) -> torch.Tensor:
    """NDC bbox area of the 8 projected AABB corners, in [0, 4]."""
    signs = torch.tensor(_SIGNS, dtype=torch.float32, device=world_centers.device)
    corners = world_centers[:, None, :] + signs[None] * world_extents[:, None, :]
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], dim=-1)
    # the reference's einsum "ij,nkj->nki", its four products summed in
    # pairs as XLA sums it on the CPU
    t = [view_proj[:, j] * hom[..., j, None] for j in range(4)]
    clip = (t[0] + t[1]) + (t[2] + t[3])                       # [N, 8, 4]
    w = torch.where(clip[..., 3].abs() > 1e-9, clip[..., 3],
                    torch.full_like(clip[..., 3], 1e-9))
    ndc = clip[..., :2] / w[..., None]
    ext = ndc.amax(dim=1) - ndc.amin(dim=1)
    return ext[..., 0] * ext[..., 1]


# t_j (j = 0..6): the smallest f32 area whose reference LOD
# ceil(-log10(area) - 1) is at most j, as f32 bit patterns. Found by
# bisection over f32 bit patterns against the reference's XLA log10 (which
# rounds otherwise than torch.log10 on about a quarter of f32 inputs);
# tests/test_torch_culling.py finds them again and pins the LOD on both
# sides of each.
LOD_AREA_THRESHOLD_BITS = (0x3DCCCCCB, 0x3C23D707, 0x3A83126C, 0x38D1B70F,
                           0x3727C5AB, 0x358637B8, 0x33D6BF8B)


def lod_area_thresholds(device=None) -> torch.Tensor:
    """t_0..t_6 as an f32 tensor [7]."""
    return torch.tensor(LOD_AREA_THRESHOLD_BITS, dtype=torch.int32,
                        device=device).view(torch.float32)


def lod_from_projected_area(area: torch.Tensor, num_lods: torch.Tensor,
                            max_lods: int = 8) -> torch.Tensor:
    """LOD k while area <= 0.1 * 10^-k, clamped to the mesh's LOD count
    (max_lods <= 8): the count of thresholds t_j above the area, which is
    the reference's clip(ceil(-log10(max(area, 1e-30)) - 1), 0, 7) on
    every f32 area (NaN and inf give 0, as there)."""
    t = lod_area_thresholds(area.device)
    k = (area[..., None] < t).sum(dim=-1).to(torch.int32)
    k = k.clamp(0, max_lods - 1)
    return torch.minimum(k, num_lods - 1)


# XLA folds the reference's log10 (log(x) / log(10)) into a product with
# f32(1 / ln 10)
_INV_LN10 = float(np.float32(1.0 / np.log(10.0)))


def log10_xla(x: torch.Tensor) -> torch.Tensor:
    """The reference's jnp.log10 on the CPU, bit for bit: XLA's f32 log
    (texture.log_xla) times f32(1 / ln 10), for x > 0."""
    return log_xla(x) * _INV_LN10


def tessellation_morph_factor(lod: torch.Tensor, area: torch.Tensor,
                              num_lods: torch.Tensor,
                              window: float = 0.4) -> torch.Tensor:
    """Continuous per-item geomorph factor [N] in [0, 1] (1 = full fine
    detail): with g = -log10(area) - 1 the continuous LOD, level k morphs
    toward its coarser parent over the last `window` of its range (g in
    (k - 1, k]), reaching level k + 1 at g = k; the coarsest level never
    morphs."""
    g = -log10_xla(torch.clamp(area, min=1e-30)) - 1.0
    m = torch.clamp(div_true(lod.to(torch.float32) - g, window), 0.0, 1.0)
    return torch.where(lod >= num_lods - 1, 1.0, m)


def cull_and_select_lod(world: torch.Tensor, centers: torch.Tensor,
                        extents: torch.Tensor, planes: torch.Tensor,
                        view_proj: torch.Tensor, num_lods: torch.Tensor):
    """-> (visible [N] bool, lod [N] int32)."""
    wc, we = world_aabbs(world, centers, extents)
    visible = frustum_cull(wc, we, planes)
    lod = lod_from_projected_area(projected_bb_area(wc, we, view_proj),
                                  num_lods)
    return visible, lod


def triangle_mask_from_items(tri_item: torch.Tensor, tri_lod: torch.Tensor,
                             visible: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
    """Per-triangle active mask: the item is visible and the triangle is
    in the item's selected LOD (one palette lookup of a [N, 2] table)."""
    table = torch.stack([visible.to(torch.float32), lod.to(torch.float32)], dim=1)
    rows = palette_lookup(tri_item, table)
    return (rows[:, 0] > 0.5) & (tri_lod == rows[:, 1].to(torch.int32))
