"""Per-sample MSAA edge resolve — counterpart of ``vqengine_tpu/ops/msaa.py``
(the reference's ResolveMSAA, which averages 4 shaded samples).

The G-buffer raster (kernel K1, MSAA variant) keeps one winner per pixel
plus per-sample sticky coverage, so shading stays one dense pass. Pixels
whose samples split between two distinct surfaces are then (1) detected
from the winners of the 4 neighbors, (2) compacted (ops/sparse.py), and
(3) re-tested per sample against the candidate records {own winner} and
the 4 neighbor winners (raster.eval_record_planes, the kernel's coverage
test), which gives each edge pixel one secondary surface and the number
of samples it wins. The caller shades or fetches the secondary color and
blends by those counts (render/graph.py).
"""
from __future__ import annotations

import torch

from . import raster
from . import sparse

# NDC-depth gap above which two adjacent winners count as distinct
# surfaces; different objects count regardless of the gap
EDGE_Z_TOL = 2e-3

NEIGHBOR_OFFSETS = ((0, 1), (0, -1), (1, 0), (-1, 0))

# capacity ladder of the edge compaction: rung k keeps pixels with more
# than k distinct neighbors; the top rung (4.0) keeps none, so a frame
# whose edges exceed the capacity resolves its strongest edges instead of
# truncating in raster order
EDGE_THRS = (0.5, 1.5, 2.5, 3.5, 4.0)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The neighbor image, img[clamp(y + dy), clamp(x + dx)] (edge-clamped
    borders), for [H, W, ...] images."""
    h, w = img.shape[:2]
    rows = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img[rows][:, cols]


def detect_edge_score(tri_id: torch.Tensor, depth: torch.Tensor,
                      object_id: torch.Tensor, mask: torch.Tensor,
                      z_tol: float = EDGE_Z_TOL) -> torch.Tensor:
    """[H, W] f32 in {0..4}: how many of a pixel's 4 neighbors hold a
    distinct surface (another triangle of another object, or across a depth
    gap above z_tol); 0 off the mask. The capacity ladder's score."""
    score = torch.zeros(tri_id.shape, dtype=torch.float32, device=tri_id.device)
    for dy, dx in NEIGHBOR_OFFSETS:
        nb_id = _shift(tri_id, dy, dx)
        nb_obj = _shift(object_id, dy, dx)
        nb_z = _shift(depth, dy, dx)
        nb_mask = _shift(mask, dy, dx)
        differs = (nb_id != tri_id) & nb_mask & (
            (nb_obj != object_id) | ((nb_z - depth).abs() > z_tol))
        score = score + differs.to(torch.float32)
    return torch.where(mask, score, torch.zeros_like(score))


def detect_edges(tri_id: torch.Tensor, depth: torch.Tensor,
                 object_id: torch.Tensor, mask: torch.Tensor,
                 z_tol: float = EDGE_Z_TOL) -> torch.Tensor:
    """[H, W] bool: pixels with any distinct neighbor."""
    return detect_edge_score(tri_id, depth, object_id, mask, z_tol) > 0.5


def resolve_secondary(records: torch.Tensor, tri_id: torch.Tensor,
                      depth: torch.Tensor, object_id: torch.Tensor,
                      mask: torch.Tensor, cov_s: torch.Tensor, cap: int,
                      pad: int = 0, telemetry: dict | None = None,
                      choose=None, y_offset: int = 0):
    """Per-sample visibility at edge pixels.

    records [T, R] packed records (raster.pack_records); tri_id, depth,
    object_id, mask [H, W]; cov_s [4, H, W] the kernel's per-sample sticky
    coverage. pad > 0: tri_id/depth/object_id/mask carry `pad` halo rows at
    top and bottom (a band of a larger frame); cov_s and the returned
    indices stay interior; y_offset: the band's first row in the frame
    whose records these are (they are evaluated at frame rows).

    -> (idx [cap] int64 flat pixel indices, live [cap] bool, sec_id [cap]
    int32 the secondary winner (own id where none), n_sec [cap] f32 the
    samples it wins (0..4), px, py [cap] pixel centers). A sample whose
    best candidate is the own winner, or that no candidate covers, stays
    with the primary; py is at the frame's row. telemetry gets
    "msaa_edges" (demand at the chosen rung / cap) and "msaa_edges_demand"
    (base-rung demand / cap). choose, when given, picks the edge-score
    threshold from the score [H, W] in place of the ladder's rung that
    fits cap (the multi-GPU bands choose the whole frame's rung)."""
    def interior(img):
        return img[pad:img.shape[0] - pad] if pad else img

    h, w = interior(tri_id).shape
    score = interior(detect_edge_score(tri_id, depth, object_id, mask))
    thr = (sparse.adaptive_threshold(score, EDGE_THRS, cap, block=8)[0]
           if choose is None else choose(score))
    edge = score > thr
    idx, count, demand = sparse.compact_indices(edge, cap, block=8)
    if telemetry is not None:
        telemetry["msaa_edges"] = raster.div_true(demand.to(torch.float32), cap)
        telemetry["msaa_edges_demand"] = raster.div_true(sparse.block_count(
            score > EDGE_THRS[0], 8).to(torch.float32) * 8, cap)
    lane = torch.arange(cap, device=idx.device)
    live = sparse.gather_pixels(edge, idx) & (lane < count)

    own = sparse.gather_pixels(interior(tri_id), idx)
    cand_ids = torch.stack(
        [own] + [sparse.gather_pixels(interior(_shift(tri_id, dy, dx)), idx)
                 for dy, dx in NEIGHBOR_OFFSETS], dim=1)           # [cap, 5]
    valid_c = cand_ids >= 0
    rec13 = records[:, :13][cand_ids.clamp(min=0).reshape(-1).long()] \
        .reshape(cap, cand_ids.shape[1], 13)

    px = (idx % w).to(torch.float32) + 0.5
    row = torch.div(idx, w, rounding_mode="floor")
    py = (row + y_offset if y_offset else row).to(torch.float32) + 0.5
    covs = torch.stack([cov_s[s].reshape(-1)[idx] for s in range(cov_s.shape[0])])
    n_sec = torch.zeros_like(px)
    sec_z = torch.full_like(px, 2.0)
    sec_id = own
    for s, (dx, dy) in enumerate(raster.MSAA4_OFFSETS):
        b0, b1, b2, z = raster.eval_record_planes(rec13, (px + dx)[:, None],
                                                  (py + dy)[:, None])
        cover = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (z >= 0) & (z <= 1)
                 & valid_c)
        key = torch.where(cover, z, torch.full_like(z, 2.0))
        bz = key.amin(dim=1)
        # the first candidate on ties, as the reference's argmin
        best = torch.where(key == bz[:, None],
                           torch.arange(key.shape[1], device=key.device),
                           key.shape[1]).min(dim=1).values
        bid = cand_ids.gather(1, best[:, None])[:, 0]
        is_sec = (covs[s] > 0) & (bz < 2.0) & (bid != own)
        n_sec = n_sec + is_sec.to(torch.float32)
        take = is_sec & (bz < sec_z)
        sec_z = torch.where(take, bz, sec_z)
        sec_id = torch.where(take, bid, sec_id)
    return idx, live & (n_sec > 0), sec_id, n_sec, px, py
