"""Compacted per-pixel work: gather a masked subset of pixels into a short
list of fixed capacity, run the expensive path on the list, scatter the
results back. Counterpart of ``vqengine_tpu/ops/sparse.py``.

The capacity semantics are the reference's, because which pixels get the
work decides the image: indices in raster order, `count` and `demand` in
element units (also with block compaction), slots past `count` hold index
0, dead lanes never write, and the adaptive threshold ladder counts
per-block maxima. Plain torch (cumsum and index_put_), with no host read;
the threshold ladder's rungs are pageable uploads, which synchronize the
card (trace site "sparse.thresholds").
"""
from __future__ import annotations

import torch

from ..utils import trace


def _compact(flat: torch.Tensor, cap: int) -> torch.Tensor:
    """[N] bool -> [cap] int64: the positions of the first `cap` True
    elements in order, 0 in the slots past them."""
    n = flat.shape[0]
    pos = torch.cumsum(flat.to(torch.int64), 0) - 1
    dest = torch.where(flat, pos.clamp(max=cap), cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=flat.device)
    # slot `cap` collects the dropped elements (False, or past capacity)
    idx.index_put_((dest,), torch.arange(n, device=flat.device))
    return idx[:cap]


def _any_blocks(mask: torch.Tensor, block: int) -> torch.Tensor:
    """Raster-order blocks of `block` elements -> [N / block] any-True
    (the flat tail padded with False)."""
    flat = mask.reshape(-1)
    if flat.shape[0] % block:
        flat = torch.nn.functional.pad(flat, (0, block - flat.shape[0] % block))
    return flat.reshape(-1, block).any(dim=1)


def compact_indices(mask: torch.Tensor, cap: int, block: int = 1):
    """mask (any shape) -> (idx [cap] int64 flat indices of True elements
    in raster order, count = min(demand, cap), demand = the True count
    before clamping; both 0-d int64 tensors). Slots past `count` hold index
    0. With block > 1, raster-order blocks of `block` elements that hold
    any True element are compacted instead, each as its `block` element
    indices (clamped to the last element); count and demand stay in
    element units (blocks x block). cap must be a multiple of block."""
    flat = mask.reshape(-1)
    n = flat.shape[0]
    if block == 1:
        idx = _compact(flat, cap)
        demand = flat.sum(dtype=torch.int64)
        return idx, demand.clamp(max=cap), demand
    if cap % block:
        raise ValueError(f"compact_indices: cap {cap} is not a multiple of "
                         f"block {block}")
    any_blk = _any_blocks(mask, block)
    bidx = _compact(any_blk, cap // block)
    idx = (bidx[:, None] * block
           + torch.arange(block, device=mask.device)[None, :]).reshape(-1)
    demand = any_blk.sum(dtype=torch.int64) * block
    return idx.clamp(max=n - 1), demand.clamp(max=cap), demand


def block_count(mask: torch.Tensor, block: int) -> torch.Tensor:
    """Number of raster-order blocks of `block` elements holding a True
    element: the demand compact_indices(..., block=block) sees, in blocks."""
    if block == 1:
        return mask.sum(dtype=torch.int64)
    return _any_blocks(mask, block).sum(dtype=torch.int64)


def adaptive_threshold(score: torch.Tensor, thresholds, cap: int,
                       block: int = 1):
    """The lowest threshold of the ascending ladder whose active set
    (score > t) fits the capacity, counted in `block` units -> (thr 0-d
    f32, demand in blocks at thr). If even the top rung overflows, the top
    one is returned (and compaction truncates). A block is active at t
    where its maximum score exceeds t."""
    capb = cap // block
    counted = _block_max(score, block)
    with trace.blocking("sparse.thresholds", len(thresholds)):
        rungs = [torch.tensor(float(t), dtype=torch.float32,
                              device=score.device) for t in thresholds]
    thr = rungs[-1]
    demand = (counted > thresholds[-1]).sum(dtype=torch.int64)
    for t, rung in zip(reversed(thresholds[:-1]), reversed(rungs[:-1])):
        c = (counted > t).sum(dtype=torch.int64)
        fits = c <= capb
        thr = torch.where(fits, rung, thr)
        demand = torch.where(fits, c, demand)
    return thr, demand


def _block_max(score: torch.Tensor, block: int) -> torch.Tensor:
    """Per raster-order block of `block` elements, the maximum score (the
    flat tail padded with -inf)."""
    flat = score.reshape(-1)
    if block == 1:
        return flat
    if flat.shape[0] % block:
        flat = torch.nn.functional.pad(flat, (0, block - flat.shape[0] % block),
                                       value=float("-inf"))
    return flat.reshape(-1, block).amax(dim=1)


def gather_pixels(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img [H, W] or [H, W, C] -> [cap] or [cap, C] at flat indices."""
    if img.ndim == 2:
        return img.reshape(-1)[idx]
    return img.reshape(-1, img.shape[-1])[idx]


def scatter_pixels(img: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                   live: torch.Tensor) -> torch.Tensor:
    """A copy of img [H, W(, C)] with vals [cap(, C)] written at the flat
    indices of the live lanes; dead lanes write to a dropped slot, so they
    never clobber pixel 0."""
    shape = img.shape
    flat = img.reshape(-1, *shape[2:])
    n = flat.shape[0]
    ext = torch.cat([flat, torch.zeros_like(flat[:1])])
    ext.index_put_((torch.where(live, idx, n),), vals.to(img.dtype))
    return ext[:n].reshape(shape)
