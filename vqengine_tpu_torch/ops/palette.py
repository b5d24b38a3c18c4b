"""Palette lookup — per-pixel small-table row fetch (kernel K3).

Counterpart of ``vqengine_tpu/ops/palette.py``. The TPU version is a
one-hot MXU product; here it is a row gather, by the CUDA kernel in
``csrc/palette.cu`` on the card and by ``palette_lookup_plain`` on the CPU.

out[p, :] = table_padded[clip(idx[p], 0, mp - 1), :], with the table
zero-padded to mp = max(8, ceil(M/8)*8) rows like the TPU kernel's.
"""
from __future__ import annotations

import torch

from . import _backend


def padded_rows(m: int) -> int:
    return max(8, -(-m // 8) * 8)


def palette_lookup_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: clamped index into the
    zero-padded table."""
    _backend.count_plain("palette", idx)
    m, k = table.shape
    mp = padded_rows(m)
    padded = torch.zeros((mp, k), dtype=torch.float32, device=table.device)
    padded[:m] = table
    j = idx.reshape(-1).long().clamp(0, mp - 1)
    return padded[j].reshape(*idx.shape, k)


def _palette_lookup_cuda(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    dev = idx.device
    _backend.require(idx, "idx", torch.int32, dev)
    _backend.require(table, "table", torch.float32, dev, ndim=2)
    m, k = table.shape
    n = idx.numel()
    if n * k >= 2 ** 31 or padded_rows(m) * k >= 2 ** 31:
        raise ValueError(f"palette_lookup: {n} x {k} outputs or a {m} x {k} "
                         f"table; the kernel indexes in 32 bits")
    out = torch.empty((*idx.shape, k), dtype=torch.float32, device=dev)
    lib = _backend.library()
    code = lib.vq_palette_lookup(idx.data_ptr(), table.data_ptr(),
                                 out.data_ptr(), n, m, padded_rows(m), k,
                                 _backend.stream_of(idx))
    _backend.check_launch("palette", code)
    return out


def palette_lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """idx [...] int32, table [M, K] f32 -> out [..., K] f32."""
    if idx.device.type == "cpu":
        return palette_lookup_plain(idx, table)
    if idx.is_cuda:
        return _palette_lookup_cuda(idx, table)
    raise ValueError(f"palette_lookup: unsupported device {idx.device}")
