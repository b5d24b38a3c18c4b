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


def palette_lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """idx [...] int32, table [M, K] f32 -> out [..., K] f32."""
    return palette_lookup_plain(idx, table)
