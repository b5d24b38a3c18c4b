"""The reference's backend: the f32 exactness pins, libm's f32 functions,
and the counters of the plain kernel versions that ran on a card.

A frozen copy of the port's ``ops/_backend.py`` without the CUDA kernels:
every kernel wrapper of this copy runs its plain PyTorch version, on
whatever device its tensors are on.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import torch

# The reference runs every f32 matmul at "highest" precision because
# one-pass bf16 dots corrupted triangle ids; TF32 stays off, in matmuls
# and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@functools.cache
def libm_f32(name: str, nargs: int = 1):
    """libm's f32 function `name` of nargs arguments (tanf, cosf, sinf,
    atan2f) through ctypes: XLA's CPU backend calls these for the
    reference's f32 tan, cos, sin and atan2, which torch rounds otherwise;
    the port calls them on the host."""
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float] * nargs
    return fn


KERNELS = ("palette", "raster_gbuf", "raster_vis", "raster_gbuf_msaa",
           "raster_vis_msaa4", "raster_gbuf_bounded",
           "raster_gbuf_msaa_bounded")

# plain_cuda_calls[name]: times the plain version of kernel `name` ran on
# CUDA tensors
plain_cuda_calls = {k: 0 for k in KERNELS}


def count_plain(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        plain_cuda_calls[name] += 1


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, ndim: int | None = None) -> None:
    """Validate a tensor handed to a CUDA kernel."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: {t.ndim} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
