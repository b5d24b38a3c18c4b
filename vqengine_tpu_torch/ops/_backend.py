"""Backend shared by every op of the port: f32 exactness pins, the build
and ctypes binding of the hand-written CUDA kernels in ``csrc/``, and the
per-kernel launch counters.

Counterpart of ``vqengine_tpu/ops/_backend.py``. Where the JAX package
switches Pallas kernels to interpret mode off-TPU, the port's wrappers pick
by the device of the tensor they are given: a CPU tensor runs the kernel's
plain PyTorch version, a CUDA tensor launches the CUDA kernel (or raises).

The kernels are compiled with ``nvcc`` on first use (never at import),
one ``nvcc`` per source, all started together, then linked into one
shared library with a plain C interface, cached under ``_build/`` next to
the package and keyed by a hash of the sources and flags.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

# The reference runs every f32 matmul at "highest" precision because
# one-pass bf16 dots corrupted triangle ids (vqengine_tpu/ops/_backend.py).
# The port keeps TF32 off for the same reason, in matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@functools.cache
def libm_f32(name: str):
    """libm's f32 function `name` (tanf, cosf, sinf) through ctypes: XLA's
    CPU backend calls these for the reference's f32 tan, cos and sin, which
    torch rounds otherwise; the port calls them on the host."""
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn

KERNELS = ("palette", "raster_gbuf", "raster_vis", "raster_gbuf_msaa",
           "raster_vis_msaa4", "raster_gbuf_bounded",
           "raster_gbuf_msaa_bounded")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              # no FMA contraction: the raster kernels' plane arithmetic
              # must round exactly like their plain PyTorch versions
              "-fmad=false", "-Xptxas", "-v")

# launches[name]: times the CUDA kernel `name` was launched by its wrapper.
# plain_cuda_calls[name]: times its plain PyTorch version ran on CUDA
# tensors (only a comparison does that; the main path never should).
launches = {k: 0 for k in KERNELS}
plain_cuda_calls = {k: 0 for k in KERNELS}


def reset_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
        plain_cuda_calls[k] = 0


def count_plain(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        plain_cuda_calls[name] += 1


@dataclass
class BuildInfo:
    path: Path
    seconds: float            # 0.0 when the cached library was reused
    ptxas: list[str] = field(default_factory=list)  # -Xptxas -v lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> BuildInfo:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into one shared library (cached by a hash of the sources and
    flags)."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libvq_kernels_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return BuildInfo(lib, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objs = [lib.with_name(f"{s.stem}.{os.getpid()}.o") for s in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for s, o in zip(sources, objs)]
    outs = [(p.communicate(), p.returncode) for p in procs]
    for ((_, err), code), s in zip(outs, sources):
        if code != 0:
            raise RuntimeError(f"nvcc failed on {s.name} ({code}):\n{err}")
    res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    text = "\n".join(out + err for (out, err), _ in outs)
    ptxas = [ln.strip() for ln in text.splitlines()
             if ("ptxas info" in ln and ("registers" in ln or "Compiling" in ln
                                          or "bytes smem" in ln))
             or "bytes spill" in ln]
    return BuildInfo(lib, seconds, ptxas)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "vq_palette_lookup": [_P, _P, _P, _I, _I, _I, _I, _P],
    "vq_raster_gbuf": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _P, _P, _P, _P],
    "vq_raster_vis": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "vq_raster_gbuf_msaa": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _P, _P, _P, _P, _P],
    "vq_raster_vis_msaa4": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "vq_raster_gbuf_bounded": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P, _P, _P, _P, _P, _P],
    "vq_raster_gbuf_msaa_bounded": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _P, _P, _P, _P, _P, _P, _P],
}

_lib: ctypes.CDLL | None = None
last_build: BuildInfo | None = None


def library() -> ctypes.CDLL:
    """The kernels' library, built and loaded on first use."""
    global _lib, last_build
    if _lib is None:
        last_build = build()
        lib = ctypes.CDLL(str(last_build.path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in ("vq_raster_gbuf_smem_bytes", "vq_raster_vis_smem_bytes"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        lib.vq_error_string.argtypes = [ctypes.c_int]
        lib.vq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, code: int) -> None:
    """Raise if the C entry reported a CUDA error; else count the launch."""
    if code != 0:
        msg = library().vq_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
    launches[name] += 1


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
