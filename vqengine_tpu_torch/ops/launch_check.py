"""Hold every kernel launch against its plain version: while
checked_launches lasts, each launch of K1 (any variant), K2 (either sample
mode) and K3 on CUDA tensors is followed by the kernel's plain PyTorch
version on the same inputs, and a difference raises. chip_smoke.py and the
multi-GPU ranks (parallel/launch.py) wrap their first frames in it.
"""
from __future__ import annotations

import contextlib

import torch

GBUF_TOL = 1e-6   # the kernel mirrors the plain version's rounding


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@contextlib.contextmanager
def checked_launches(found: dict):
    """While the context lasts, every K1 (any variant), K2 (either sample
    mode) and K3 launch on CUDA tensors is followed by its plain version
    on the same inputs: ids, depths, coverage and K3's rows bitwise, the
    G-buffer within GBUF_TOL, else RuntimeError. found[launch name] is
    (launches checked, max |kernel - plain|, one note per launch)."""
    from . import palette, raster
    k1, k2, k3 = (raster._rasterize_gbuf_cuda, raster._rasterize_cuda,
                  palette._palette_lookup_cuda)

    def note(name: str, err: float, what: str) -> None:
        n, e, whats = found.get(name, (0, 0.0, []))
        found[name] = (n + 1, max(e, err), whats + [what])

    def stream(binned, width, height) -> str:
        return (f"{width}x{height}: pair demand {int(binned.demand)}, capacity "
                f"{binned.pair_cap}, {binned.pairs.shape[0] // raster.GROUP} "
                f"groups")

    def gbuf(binned, width, height, msaa, zbound):
        out = k1(binned, width, height, msaa, zbound)
        plain = raster.rasterize_gbuf_plain(binned, width, height, msaa, zbound)
        name = raster.gbuf_kernel_name(msaa, zbound is not None)
        torch.cuda.synchronize()
        for key, a, b in zip(("depth", "tri_id", "gbuf", "coverage"), out, plain):
            if key != "gbuf" and not bitwise_equal(a, b):
                raise RuntimeError(
                    f"{name} {stream(binned, width, height)}: {key} differs "
                    f"on {int((a != b).sum())} values")
        err = float((out[2] - plain[2]).abs().max())
        if not err <= GBUF_TOL:
            raise RuntimeError(f"{name} {stream(binned, width, height)}: gbuf "
                               f"max |kernel - plain| {err} > {GBUF_TOL}")
        note(name, err, stream(binned, width, height))
        return out

    def vis(binned, width, height, msaa):
        out = k2(binned, width, height, msaa)
        plain = raster.rasterize_plain(binned, width, height, msaa)
        name = "raster_vis_msaa4" if msaa else "raster_vis"
        torch.cuda.synchronize()
        if not (bitwise_equal(out[0], plain[0]) and bitwise_equal(out[1], plain[1])):
            raise RuntimeError(
                f"{name} {stream(binned, width, height)}: kernel != plain on "
                f"{int((out[1] != plain[1]).sum())} ids, "
                f"{int((out[0] != plain[0]).sum())} depths")
        note(name, 0.0, stream(binned, width, height))
        return out

    def lookup(idx, table):
        out = k3(idx, table)
        plain = palette.palette_lookup_plain(idx, table)
        torch.cuda.synchronize()
        what = f"{idx.numel()} ids into [{table.shape[0]}, {table.shape[1]}]"
        if not bitwise_equal(out, plain):
            raise RuntimeError(f"palette {what}: kernel != plain")
        note("palette", 0.0, what)
        return out
    raster._rasterize_gbuf_cuda, raster._rasterize_cuda = gbuf, vis
    palette._palette_lookup_cuda = lookup
    try:
        yield found
    finally:
        raster._rasterize_gbuf_cuda, raster._rasterize_cuda = k1, k2
        palette._palette_lookup_cuda = k3
