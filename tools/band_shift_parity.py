"""How a screen band's triangle setup agrees with the whole frame's, on
Sponza (CPU, plain raster versions):

    PYTHONPATH=. python tools/band_shift_parity.py [--size 192x108] [--bands 3]
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tools/band_shift_parity.py --jax

For each band of (g)'s first camera, two band rasters against the
frame's rows: "vertex shift", the reference's band setup
(raster.setup_triangles with full_height and y_offset: each vertex's
homogeneous y minus y_offset * w before the planes are formed), and
"frame rows", the port's band renderer (parallel/multichip._render_band:
the frame's setup rastered on the frame's rows up to the band's end, then
cut, raster.rasterize_gbuf_band). Printed per band: the pixels whose
winning triangle differs, and the largest depth difference.
--jax also renders the JAX package's own sharded frame against its
single-device frame (both jitted, no shadows, the default flags) and
prints the share of pixels more than 1e-3 apart.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
from unittest import mock

import torch


def port(width: int, height: int, bands: int) -> None:
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.ops import raster
    from vqengine_tpu_torch.render import graph
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    cpu = torch.device("cpu")
    s = load_scene("Sponza", width, height)
    r = VQRendererTorch(cpu)
    r.load_scene(s.buffers)
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    setup, extra = graph.geometry_setup_gbuf(r.scene, c, width, height)
    depth, tri_id, _ = raster.rasterize_gbuf(
        raster.bin_triangles(setup, width, height, extra=extra), width, height)
    bh = height // bands
    total = {"vertex shift": 0, "frame rows": 0}
    for band in range(bands):
        y0 = band * bh
        rows = slice(y0, y0 + bh)
        # the reference's band front end: the front end's setup_triangles
        # with the band's full_height and y_offset
        with mock.patch.object(raster, "setup_triangles", functools.partial(
                raster.setup_triangles, full_height=height, y_offset=y0)):
            vertex, _ = graph.geometry_setup_gbuf(r.scene, c, width, bh)
        end = raster.band_end(y0, bh, height)
        frame_rows = raster.bin_triangles(raster.rows_of_setup(setup, end),
                                          width, end, extra=extra)
        cases = (("vertex shift", lambda: raster.rasterize_gbuf(
                      raster.bin_triangles(vertex, width, bh, extra=extra),
                      width, bh)),
                 ("frame rows", lambda: raster.rasterize_gbuf_band(
                      frame_rows, width, bh, y0, height)))
        for name, fn in cases:
            d, t, _ = fn()
            n = int((t != tri_id[rows]).sum())
            total[name] += n
            print(f"Sponza {width}x{height}, band {band} of {bands} "
                  f"(rows {y0}-{y0 + bh - 1}), {name}: {n} pixels change "
                  f"winner, depth max |diff| "
                  f"{float((d - depth[rows]).abs().max()):.3e}", flush=True)
    for name, n in total.items():
        print(f"Sponza {width}x{height}, {bands} bands, {name}: {n} of "
              f"{width * bands * bh} pixels change winner "
              f"({n / (width * bands * bh):.5f})")


def reference(width: int, height: int, bands: int) -> None:
    os.environ.setdefault("XLA_FLAGS",
                          f"--xla_force_host_platform_device_count={bands}")
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    from test_torch_slice import jax_load_scene
    from vqengine_tpu.parallel import multichip
    from vqengine_tpu.render import graph
    from vqengine_tpu.render.renderer import VQRendererTPU
    from vqengine_tpu.render.scene_buffers import split_transparent
    b, cams, lights = jax_load_scene("Sponza", width, height)
    scene = graph.upload_scene(split_transparent(b)[0])
    c = VQRendererTPU().build_frame_constants(b, cams[0], lights)
    single = np.asarray(jax.jit(lambda s, c: graph.render_forward(
        s, c, width, height, enable_shadows=False)["ldr"])(scene, c))
    mesh = multichip.make_mesh(jax.devices()[:bands], dp=1, sp=bands)
    ldr, _ = multichip.render_forward_sharded(
        mesh, scene, multichip.stack_frame_constants([c]), width, height)
    d = np.abs(np.asarray(ldr)[0] - single).max(-1)
    print(f"JAX package, Sponza {width}x{height}, {bands} bands against one "
          f"device (jitted, no shadows): {(d > 1e-3).mean():.5f} of the pixels "
          f"more than 1e-3 apart, max {d.max():.4f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="192x108")
    ap.add_argument("--bands", type=int, default=3)
    ap.add_argument("--jax", action="store_true")
    a = ap.parse_args()
    width, height = map(int, a.size.split("x"))
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    port(width, height, a.bands)
    if a.jax:
        reference(width, height, a.bands)


if __name__ == "__main__":
    sys.exit(main())
