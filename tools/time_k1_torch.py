"""Time the four K1 variants (kernel K1 of vqengine_tpu_torch) of the tree
in the working directory on one CUDA card: Sponza 1920x1080, the bounded
variants on the translucent Sponza's first peel window, each 50 launches
by CUDA events after warm-up, twice; prints one JSON line.

    cd <tree> && python3 <this file> LABEL

To compare two trees (say a commit and its parent, unpacked with git
archive), run both on one card, one after the other: A, B, B, A.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
from chip_smoke import H, W, load_sponza, time_ms  # noqa: E402
from vqengine_tpu_torch.ops import _backend, raster  # noqa: E402
from vqengine_tpu_torch.render import graph  # noqa: E402

dev = torch.device("cuda", 0)
_backend.library()
sponza, r = load_sponza(dev)
st, rt = load_sponza(dev, translucent=True)
c = r.build_frame_constants(sponza.buffers, sponza.cameras[0], sponza.lights)
setup, extra = graph.geometry_setup_gbuf(r.scene, c, W, H)
b = raster.bin_triangles(setup, W, H, extra=extra)
ct = rt.build_frame_constants(st.buffers, st.cameras[0], st.lights)
opaque = graph.geometry_pass(rt.scene, ct, W, H, msaa=True)[0]
setup, extra = graph.geometry_setup_gbuf(rt.scene_t, ct, W, H)
tb = raster.bin_triangles(setup, W, H, extra=extra)
win = (torch.full_like(opaque, -1.0), opaque)
out = {"tree": sys.argv[1]}
for rep in range(2):
    out[f"raster_gbuf.{rep}"] = time_ms(lambda: raster.rasterize_gbuf(b, W, H), 50)
    out[f"raster_gbuf_msaa.{rep}"] = time_ms(
        lambda: raster.rasterize_gbuf(b, W, H, msaa=True), 50)
    out[f"raster_gbuf_bounded.{rep}"] = time_ms(
        lambda: raster.rasterize_gbuf(tb, W, H, zbound=win), 50)
    out[f"raster_gbuf_msaa_bounded.{rep}"] = time_ms(
        lambda: raster.rasterize_gbuf(tb, W, H, msaa=True, zbound=win), 50)
print(json.dumps(out), flush=True)
