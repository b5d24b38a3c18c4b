"""Time the hand kernels of vqengine_tpu_torch of the tree in the working
directory on one CUDA card, at the main path's shapes: the four K1
variants (Sponza 1920x1080; the bounded ones on the translucent Sponza's
first peel window), K2 on Sponza's 8 caster views at the full shadow
budget (and their sum), K2-msaa4 on the directional and the first spot
view, and K3's four lookups of one frame (and their sum), each 50
launches by CUDA events after warm-up; then the whole shadow-map render
(graph.render_shadow_maps, 8 views, host syncs included), 10 runs. All of
it twice; prints one JSON line.

    cd <tree> && python3 <this file> LABEL

To compare two trees (say a commit and its parent, unpacked with git
archive), run both on one card in turns: A, B, B, A.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
from chip_smoke import H, W, caster_views, load_sponza, time_ms  # noqa: E402
from vqengine_tpu_torch.ops import _backend, palette, raster, shadow  # noqa: E402
from vqengine_tpu_torch.render import graph  # noqa: E402

N = 50
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

sc = r.scene
views = [(name, shadow.bin_shadow_view(sc.positions, sc.item_of_vertex, c.world,
                                       vp, sc.indices, size), size)
         for name, vp, size in caster_views(c)]
msaa_views = [v for v in views if v[0] in ("dir", "spot0")]

# K3's four lookups of one main-path frame (chip_smoke.phase_palette)
g = torch.Generator().manual_seed(1)
mp = palette.padded_rows(sc.materials.shape[0])
n_items = c.world.shape[0]
item3 = sc.tri_item[:sc.num_tris_live].repeat_interleave(3).contiguous()
lookups = {
    "materials": (torch.randint(-3, mp + 5, (H, W), generator=g,
                                dtype=torch.int32).to(dev), sc.materials),
    "mvp": (item3, raster.world_view_proj(c.view_proj, c.world)
            .reshape(n_items, 16).contiguous()),
    "normal_mats": (item3, c.normal_mats.reshape(n_items, 9).contiguous()),
    "cull": (sc.tri_item.contiguous(),
             torch.rand((n_items, 2), generator=g).to(dev)),
}

out = {"tree": sys.argv[1], "card": torch.cuda.get_device_name(0)}
for rep in range(2):
    out[f"raster_gbuf.{rep}"] = time_ms(lambda: raster.rasterize_gbuf(b, W, H), N)
    out[f"raster_gbuf_msaa.{rep}"] = time_ms(
        lambda: raster.rasterize_gbuf(b, W, H, msaa=True), N)
    out[f"raster_gbuf_bounded.{rep}"] = time_ms(
        lambda: raster.rasterize_gbuf(tb, W, H, zbound=win), N)
    out[f"raster_gbuf_msaa_bounded.{rep}"] = time_ms(
        lambda: raster.rasterize_gbuf(tb, W, H, msaa=True, zbound=win), N)
    k2 = 0.0
    for name, vb, size in views:
        t = time_ms(lambda: raster.rasterize(vb, size, size), N)
        out[f"raster_vis.{name}.{rep}"] = t
        k2 += t
    out[f"raster_vis.{rep}"] = k2
    out[f"raster_vis_msaa4.{rep}"] = sum(
        time_ms(lambda: raster.rasterize(vb, size, size, msaa=True), N)
        for _, vb, size in msaa_views)
    k3 = 0.0
    for name, (idx, table) in lookups.items():
        t = time_ms(lambda: palette.palette_lookup(idx, table), N)
        out[f"palette.{name}.{rep}"] = t
        k3 += t
    out[f"palette.{rep}"] = k3
    out[f"render_shadow_maps.{rep}"] = time_ms(
        lambda: graph.render_shadow_maps(sc, c), 10)
print(json.dumps(out), flush=True)
