"""The terrain golden's frame (Terrain, 576 quad patches, 192x108, shadow
dims (64, 64, 128), no MSAA, SSAO or SSR) through the port and through the
JAX package, both on the CPU:

    JAX_PLATFORMS=cpu python tools/terrain_golden_parity.py

The reference renders the config three ways: as tests/test_golden.py
renders it (the engine's load and its jitted render, the shadow maps
inside the frame), op by op (its raster kernels compiled whole,
test_torch_slice.compiled_rasters; the caster's maps built view by view,
test_torch_tessellation_frames.ref_shadow_maps), and jitted with the op by
op maps passed in. The port renders it with the reference engine's
environment tables carried over (renderer.environment_from_numpy) and with
its own (goldens.render_golden). Prints, for each pair, the share of
pixels whose tri_id agrees, the largest ldr difference over them and the
SSIM between the two frames, the maps' differing texels, and each frame's
scores against tests/goldens/terrain.png. About two minutes on one core;
needs jax, so it runs on a CPU host, not on the card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from test_torch_ibl import env_leaves  # noqa: E402
from test_torch_slice import compiled_rasters  # noqa: E402
from test_torch_tessellation_frames import ref_shadow_maps  # noqa: E402
from vqengine_tpu.engine.cli import parse_command_line  # noqa: E402
from vqengine_tpu.engine.engine import VQEngineTPU  # noqa: E402
from vqengine_tpu.render import graph as jg  # noqa: E402
from vqengine_tpu_torch.engine.goldens import (HEIGHT, SCENES, WIDTH,  # noqa: E402
                                               golden_scores, render_golden)
from vqengine_tpu_torch.engine.scene_load import load_scene  # noqa: E402
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,  # noqa: E402
                                                environment_from_numpy)
from vqengine_tpu_torch.utils.ssim import ssim  # noqa: E402

CPU = torch.device("cpu")


def frame(out) -> dict:
    get = out.get if isinstance(out, dict) else lambda k: getattr(out, k)
    return {k: np.asarray(get(k).cpu() if isinstance(get(k), torch.Tensor) else get(k))
            for k in ("ldr", "tri_id")}


def compare(label: str, a: dict, b: dict) -> None:
    same = a["tri_id"] == b["tri_id"]
    diff = float(np.abs(a["ldr"] - b["ldr"])[same].max()) if same.any() else float("nan")
    print(f"{label}: tri_id agrees on {same.mean():.6f} of {same.size} pixels; "
          f"max |ldr diff| there {diff:.3g}, anywhere "
          f"{float(np.abs(a['ldr'] - b['ldr']).max()):.3g}; SSIM "
          f"{float(ssim(a['ldr'], b['ldr'])):.5f}", flush=True)


def main() -> None:
    torch.set_num_threads(1)
    name, flags = SCENES["terrain"]
    dims = flags["shadow_dims"]
    e = VQEngineTPU(startup=parse_command_line(
        [f"-W={WIDTH}", f"-H={HEIGHT}", f"-Scene={name}"]))
    e.gfx.bAmbientOcclusion, e.gfx.bAntiAliasing, e.gfx.Reflections = False, False, 0
    e.gfx.bDrawLightBounds = True
    assert e.start_loading_scene(name)
    rr = e.renderer
    jc = rr.build_frame_constants(e.scene_buffers, e.cameras[0], e.lights)
    kw = dict(env=e.environment, textures=e.texture_arrays, shadow_dims=dims)
    jit = frame(rr.render(jc, WIDTH, HEIGHT, **kw))
    maps = ref_shadow_maps(rr._scene, jc, dims)
    jit_maps = frame(rr.render(jc, WIDTH, HEIGHT, shadow_maps=maps, **kw))
    with compiled_rasters():
        op = frame(jg.render_forward(
            rr._scene, jc, WIDTH, HEIGHT, shadow_maps=maps,
            enable_alpha_mask=getattr(rr, "_any_alpha_mask", False),
            slots_used=getattr(rr, "_slots_used", None), **kw))
    print(f"reference: {int(rr._scene.num_tris_live)} static triangles, "
          f"{sorted(maps)} maps op by op", flush=True)

    s = load_scene(name, WIDTH, HEIGHT, draw_light_gizmos=True)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers, textures=s.textures)
    r.env = environment_from_numpy(env_leaves(e.environment), CPU)
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    pmaps = r.precompute_shadow_maps(c, shadow_dims=dims)
    for k in maps:
        a = pmaps[k].view(torch.int16).numpy()
        b = np.asarray(maps[k]).view(np.int16)
        print(f"{k} map {a.shape}: port vs reference op by op, "
              f"{int((a != b).sum())} texels differ", flush=True)
    port = frame(r.render(c, WIDTH, HEIGHT, shadow_maps=pmaps, **flags))
    port_own = {"ldr": render_golden("terrain", CPU), "tri_id": port["tri_id"]}

    compare("port vs reference op by op", port, op)
    compare("reference jitted (the golden's render) vs op by op", jit, op)
    compare("reference jitted with the op-by-op maps vs op by op", jit_maps, op)
    compare("port vs reference jitted", port, jit)
    compare("port with its own environment vs with the reference's",
            port_own, port)
    for label, f in (("reference jitted", jit), ("reference op by op", op),
                     ("port", port), ("port, own environment", port_own)):
        g = golden_scores("terrain", f["ldr"])
        print(f"{label} vs tests/goldens/terrain.png: SSIM {g['ssim']:.5f}, "
              f"mean MAE {g['mean_mae']:.5f}, worst block {g['block_mae']:.5f}",
              flush=True)


if __name__ == "__main__":
    main()
