"""Count the aten ops other than views that one frame of the port
dispatches, on the CPU (no jax; the card runs about one launch for each):

    PYTHONPATH=. python tools/count_ops_torch.py

Prints one line per path: Sponza at 128x72 with cached 64^2 maps in
path (e) (MSAA, the environment) and in the engine's default
(settings.render_flags) whole, without SSAO and without SSR; then, from
each level's camera 0, the amplifier (graph.append_amplified_patches) and
the whole front end (graph.geometry_setup_gbuf) of Terrain (576 quad
patches) and StressTest (the TessRock's 12 tri patches); then the post
tail on a W x H frame (CAS, FSR1 from 0.75 of the size, the ST.2084
tonemap, each draw mode, the magnifier and the outline) and one engine
tick (engine.VQEngineTorch on Sponza with the engine's defaults, and with
RenderScale 0.75: FSR1 in every tick). To compare two trees, run it from
the root of each.
"""
from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
from vqengine_tpu_torch.render import graph
from vqengine_tpu_torch.render.renderer import VQRendererTorch

CPU = torch.device("cpu")
W, H = 128, 72


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active, views left out
    (they launch nothing)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))

    def total(self) -> int:
        return sum(self.ops.values())


def counted(fn, *args, **kwargs) -> int:
    fn(*args, **kwargs)                       # caches and first-call work
    with OpCount() as m:
        fn(*args, **kwargs)
    return m.total()


def sponza_frames() -> None:
    s = load_scene("Sponza", W, H)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers, equirect=s.equirect, textures=s.textures)
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    maps = r.precompute_shadow_maps(c, shadow_dims=(64, 64, 64))
    full = dict(render_flags(FGraphicsSettings()), dynamic_item_ids=())
    for label, flags in (("(e) MSAA with the environment", {"msaa": True}),
                         ("(g) engine default, full", full),
                         ("(g) without SSAO", dict(full, enable_ssao=False)),
                         ("(g) without SSR", dict(full, enable_ssr=False))):
        n = counted(r.render, c, W, H, shadow_maps=maps, **flags)
        print(f"Sponza {W}x{H}, {label}: {n} ops a frame", flush=True)


def amplifier(name: str) -> None:
    s = load_scene(name, W, H)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers)
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    amplify, inner = graph.append_amplified_patches, []

    def watched(*args):
        with OpCount() as m:
            out = amplify(*args)
        inner.append(m.total())
        return out

    graph.append_amplified_patches = watched
    try:
        front = counted(graph.geometry_setup_gbuf, r.scene, c, W, H)
    finally:
        graph.append_amplified_patches = amplify
    print(f"{name}: append_amplified_patches {inner[-1]} ops, the whole front "
          f"end {front} ops a frame", flush=True)


def post_tail() -> None:
    from vqengine_tpu_torch.ops import colorspace as cs
    from vqengine_tpu_torch.ops import ffx, postprocess as pp
    from vqengine_tpu_torch.ops import visualization as viz
    g = torch.Generator().manual_seed(0)
    ldr = torch.rand(H, W, 3, generator=g)
    src = torch.rand(H * 3 // 4, W * 3 // 4, 3, generator=g)
    gbuf = dict(depth=torch.rand(H, W, generator=g), ao=ldr[..., 0],
                motion=ldr[..., :2] - 0.5, normals=ldr * 2 - 1,
                roughness=ldr[..., 1], metalness=ldr[..., 2], albedo=ldr,
                object_id=(ldr[..., 0] * 8).to(torch.int32) - 1)
    rows = {"CAS": lambda: ffx.cas(ldr, 0.5),
            "FSR1 (EASU + RCAS)": lambda: ffx.fsr1(src, H, W),
            "ST.2084 tonemap": lambda: pp.tonemap(ldr * 4, cs.DISPLAY_CURVE_ST2084),
            "magnifier": lambda: viz.magnifier(ldr),
            "outline": lambda: viz.outline(ldr, gbuf["object_id"], 3)}
    for mode in range(1, 9):
        rows[f"draw mode {mode}"] = lambda m=mode: viz.visualize(m, ldr, **gbuf)
    print("post tail: " + ", ".join(f"{k} {counted(fn)}" for k, fn in rows.items())
          + " ops", flush=True)


def engine_tick() -> None:
    from vqengine_tpu_torch.engine.engine import VQEngineTorch
    e = VQEngineTorch([f"-W={W}", f"-H={H}", "-Scene=Sponza"], device=CPU)
    e.start_loading_scene("Sponza")
    # the static casters' maps cached at 64^2, as sponza_frames caches them
    c = e.renderer.build_frame_constants(e.scene_buffers, e.cameras[0], e.lights)
    e.loop.static_maps = e.renderer.precompute_shadow_maps(c, (64, 64, 64))
    for scale in (1.0, 0.75):
        e.gfx.RenderScale = scale
        n = counted(e.tick)
        print(f"engine tick, Sponza {W}x{H}, the engine's defaults, RenderScale "
              f"{scale}: {n} ops", flush=True)


def main() -> None:
    torch.set_num_threads(2)
    sponza_frames()
    for name in ("Terrain", "StressTest"):
        try:
            amplifier(name)
        except NotImplementedError as e:      # a tree before tessellation
            print(f"{name}: {e}")
    try:
        post_tail()
        engine_tick()
    except ImportError as e:                  # a tree before the post tail
        print(f"post tail: {e}")


if __name__ == "__main__":
    main()
