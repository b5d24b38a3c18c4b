"""Count the aten ops other than views that one frame of the port
dispatches, on the CPU (no jax; the card runs about one launch for each):

    PYTHONPATH=. python tools/count_ops_torch.py

Prints one line per path: Sponza at 128x72 with cached 64^2 maps in
path (e) (MSAA, the environment) and in the engine's default
(settings.render_flags) whole, without SSAO and without SSR; then, from
each level's camera 0, the amplifier (graph.append_amplified_patches) and
the whole front end (graph.geometry_setup_gbuf) of Terrain (576 quad
patches) and StressTest (the TessRock's 12 tri patches). To compare two
trees, run it from the root of each.
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


def main() -> None:
    torch.set_num_threads(2)
    sponza_frames()
    for name in ("Terrain", "StressTest"):
        try:
            amplifier(name)
        except NotImplementedError as e:      # a tree before tessellation
            print(f"{name}: {e}")


if __name__ == "__main__":
    main()
