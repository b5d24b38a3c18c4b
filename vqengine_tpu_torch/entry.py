"""Entry point of the port: one forward frame of a tiny two-item scene at
256x128 (the same scene as the JAX package's ``__graft_entry__.entry``).

    fn, (scene, consts) = entry(torch.device("cuda"))
    ldr = fn(scene, consts)        # [128, 256, 3]
"""
from __future__ import annotations

import numpy as np
import torch

from .render import graph
from .render.scene_buffers import DrawItem, build_scene_buffers
from .scene import mesh as meshmod
from .scene.camera import Camera, FCameraParameters
from .scene.light import ELightType, Light
from .scene.material import Material
from .utils import math3d as m3
from .render.renderer import frame_constants_numpy

WIDTH, HEIGHT = 256, 128


def tiny_scene_numpy(width: int = WIDTH, height: int = HEIGHT):
    """-> (SceneBuffers, camera, lights) of the entry scene: a cube and a
    two-LOD sphere, a directional and a point light."""
    items = [
        DrawItem("cube", meshmod.cube(), m3.Transform(), 0, 0),
        DrawItem("sphere", meshmod.sphere(0.8, 16, 16, num_lods=2),
                 m3.Transform(position=np.array([2.0, 0, 0], np.float32)), 0, 1),
    ]
    buffers = build_scene_buffers(items, [Material(name="m")])
    p = FCameraParameters()
    p.position = np.array([0, 1.5, -5], np.float32)
    p.fov_v_deg = 60.0
    p.near_z = 0.1
    p.far_z = 100.0
    cam = Camera(p, aspect=width / height)
    lights = [Light(type=ELightType.DIRECTIONAL, brightness=1.5),
              Light(type=ELightType.POINT, brightness=30.0, range=50.0,
                    position=np.array([-3, 3, -2], np.float32))]
    return buffers, cam, lights


def entry(device: torch.device):
    """-> (fn, (scene, consts)): fn(scene, consts) renders one forward
    frame and returns its ldr image."""
    buffers, cam, lights = tiny_scene_numpy()
    scene = graph.upload_scene(buffers, device, bucketize=False)
    consts = graph.frame_constants_from_numpy(
        frame_constants_numpy(buffers, cam, lights), device)

    def fn(scene, consts):
        return graph.render_forward(scene, consts, WIDTH, HEIGHT)["ldr"]

    return fn, (scene, consts)
