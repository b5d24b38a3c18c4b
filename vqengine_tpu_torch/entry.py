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


def _factor(n: int) -> tuple[int, int]:
    """n ranks -> (dp, sp), sp >= dp (band parallelism first), as the
    reference's dryrun factors its devices."""
    dp = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            dp = cand
            break
    return dp, n // dp


DRYRUN_FLAGS = dict(msaa=True, msaa_edge_resolve=True, enable_ssao=True,
                    enable_ssr=True, ssao_halo=4, aniso_taps=2,
                    enable_motion_vectors=True, enable_alpha_mask=True)


def dryrun_inputs(dp: int, sp: int) -> dict:
    """The scene of the reference's dryrun_multichip (__graft_entry__.py:
    101-176) at 128 x 32 sp: the textured cube and sphere, the displaced
    quad patch grid and the tri-domain rock; ESM casters (directional,
    spot, point), a 64x32 procedural sky (diffuse 8, specular 16 in 3 mips,
    LUT 32), one camera per dp index -> dict(buffers, lights, cameras,
    consts (numpy, one per dp index), env (the build's arguments),
    textures (mip arrays), slots_used, shadow_dims, width, height,
    flags)."""
    from .ops.ibl import procedural_sky_equirect
    from .scene.texture_manager import checkerboard, generate_mips
    width, height = 128, 32 * sp
    hm = (np.sin(np.linspace(0, 6, 16))[:, None]
          * np.cos(np.linspace(0, 6, 16))[None, :]).astype(np.float32)
    items = [
        DrawItem("cube", meshmod.cube(), m3.Transform(), 0, 0),
        DrawItem("sphere", meshmod.sphere(0.8, 12, 12),
                 m3.Transform(position=np.array([2.0, 0, 0], np.float32)),
                 0, 1),
        DrawItem("terrain", meshmod.patch_grid(6.0, 6.0, 2, 2,
                                               heightmap=hm * 0.5 + 0.5,
                                               disp_scale=0.3,
                                               tess_scale=20.0),
                 m3.Transform(position=np.array([0, -1.2, 0], np.float32)),
                 0, 2),
        DrawItem("tess_rock", meshmod.cube(),
                 m3.Transform(position=np.array([-2.0, 0, 0], np.float32)),
                 1, 3),
    ]
    mat = Material(name="m")
    mat.textures = {"diffuse": 0}
    rock = Material(name="rock")
    rock.tessellation_enabled = True
    rock.tessellation_scale = 30.0
    rock.displacement = 0.15
    rock.height_map_image = hm * 0.5 + 0.5
    buffers = build_scene_buffers(items, [mat, rock])
    lights = [
        Light(type=ELightType.DIRECTIONAL, brightness=1.0,
              casts_shadows=True, viewport_x=16, viewport_y=16,
              shadow_far=50.0),
        Light(type=ELightType.SPOT, brightness=30.0, range=50.0,
              position=np.array([0, 4, -2], np.float32),
              casts_shadows=True, shadow_far=60.0),
        Light(type=ELightType.POINT, brightness=30.0, range=50.0,
              position=np.array([-3, 3, -2], np.float32),
              casts_shadows=True, shadow_near=0.2, shadow_far=60.0),
    ]
    cameras = []
    for i in range(dp):
        p = FCameraParameters()
        p.position = np.array([0.5 * i, 1.5, -5], np.float32)
        cameras.append(Camera(p, aspect=width / height))
    return dict(
        buffers=buffers, lights=lights, cameras=cameras,
        consts=[frame_constants_numpy(buffers, c, lights) for c in cameras],
        env=dict(equirect=procedural_sky_equirect(64, 32), diffuse_size=8,
                 specular_base=16, specular_mips=3, lut_size=32),
        textures=[m[None] for m in generate_mips(checkerboard(16, 4))],
        slots_used=graph.slots_used_of(buffers.materials),
        shadow_dims=(64, 64, 64), width=width, height=height,
        flags=dict(DRYRUN_FLAGS))


def dryrun_job(dp: int, sp: int, check: bool = True) -> dict:
    """parallel/launch.render_job's job for dryrun_inputs: two frames of the
    dp cameras with the SSR history carried from the first to the second,
    gathered; with check, the first frame's launches (and the shadow
    precompute's) are held against their plain versions on a card."""
    d = dryrun_inputs(dp, sp)
    return dict(scene=graph.scene_fields_numpy(d["buffers"], bucketize=False),
                env=d["env"], textures=d["textures"],
                slots_used=d["slots_used"], shadow_dims=d["shadow_dims"],
                width=d["width"], height=d["height"], steps=[d["consts"]],
                runs=[dict(name="dryrun", flags=d["flags"],
                           steps=[0, 0], carry_ssr=True, gather=True,
                           check=check)])


def dryrun_multigpu(n: int, device, backend: str,
                    timeout: float = 600.0) -> dict:
    """The counterpart of __graft_entry__.dryrun_multichip: the dryrun scene
    with every feature (cached ESM maps of three caster kinds, IBL and the
    skydome, textures with aniso 2 and the alpha mask, MSAA with the edge
    resolve, SSAO with a 4-row halo, SSR with its history, motion, quad
    and tri tessellation) on n ranks factored into dp x sp bands, at 128 x
    32 sp, two frames with the history carried. The caller names the
    device and the backend (no default): "gloo" runs every rank on
    `device` ("cpu" or the one card they share), "nccl" one rank per
    card. -> rank 0's result (launch.render_job; its gathered frames
    [dp, H, W, 3], [dp, H, W], [dp, H/2, W/2, 7] per frame)."""
    from .parallel import launch
    dp, sp = _factor(n)
    job = dryrun_job(dp, sp)
    res = launch.run(launch.render_job, dp, sp, backend=backend,
                     device=device, timeout=timeout, job=job)
    ldr, _, hist = res[0]["runs"]["dryrun"]["frames"][-1]
    h, w = job["height"], job["width"]
    assert tuple(ldr.shape) == (dp, h, w, 3), tuple(ldr.shape)
    assert bool(torch.isfinite(ldr).all())
    assert tuple(hist.shape) == (dp, h // 2, w // 2, 7), tuple(hist.shape)
    print(f"dryrun_multigpu OK: {backend} ranks on {device}, mesh dp={dp} x "
          f"sp={sp}, out {tuple(ldr.shape)}, mean={float(ldr.mean()):.4f}",
          flush=True)
    return res[0]
