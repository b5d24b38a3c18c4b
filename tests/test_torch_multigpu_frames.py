"""Frames of the port's multi-GPU renderer (parallel/multichip.py) rendered
by spawned gloo ranks on the CPU (parallel/launch.py), each launch bounded
by its own wall-clock limit (a limit reached fails the test):

(a) the reference's tests/test_multichip.py tiny scene at 128x64 on dp 2 x
    sp 2 ranks, against the reference's render_forward_sharded on a 2 x 2
    mesh of conftest's virtual devices within its own bar (atol 3e-4,
    tests/test_multichip.py:73), and against the port's single-device
    frames;
(b) entry.dryrun_multigpu's scene (every feature: cached ESM maps, IBL and
    the skydome, textures with aniso 2 and the alpha mask, MSAA with the
    edge resolve, SSAO with a 4-row halo, SSR with its history, motion,
    quad and tri tessellation) on dp 1 x sp 4, two frames with the history
    carried, against the port's single-device frames at the reference's
    bars for SSAO and SSR (tests/test_multichip.py:222-223, :273-274);
(c) the launcher has no fallback: a rank's failure and the time limit
    raise, and NCCL with more ranks than cards refuses to start.
"""
import jax
import numpy as np
import pytest
import torch

from vqengine_tpu.parallel import multichip as jmc
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu.render.scene_buffers import DrawItem as JDrawItem
from vqengine_tpu.render.scene_buffers import build_scene_buffers as jbuild
from vqengine_tpu.scene import mesh as jmesh
from vqengine_tpu.scene.camera import Camera as JCamera
from vqengine_tpu.scene.camera import FCameraParameters as JParams
from vqengine_tpu.scene.light import ELightType as JKind
from vqengine_tpu.scene.light import Light as JLight
from vqengine_tpu.scene.material import Material as JMaterial
from vqengine_tpu.utils import math3d as jm3
from vqengine_tpu_torch import entry
from vqengine_tpu_torch.ops import texture as tt
from vqengine_tpu_torch.parallel import launch
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render.renderer import frame_constants_numpy
from vqengine_tpu_torch.render.scene_buffers import DrawItem, build_scene_buffers
from vqengine_tpu_torch.scene import mesh as meshmod
from vqengine_tpu_torch.scene.camera import Camera, FCameraParameters
from vqengine_tpu_torch.scene.light import ELightType, Light
from vqengine_tpu_torch.scene.material import Material
from vqengine_tpu_torch.utils import math3d as m3

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 128, 64
EYES = [(0, 1.5, -5), (1.5, 1.0, -4.5)]
LIMIT = 300.0                  # seconds: each launch's wall-clock limit
SHARD_ATOL = 3e-4              # tests/test_multichip.py:73
SEAM_MEAN, SEAM_P99 = 3e-3, 0.05   # tests/test_multichip.py:222-223, :273-274


def _tiny(pkg_items, pkg_build, pkg_mesh, pkg_m3, pkg_mat, pkg_params,
          pkg_camera, pkg_light, pkg_kind):
    """tests/test_multichip.py's tiny_scene, camera() and consts_for() on
    one package's host modules -> (buffers, cameras, lights)."""
    items = [
        pkg_items("cube", pkg_mesh.cube(), pkg_m3.Transform(), 0, 0),
        pkg_items("sphere", pkg_mesh.sphere(0.8, 12, 12),
                  pkg_m3.Transform(position=np.array([2.0, 0, 0], np.float32)),
                  0, 1),
    ]
    buffers = pkg_build(items, [pkg_mat(name="m")])
    cams = []
    for eye in EYES:
        p = pkg_params()
        p.position = np.array(eye, np.float32)
        p.fov_v_deg = 60
        p.near_z = 0.1
        p.far_z = 100
        cams.append(pkg_camera(p, aspect=W / H))
    return buffers, cams, [pkg_light(type=pkg_kind.DIRECTIONAL, brightness=1.5)]


def test_tiny_scene_matches_jax_sharded_and_single_device():
    """(a) dp 2 x sp 2 gloo ranks on the CPU: each gathered frame within
    3e-4 of the reference's render_forward_sharded on make_mesh(jax.devices()
    [:4], dp=2, sp=2), and of the port's render_forward of the whole
    frame; no band overflows."""
    buffers, cams, lights = _tiny(DrawItem, build_scene_buffers, meshmod, m3,
                                  Material, FCameraParameters, Camera, Light,
                                  ELightType)
    consts = [frame_constants_numpy(buffers, c, lights) for c in cams]
    job = dict(scene=tg.scene_fields_numpy(buffers, bucketize=False),
               width=W, height=H, steps=[consts],
               runs=[dict(name="tiny", flags={}, steps=[0], gather=True)])
    res = launch.run(launch.render_job, 2, 2, backend="gloo", device="cpu",
                     timeout=LIMIT, job=job)
    assert [r["band"] for r in res] == [0, 1, 0, 1]
    assert all(v == 0 for r in res for f in r["runs"]["tiny"]["overflow"]
               for row in f for v in row)
    ldr = res[0]["runs"]["tiny"]["frames"][0][0].numpy()
    assert ldr.shape == (2, H, W, 3) and np.isfinite(ldr).all()

    scene = tg.upload_scene(buffers, CPU, bucketize=False)
    single = [tg.render_forward(scene, tg.frame_constants_from_numpy(c, CPU),
                                W, H)["ldr"].numpy() for c in consts]

    jbuffers, jcams, jlights = _tiny(JDrawItem, jbuild, jmesh, jm3, JMaterial,
                                     JParams, JCamera, JLight, JKind)
    jscene = jg.upload_scene(jbuffers, bucketize=False)
    r = VQRendererTPU()
    batch = jmc.stack_frame_constants(
        [r.build_frame_constants(jbuffers, c, jlights) for c in jcams])
    ref, _ = jmc.render_forward_sharded(
        jmc.make_mesh(jax.devices()[:4], dp=2, sp=2), jscene, batch, W, H)
    ref = np.asarray(ref)
    for i in range(2):
        np.testing.assert_allclose(ldr[i], ref[i], rtol=0, atol=SHARD_ATOL)
        np.testing.assert_allclose(ldr[i], single[i], rtol=0, atol=SHARD_ATOL)
    assert float(np.abs(ldr[0] - ldr[1]).max()) > 0.05   # two views


def test_dryrun_scene_two_frames_match_single_device():
    """(b) entry.dryrun_inputs(1, 4) (128x128, four 32-row bands) on 4 gloo
    ranks, two frames of its camera with the SSR history carried: each
    gathered frame's ldr, and the gathered new history, against the port's
    single-device frames with the same flags, at the reference's bars
    (mean below 3e-3, 99th percentile below 0.05); no band overflows; the
    ranks' replicated environment tables and shadow maps bitwise equal."""
    job = entry.dryrun_job(1, 4, check=False)
    res = launch.run(launch.render_job, 1, 4, backend="gloo", device="cpu",
                     timeout=LIMIT, job=job)
    run = res[0]["runs"]["dryrun"]
    assert all(r["digests"] == res[0]["digests"] for r in res)
    assert len(res[0]["digests"]) == 11       # 8 environment tables, 3 maps
    assert all(v == 0 for r in res for f in r["runs"]["dryrun"]["overflow"]
               for row in f for v in row)

    d = entry.dryrun_inputs(1, 4)
    scene = tg.upload_scene(d["buffers"], CPU, bucketize=False)
    e = dict(d["env"])
    env = tg.build_environment(e.pop("equirect"), CPU, **e)
    consts = tg.frame_constants_from_numpy(d["consts"][0], CPU)
    maps = tg.render_shadow_maps(scene, consts, d["shadow_dims"])
    flags = {k: v for k, v in d["flags"].items() if k != "ssao_halo"}
    hist = torch.zeros((d["height"] // 2, d["width"] // 2, 7))
    for f in range(2):
        o = tg.render_forward(scene, consts, d["width"], d["height"], env=env,
                              shadow_maps=maps,
                              textures=tt.pack_texture_quads(d["textures"], CPU),
                              slots_used=d["slots_used"], ssr_history=hist,
                              **flags)
        hist = o["ssr_history"]
        ldr, _, new_hist = run["frames"][f]
        for what, a, b in (("ldr", ldr[0], o["ldr"]), ("history", new_hist[0], hist)):
            diff = (a - b).abs().flatten()
            mean, p99 = float(diff.mean()), float(torch.quantile(diff, 0.99))
            assert mean < SEAM_MEAN and p99 < SEAM_P99, (f, what, mean, p99)
        assert float(new_hist[0][..., 6].max()) == f + 1


def test_launcher_raises_on_failure_timeout_and_missing_cards():
    """(c) No fallback: a task that raises in its ranks ends the launch with
    that rank's traceback; ranks still running at the limit are killed and
    the launch raises TimeoutError; NCCL with more ranks than cards raises
    before any rank starts (this host has none)."""
    with pytest.raises(RuntimeError, match="has no len"):
        launch.run(len, 1, 2, backend="gloo", device="cpu", timeout=LIMIT)
    with pytest.raises(TimeoutError):
        launch.run(launch.render_job, 1, 1, backend="gloo", device="cpu",
                   timeout=1.0, job=entry.dryrun_job(1, 1))
    with pytest.raises(RuntimeError, match="one card each"):
        launch.run(len, 1, 2, backend="nccl", device="cuda", timeout=LIMIT)
