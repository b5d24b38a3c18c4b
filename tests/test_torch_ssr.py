"""Parity of the port's screen-space reflections (ops/ssr.py) and motion
vectors (graph.motion_vectors) with the JAX package on the CPU, and of
render_forward's engine-default passes: the hi-Z march (dense and
compacted), the denoiser with and without history, motion and depth, the
composite, motion vectors on the static path (with per-item overrides) and
the palette path, a Default frame with SSAO, motion vectors and SSR over two
frames with the history carried, tests/test_ssr.py's thirteen properties on
the port, and the goldens default_ssao and default_ssr through the port.

The reference runs op by op (its raster kernels and ops/sparse.py compiled
whole, which leaves their outputs bit for bit: test_torch_slice
.compiled_rasters, test_torch_msaa._EXACT), at one set of shapes: the 64x64
floor-and-wall scene of tests/test_ssr.py, a 27x48 denoiser input, and the
Default scene at 96x54 (its reflections traced at 13x24, denoised at 27x48).
The march's integer selections are compared, not only its colours: every
step's pyramid fetch is recorded on both sides (the reference's
gather_scalar_rows4, the port's ssao._gather; the flat index holds the level
and the cell), the final texel comes out of a trace of a colour that holds
each pixel's own index, and the denoiser's reprojection and blur level are
held against the reference's own expressions (ssr.py:368-375, :386-391).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from test_torch_msaa import _EXACT
from test_torch_slice import compiled_rasters, jax_load_scene
from vqengine_tpu.ops import ssao as jssao
from vqengine_tpu.ops import ssr as jssr
from vqengine_tpu.render import graph as jg
from vqengine_tpu.render.renderer import VQRendererTPU
from vqengine_tpu.utils import math3d as jm3
from vqengine_tpu_torch.engine.goldens import golden_scores, render_golden
from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
from vqengine_tpu_torch.ops import ssao as tssao
from vqengine_tpu_torch.ops import ssr as tssr
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render.renderer import (VQRendererTorch,
                                                frame_constants_numpy)
from vqengine_tpu_torch.utils import math3d as tm3

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 96, 54                   # the Default frames
DH, DW = 27, 48                 # the denoiser's inputs (W, H at half)
LDR_TOL = 3e-4                  # the multichip bar of the reference
# the motion vectors' previous-frame rows go through a 4x4 inverse, which
# torch.linalg.inv and the reference's LU solve round otherwise (a quarter
# of the entries differ by an ulp or two)
MOTION_TOL = 2e-5
HIST_TOL = 1e-5                 # the reflections carry the shading's ulps


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(out, ref, what=""):
    out, ref = bits(out), bits(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref, what)


def mismatches(ref_list, port_list) -> list[int]:
    assert len(ref_list) == len(port_list) > 0
    return [int((bits(a) != bits(b)).sum()) for a, b in zip(ref_list, port_list)]


@pytest.fixture(scope="module", autouse=True)
def compiled_exact_ops():
    """The reference's ops/sparse.py compiled whole (it rounds nothing)."""
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in _EXACT]
    for mod, name, static in _EXACT:
        setattr(mod, name, jax.jit(getattr(mod, name), static_argnames=static))
    yield
    for mod, name, fn in orig:
        setattr(mod, name, fn)


def _index_color(h: int, w: int) -> np.ndarray:
    """[h, w, 3] whose red channel is the pixel's flat index (exact in f32):
    a trace of it returns each ray's final texel."""
    c = np.zeros((h, w, 3), np.float32)
    c[..., 0] = np.arange(h * w, dtype=np.float32).reshape(h, w)
    c[..., 1] = 1.0
    return c


@contextlib.contextmanager
def recorded(rec: dict):
    """While the context lasts, record on both sides: every pyramid fetch
    (SSAO taps and DDA steps, "fetch"), every trace's final texels (a second
    trace of _index_color, "texel"), and each denoise's reprojection index
    and blur level (the reference's by its own expressions, "reproject",
    "level")."""
    for k in ("fetch", "texel", "reproject", "level"):
        rec.setdefault(k, ([], []))
    saved = [(jssao, "gather_scalar_rows4"), (jssr, "gather_scalar_rows4"),
             (tssao, "_gather"), (tssr, "_gather"),
             (jssr, "trace_reflections"), (tssr, "trace_reflections"),
             (jssr, "denoise_reflections"), (tssr, "denoise_reflections")]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    j_gather, t_gather = jssao.gather_scalar_rows4, tssao._gather
    j_trace, t_trace = jssr.trace_reflections, tssr.trace_reflections
    j_dn, t_dn = jssr.denoise_reflections, tssr.denoise_reflections

    def jg_(flat, idx):
        rec["fetch"][0].append(np.asarray(idx))
        return j_gather(flat, idx)

    def tg_(flat, idx):
        rec["fetch"][1].append(idx.numpy().copy())
        return t_gather(flat, idx)

    def jt(color, *a, **k):
        h, w = color.shape[:2]
        rec["texel"][0].append(np.asarray(
            j_trace(jnp.asarray(_index_color(h, w)), *a, **k)[0])[..., 0])
        return j_trace(color, *a, **k)

    def tt(color, *a, **k):
        h, w = color.shape[:2]
        rec["texel"][1].append(
            t_trace(torch.from_numpy(_index_color(h, w)), *a, **k)[0][..., 0])
        return t_trace(color, *a, **k)

    def jd(refl, conf, rough, history=None, motion=None, **k):
        h, w = refl.shape[:2]
        hist = history
        if history is not None and history.shape[-1] < 7:
            hist = jnp.concatenate([history, jnp.zeros(
                history.shape[:-1] + (7 - history.shape[-1],))], axis=-1)
        if history is not None and motion is not None:
            idx = ref_reproject(motion, h, w)
            rec["reproject"][0].append(np.asarray(idx))
            hist = hist.reshape(-1, 7)[idx]
        rec["level"][0].append(np.asarray(ref_blur_level(rough, hist)))
        return j_dn(refl, conf, rough, history, motion, **k)

    def td(refl, conf, rough, history=None, motion=None, **k):
        h, w = refl.shape[:2]
        hist = history
        if history is not None and history.shape[-1] < 7:
            hist = torch.cat([history, torch.zeros(
                history.shape[:-1] + (7 - history.shape[-1],))], dim=-1)
        if history is not None and motion is not None:
            idx = tssr.reproject_index(motion, h, w)
            rec["reproject"][1].append(idx.numpy())
            hist = hist.reshape(-1, 7)[idx.long()]
        rec["level"][1].append(tssr.blur_level(rough, hist, 4).numpy())
        return t_dn(refl, conf, rough, history, motion, **k)
    jssao.gather_scalar_rows4 = jssr.gather_scalar_rows4 = jg_
    tssao._gather = tssr._gather = tg_
    jssr.trace_reflections, tssr.trace_reflections = jt, tt
    jssr.denoise_reflections, tssr.denoise_reflections = jd, td
    try:
        yield rec
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def ref_reproject(motion, h, w):
    """The reference's history index (ssr.py:368-376, no band)."""
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
    px = xs - motion[..., 0] * (w * 0.5)
    py = ys + motion[..., 1] * (h * 0.5)
    ty = jnp.clip(py.astype(jnp.int32), 0, h - 1)
    tx = jnp.clip(px.astype(jnp.int32), 0, w - 1)
    return ty * w + tx


def ref_blur_level(roughness, hist, n_mips=4):
    """The reference's prefilter level (ssr.py:386-391)."""
    lvl_f = roughness * 4.0
    if hist is not None:
        tvar = jnp.maximum(hist[..., 5] - hist[..., 4] ** 2, 0.0)
        lvl_f = lvl_f + jnp.clip(tvar * 8.0, 0.0, 1.5)
    return jnp.clip(lvl_f.astype(jnp.int32), 0, n_mips - 1)


def floor_and_wall_scene(h=64, w=64, fov=60.0):
    """tests/test_ssr.py's scene: the camera at the origin looking +Z, a
    floor (y = -1) in the lower half and a bright wall at z = 20 -> numpy
    (color, depth, normals, proj params, is_floor) and the view matrix on
    both sides."""
    near, far = 0.1, 100.0
    fov_y = np.deg2rad(fov)
    tan_half = np.tan(fov_y / 2)
    ndc_y = 1.0 - (np.arange(h) + 0.5) / h * 2.0
    ndc_x = (np.arange(w) + 0.5) / w * 2.0 - 1.0
    ny, _ = np.meshgrid(ndc_y, ndc_x, indexing="ij")
    z_floor = np.where(ny < -0.02, 1.0 / np.maximum(-ny * tan_half, 1e-3), np.inf)
    z_wall = np.full((h, w), 20.0)
    zv = np.minimum(z_floor, z_wall).astype(np.float32)
    depth = ((far / (far - near)) - (near * far / (far - near)) / zv).astype(np.float32)
    is_floor = z_floor < z_wall
    normals = np.where(is_floor[..., None], np.array([0, 1, 0], np.float32),
                       np.array([0, 0, -1], np.float32)).astype(np.float32)
    color = np.where(is_floor[..., None], np.array([0.1, 0.1, 0.1], np.float32),
                     np.array([5.0, 0.2, 0.2], np.float32)).astype(np.float32)
    info = np.asarray([near, far, fov_y, w / h], np.float32)
    eye, target = (0, 0, 0), (0, 0, 10)
    return dict(color=color, depth=depth, normals=normals, info=info,
                is_floor=is_floor, jview=jnp.asarray(jm3.look_at_lh(eye, target)),
                tview=torch.from_numpy(tm3.look_at_lh(eye, target)))


@pytest.fixture(scope="module")
def scene():
    return floor_and_wall_scene()


def _trace(side, s, color=None, **kw):
    color = s["color"] if color is None else color
    if side == "ref":
        return jssr.trace_reflections(jnp.asarray(color), jnp.asarray(s["depth"]),
                                      jnp.asarray(s["normals"]), s["jview"],
                                      jnp.asarray(s["info"]), **kw)
    return tssr.trace_reflections(torch.from_numpy(color), torch.from_numpy(s["depth"]),
                                  torch.from_numpy(s["normals"]), s["tview"],
                                  torch.from_numpy(s["info"]), **kw)


# ---------------------------------------------------------------------------
# the march, the denoiser, the composite
# ---------------------------------------------------------------------------

def test_blue_noise_and_constants_verbatim():
    for h, w in ((13, 24), (64, 64)):
        np.testing.assert_array_equal(tssr._blue_noise(h, w), jssr._blue_noise(h, w))
    assert tssr.HISTORY_CHANNELS == jssr.HISTORY_CHANNELS
    assert tuple(tssr.init_history(5, 7).shape) == jssr.init_history(5, 7).shape
    assert not bool(tssr.init_history(5, 7).any())


@pytest.mark.parametrize("mode", ["dense", "compacted"])
def test_trace_reflections_matches_jax(scene, mode):
    """The hi-Z march on the floor-and-wall scene, dense and compacted
    (ray_frac 2, with a ray weight that prunes the top rows): every step's
    pyramid fetch and every final texel equal (0 mismatches), the hit mask
    (conf > 0) equal, conf and the reflected colour bitwise, the ray
    saturation equal."""
    kw = {}
    if mode == "compacted":
        wgt = np.where(np.arange(64)[:, None] < 20, 0.0, 1.0) * np.ones((64, 64))
        kw = dict(ray_frac=2)
    rec = {}
    j_tel, t_tel = {}, {}
    with recorded(rec):
        jkw = dict(kw, telemetry=j_tel)
        tkw = dict(kw, telemetry=t_tel)
        if mode == "compacted":
            jkw["ray_weight"] = jnp.asarray(wgt, jnp.float32)
            tkw["ray_weight"] = torch.from_numpy(wgt.astype(np.float32))
        r_refl, r_conf = jssr.trace_reflections(
            jnp.asarray(scene["color"]), jnp.asarray(scene["depth"]),
            jnp.asarray(scene["normals"]), scene["jview"],
            jnp.asarray(scene["info"]), **jkw)
        t_refl, t_conf = tssr.trace_reflections(
            torch.from_numpy(scene["color"]), torch.from_numpy(scene["depth"]),
            torch.from_numpy(scene["normals"]), scene["tview"],
            torch.from_numpy(scene["info"]), **tkw)
    fetch, texel = rec["fetch"], rec["texel"]
    assert mismatches(*fetch) == [0] * 2 * 14          # both traces, 14 steps
    assert mismatches(*texel) == [0]
    assert_bitwise(t_conf, r_conf, "conf")
    assert_bitwise(t_refl, r_refl, "refl")
    hits = int((t_conf > 0).sum())
    assert hits > 50
    assert {k: float(v) for k, v in t_tel.items()} == {
        k: float(v) for k, v in j_tel.items()}
    if mode == "compacted":
        assert float(t_tel["ssr_rays"]) > 0 and not bool(t_conf[:20].any())


def _denoise_inputs(case: str):
    """Seeded DH x DW denoiser inputs: reflections with bright specks,
    confidence, roughness across the blur levels (and on their steps), a
    7-channel history whose moments make the variance clamp and the
    consistency test act on part of the frame (4 channels for "history4"),
    motion of up to +-6 pixels and depth with disocclusions."""
    rng = np.random.default_rng({"none": 1, "history": 2, "motion": 3,
                                 "history4": 4}[case])
    refl = rng.uniform(0, 1, (DH, DW, 3)).astype(np.float32)
    refl[rng.random((DH, DW)) < 0.05] = 6.0
    conf = rng.uniform(0, 1, (DH, DW)).astype(np.float32)
    rough = rng.uniform(0, 1, (DH, DW)).astype(np.float32)
    rough[: DH // 3] = (rng.integers(0, 5, (DH // 3, DW)) / 4.0).astype(np.float32)
    depth = rng.uniform(5, 40, (DH, DW)).astype(np.float32)
    hist = np.concatenate([
        rng.uniform(0, 2, (DH, DW, 3)),
        (depth * np.where(rng.random((DH, DW)) < 0.2, 1.5, 1.0))[..., None],
        rng.uniform(0, 1, (DH, DW, 1)), rng.uniform(0, 1.5, (DH, DW, 1)),
        rng.integers(0, 33, (DH, DW, 1))], -1).astype(np.float32)
    motion = (rng.uniform(-6, 6, (DH, DW, 2)) / np.array([DW * 0.5, DH * 0.5])
              ).astype(np.float32)
    kw = {"none": {}, "history": dict(history=hist),
          "motion": dict(history=hist, motion=motion, depth=depth),
          "history4": dict(history=hist[..., :4], depth=depth)}[case]
    return refl, conf, rough, kw


@pytest.mark.parametrize("case", ["none", "history", "motion", "history4"])
def test_denoise_matches_jax(case):
    """denoise_reflections without history, with a 7-channel history, with
    history, motion and depth, and with a 4-channel history (zero-padded):
    the reprojection index and the blur level equal to the reference's
    expressions on every pixel, the output and the new history bitwise."""
    refl, conf, rough, kw = _denoise_inputs(case)
    rec = {}
    with recorded(rec):
        ref = jssr.denoise_reflections(jnp.asarray(refl), jnp.asarray(conf),
                                       jnp.asarray(rough), temporal_alpha=0.7,
                                       **{k: jnp.asarray(v) for k, v in kw.items()})
        out = tssr.denoise_reflections(torch.from_numpy(refl), torch.from_numpy(conf),
                                       torch.from_numpy(rough), temporal_alpha=0.7,
                                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert mismatches(*rec["level"]) == [0]
    if case == "motion":
        assert mismatches(*rec["reproject"]) == [0]
        assert len(np.unique(rec["reproject"][1][0])) > DH * DW // 4
    assert len(np.unique(rec["level"][1][0])) == 4
    assert_bitwise(out[0], ref[0], "denoised")
    assert_bitwise(out[1], ref[1], "history")


def test_local_stats_luminance_and_composite_bitwise():
    """_local_minmax3, _local_moments3, _luminance and apply_reflections on
    seeded inputs, bitwise."""
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 3, (DH, DW, 3)).astype(np.float32)
    for a, b in zip(tssr._local_minmax3(torch.from_numpy(x)),
                    jssr._local_minmax3(jnp.asarray(x))):
        assert_bitwise(a, b)
    for a, b in zip(tssr._local_moments3(torch.from_numpy(x)),
                    jssr._local_moments3(jnp.asarray(x))):
        assert_bitwise(a, b)
    assert_bitwise(tssr._luminance(torch.from_numpy(x)), jssr._luminance(jnp.asarray(x)))
    n = rng.normal(size=(DH, DW, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.normal(size=(DH, DW, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    args = [x, rng.uniform(0, 4, (DH, DW, 3)), rng.uniform(0, 1, (DH, DW)),
            rng.uniform(0, 1, (DH, DW)), rng.uniform(0, 1, (DH, DW)),
            rng.uniform(0, 1, (DH, DW, 3)), n, v]
    args = [np.asarray(a, np.float32) for a in args]
    assert_bitwise(tssr.apply_reflections(*map(torch.from_numpy, args)),
                   jssr.apply_reflections(*map(jnp.asarray, args)))


# ---------------------------------------------------------------------------
# motion vectors
# ---------------------------------------------------------------------------

MOVED = (2, 5)                  # items whose transform changed


@pytest.fixture(scope="module")
def motion_case():
    """The Default scene at W x H: its port G-buffer (wpos, tri_id, mask,
    per-pixel item ids) and both sides' FrameConstants for a frame whose
    camera turned since the last and whose items MOVED moved (prev_world
    and prev_view_proj of the earlier pose)."""
    ps = load_scene("Default", W, H)
    b, cams, lights = jax_load_scene("Default", W, H)
    world, _ = ps.buffers.world_matrices()
    prev_world = world.copy()
    for i in MOVED:
        prev_world[i, :3, 3] += np.float32(0.4 * (i + 1))
    prev_vp = ps.cameras[0].view_projection()
    ps.cameras[0].yaw += 4.0
    cams[0].yaw += 4.0
    tc = tg.frame_constants_from_numpy(frame_constants_numpy(
        ps.buffers, ps.cameras[0], ps.lights, prev_world=prev_world,
        prev_view_proj=prev_vp), CPU)
    jc = VQRendererTPU().build_frame_constants(
        b, cams[0], lights, prev_world=prev_world, prev_view_proj=prev_vp)
    ts = tg.upload_scene(ps.buffers, CPU)
    _, tri_id, attrs, mask, _ = tg.geometry_pass(ts, tc, W, H)
    item = attrs["ids"][..., 1].to(torch.int32)
    assert set(MOVED) <= set(np.unique(item[mask].numpy()).tolist())
    return dict(ts=ts, tc=tc, js=jg.upload_scene(b), jc=jc, wpos=attrs["wpos"],
                tri_id=tri_id, mask=mask, item=item)


@pytest.mark.parametrize("ids", [(), MOVED, None, tuple(range(17))],
                         ids=["static", "moved", "palette", "17_items"])
def test_motion_vectors_matches_jax(motion_case, ids):
    """motion_vectors on the static path (camera reprojection only), with
    per-item overrides for the moved items, on the palette path (K3's
    [N, 12] rows; None) and with 17 items (the palette path again): within
    MOTION_TOL of the reference given the same G-buffer, bitwise where no
    inverse enters (the static path); the moved items' pixels move
    otherwise than the camera alone moves them."""
    m = motion_case
    args = (m["wpos"], m["tri_id"], m["mask"])
    out = tg.motion_vectors(m["ts"], m["tc"], *args, item_id=m["item"],
                            dynamic_item_ids=ids)
    ref = jg.motion_vectors(m["js"], m["jc"], *(jnp.asarray(a.numpy()) for a in args),
                            item_id=jnp.asarray(m["item"].numpy()),
                            dynamic_item_ids=ids)
    print(f"\n{ids if ids is None or len(ids) < 17 else '17 items'}: max |motion "
          f"diff| {float(np.abs(out.numpy() - np.asarray(ref)).max()):.3g}, "
          f"pixels differing {int((out.numpy() != np.asarray(ref)).sum())}")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=MOTION_TOL)
    if ids == ():
        assert_bitwise(out, ref)
    assert float(out.abs().max()) > 1e-2
    assert not bool(out[~m["mask"]].any())
    if ids != ():
        static = tg.motion_vectors(m["ts"], m["tc"], *args, item_id=m["item"],
                                   dynamic_item_ids=())
        moved = torch.zeros_like(m["mask"])
        for i in MOVED:
            moved |= m["item"] == i
        assert float((out - static)[moved].abs().max()) > 1e-3
        np.testing.assert_allclose(out[~moved].numpy(), static[~moved].numpy(),
                                   rtol=0, atol=MOTION_TOL)


@pytest.mark.parametrize("ids", [MOVED, None, tuple(range(17))],
                         ids=["moved", "palette", "17_items"])
def test_motion_vectors_with_inverse_bitwise(motion_case, ids):
    """graph.inv4 mirrors the reference's jnp.linalg.inv (LAPACK's sgetrf
    and two strsm): the items' inverses bitwise, and with them the motion
    vectors on the per-item and palette paths."""
    m = motion_case
    world = m["tc"].world
    assert_bitwise(tg.inv4(world), jnp.linalg.inv(m["jc"].world), "inverse")
    args = (m["wpos"], m["tri_id"], m["mask"])
    out = tg.motion_vectors(m["ts"], m["tc"], *args, item_id=m["item"],
                            dynamic_item_ids=ids)
    ref = jg.motion_vectors(m["js"], m["jc"], *(jnp.asarray(a.numpy()) for a in args),
                            item_id=jnp.asarray(m["item"].numpy()),
                            dynamic_item_ids=ids)
    assert_bitwise(out, ref, "motion")


def test_inv4_matches_jax():
    """graph.inv4 bitwise against jnp.linalg.inv on 400 random rigid
    transforms (rotation, scale, translation, as world matrices) and 400
    random matrices, batched and one at a time."""
    rng = np.random.default_rng(12)
    rigid = []
    for _ in range(400):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        m = np.eye(4)
        m[:3, :3] = q * rng.uniform(0.5, 30.0)
        m[:3, 3] = rng.uniform(-900.0, 900.0, 3)
        rigid.append(m.T)
    a = np.concatenate([np.asarray(rigid, np.float32),
                        rng.standard_normal((400, 4, 4)).astype(np.float32)])
    assert_bitwise(tg.inv4(torch.from_numpy(a)), jnp.linalg.inv(jnp.asarray(a)))
    assert_bitwise(tg.inv4(torch.from_numpy(a[7])), jnp.linalg.inv(jnp.asarray(a[7])))


def test_static_camera_motion_is_zero(motion_case):
    """Nothing moved (prev_view_proj = view_proj, prev_world = world): the
    static path gives exactly 0 on both sides; the palette path within
    MOTION_TOL of 0 (the inverse's ulps), as in the reference."""
    m = motion_case
    still = dataclasses.replace(m["tc"], prev_view_proj=m["tc"].view_proj,
                                prev_world=m["tc"].world)
    jstill = dataclasses.replace(m["jc"], prev_view_proj=m["jc"].view_proj,
                                 prev_world=m["jc"].world)
    args = (m["wpos"], m["tri_id"], m["mask"])
    out = tg.motion_vectors(m["ts"], still, *args, dynamic_item_ids=())
    ref = jg.motion_vectors(m["js"], jstill, *(jnp.asarray(a.numpy()) for a in args),
                            dynamic_item_ids=())
    assert not bool(out.any()) and not np.asarray(ref).any()
    pal = tg.motion_vectors(m["ts"], still, *args, dynamic_item_ids=None)
    assert float(pal.abs().max()) < MOTION_TOL


# ---------------------------------------------------------------------------
# the engine's default passes on a Default frame, two frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def default_frames():
    """Two Default frames at W x H through both packages: SSAO "medium",
    motion vectors (static path), SSR with the first frame's history carried
    into the second, whose camera turned; shadows off (the reference's
    shadow views would dominate the cost). Each side loads the scene with
    its own host modules; the recorded selections of each frame."""
    ps = load_scene("Default", W, H)
    b, cams, lights = jax_load_scene("Default", W, H)
    ts, js = tg.upload_scene(ps.buffers, CPU), jg.upload_scene(b)
    kw = dict(enable_shadows=False, enable_ssao=True, enable_motion_vectors=True,
              enable_ssr=True, dynamic_item_ids=())
    frames, prev, th, jh = [], None, None, None
    for turn in (0.0, 3.0):
        ps.cameras[0].yaw += turn
        cams[0].yaw += turn
        tc_np = frame_constants_numpy(ps.buffers, ps.cameras[0], ps.lights,
                                      prev_view_proj=prev)
        tc = tg.frame_constants_from_numpy(tc_np, CPU)
        jc = VQRendererTPU().build_frame_constants(b, cams[0], lights,
                                                   prev_view_proj=prev)
        rec = {}
        with recorded(rec):
            with compiled_rasters():
                ref = jg.render_forward(js, jc, W, H, ssr_history=jh, **kw)
            out = tg.render_forward(ts, tc, W, H, ssr_history=th, **kw)
        ref = {k: np.asarray(v) for k, v in ref.items() if k != "saturation"}
        frames.append(dict(ref=ref, port=out, rec=rec))
        prev, jh, th = tc_np["view_proj"], jnp.asarray(ref["ssr_history"]), \
            out["ssr_history"]
    return frames


@pytest.mark.parametrize("frame", [0, 1])
def test_default_frame_matches_jax(default_frames, frame):
    """The Default frame with the engine's SSAO, motion vectors and SSR:
    tri_id bitwise; every SSAO tap fetch, DDA step fetch, final texel,
    history reprojection and blur level equal to the reference's (0
    mismatches); ldr within LDR_TOL, ao and motion bitwise (the
    static path), the SSR history within HIST_TOL; the second frame's
    camera turned, so its motion is not 0 and its history was reprojected."""
    f = default_frames[frame]
    ref, out, rec = f["ref"], f["port"], f["rec"]
    assert_bitwise(out["tri_id"], ref["tri_id"], "tri_id")
    for k in ("fetch", "texel", "level") + (("reproject",) if frame else ()):
        mm = mismatches(*rec[k])
        assert mm == [0] * len(mm), k
    assert len(rec["fetch"][0]) == 12 + 2 * 14      # SSAO taps, two traces
    diff = {k: float(np.abs(out[k].numpy() - ref[k]).max())
            for k in ("ldr", "ao", "motion", "ssr_history")}
    print(f"\nframe {frame}: max |diff| {diff}")
    assert diff["ldr"] <= LDR_TOL, diff
    assert_bitwise(out["ao"], ref["ao"], "ao")
    assert_bitwise(out["motion"], ref["motion"], "motion")
    assert diff["ssr_history"] <= HIST_TOL, diff
    assert tuple(out["ssr_history"].shape) == (H // 2, W // 2, tssr.HISTORY_CHANNELS)
    moving = float(out["motion"].abs().max())
    assert (moving > 1e-3) if frame else (moving == 0.0)
    assert float(out["ssr_history"][..., 6].max()) == frame + 1.0


def test_engine_default_flags():
    """render_flags maps FGraphicsSettings' compiled defaults to the frame
    the engine renders: MSAA, SSAO "medium", motion vectors, SSR, ESM."""
    assert render_flags(FGraphicsSettings()) == dict(
        msaa=True, enable_ssao=True, ssao_quality="medium",
        enable_motion_vectors=True, enable_ssr=True, shadow_filter="esm")
    with pytest.raises(NotImplementedError):
        render_flags(FGraphicsSettings(RenderScale=0.5))


def test_renderer_engine_default_frames():
    """VQRendererTorch.render with the engine's default flags on the
    Default scene at 64x32 (MSAA with the neighbor and the shade edge
    resolve, cached maps, the scene's sky at small table sizes): two frames with the history
    carried by the caller and the camera turned; the output keys; a
    dynamic set of 17 items gives the palette path's frame."""
    s = load_scene("Default", 64, 32)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers)
    r.env = tg.build_environment(s.equirect[::8, ::8], CPU, diffuse_size=4,
                                 specular_base=8, lut_size=16)
    flags = render_flags(FGraphicsSettings())
    c0 = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    maps = r.precompute_shadow_maps(c0, (16, 16, 16))
    out = r.render(c0, 64, 32, shadow_dims=(16, 16, 16), shadow_maps=maps,
                   dynamic_item_ids=(), **flags)
    assert {"ao", "motion", "ssr_history"} <= set(out)
    s.cameras[0].yaw += 5.0
    c1 = r.build_frame_constants(s.buffers, s.cameras[0], s.lights,
                                 prev_view_proj=c0.view_proj.numpy())
    for mode in ("neighbor", "shade"):
        out1 = r.render(c1, 64, 32, shadow_dims=(16, 16, 16), shadow_maps=maps,
                        ssr_history=out["ssr_history"], dynamic_item_ids=(),
                        msaa_edge_resolve=mode, **flags)
        assert bool(torch.isfinite(out1["ldr"]).all())
        assert float(out1["motion"].abs().max()) > 1e-3
        assert float(out1["ssr_history"][..., 6].max()) == 2.0
    many = r.render(c1, 64, 32, shadow_dims=(16, 16, 16), shadow_maps=maps,
                    ssr_history=out["ssr_history"],
                    dynamic_item_ids=tuple(range(17)), **flags)
    pal = r.render(c1, 64, 32, shadow_dims=(16, 16, 16), shadow_maps=maps,
                   ssr_history=out["ssr_history"], dynamic_item_ids=None, **flags)
    assert torch.equal(many["motion"], pal["motion"])


@pytest.fixture(scope="module")
def default_env():
    """The Default scene's environment maps at the engine's default sizes
    (what VQRendererTorch.load_scene builds), built once for both goldens.
    One BLAS thread: the LUT's least-squares fit otherwise spins eight
    threads on a host that the other test workers already load."""
    with threadpool_limits(limits=1):
        return tg.build_environment(load_scene("Default", 192, 108).equirect, CPU)


@pytest.mark.parametrize("golden", ["default_ssao", "default_ssr"])
def test_default_goldens_on_port(default_env, golden):
    """The goldens default_ssao and default_ssr (tests/test_golden.py:166-169:
    Default with SSAO "medium", or with SSR; no MSAA, 64^2 shadow maps)
    through the port on the CPU, on one build of the scene's environment."""
    s = golden_scores(golden, render_golden(golden, CPU, env=default_env))
    assert s["ok"], s


# ---------------------------------------------------------------------------
# tests/test_ssr.py's properties, on the port
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _hist(rgb, depth=None, n=8.0):
    """7-channel history: rgb | depth | lum mu | lum m2 | sample n, the
    moments consistent with a steady signal at rgb."""
    h, w = rgb.shape[:2]
    depth = torch.zeros((h, w)) if depth is None else depth
    lum = tssr._luminance(rgb)
    return torch.cat([rgb, depth[..., None], lum[..., None], (lum * lum)[..., None],
                      torch.full((h, w, 1), n)], dim=-1)


def _prop_floor_reflects_wall():
    s = floor_and_wall_scene()
    refl, conf = _trace("port", s)
    refl, conf = refl.numpy(), conf.numpy()
    assert np.isfinite(refl).all() and np.isfinite(conf).all()
    assert (conf >= 0).all() and (conf <= 1).all()
    hit = s["is_floor"] & (conf > 0.5)
    assert hit.sum() > 50 and refl[hit][:, 0].mean() > 1.0


def _prop_wall_pixels_low_confidence():
    s = floor_and_wall_scene()
    assert _trace("port", s)[1].numpy()[~s["is_floor"]].mean() < 0.2


def _prop_temporal_blend():
    out, nh = tssr.denoise_reflections(torch.full((32, 32, 3), 0.5), torch.ones(32, 32),
                                       torch.zeros(32, 32),
                                       _hist(torch.full((32, 32, 3), 0.5)),
                                       temporal_alpha=0.75)
    np.testing.assert_allclose(out.numpy(), 0.5, atol=1e-5)
    assert tuple(nh.shape) == (32, 32, tssr.HISTORY_CHANNELS)


def _prop_zero_history_bootstraps_clean():
    out, nh = tssr.denoise_reflections(torch.full((16, 16, 3), 0.3), torch.ones(16, 16),
                                       torch.zeros(16, 16), tssr.init_history(16, 16),
                                       temporal_alpha=0.9)
    np.testing.assert_allclose(out.numpy(), 0.3, atol=1e-5)
    assert float(nh[..., 6].min()) >= 1.0


def _prop_ghost_history_clamped():
    out, _ = tssr.denoise_reflections(torch.full((32, 32, 3), 0.2), torch.ones(32, 32),
                                      torch.zeros(32, 32),
                                      _hist(torch.full((32, 32, 3), 10.0)),
                                      temporal_alpha=0.75)
    np.testing.assert_allclose(out.numpy(), 0.2, atol=1e-4)


def _prop_variance_clamp_kills_inbounds_ghost():
    cur = torch.full((16, 16, 3), 0.2)
    cur[8, 8] = 5.0
    hist = _hist(torch.full((16, 16, 3), 0.2))
    hist[7:10, 7:10, :3] = 3.0
    out, _ = tssr.denoise_reflections(cur, torch.ones(16, 16), torch.zeros(16, 16),
                                      hist, temporal_alpha=0.9)
    assert float(out[7, 7].max()) < 0.5 and float(out[9, 9].max()) < 0.5


def _checker():
    yy, xx = np.mgrid[0:8, 0:8]
    base = np.where(((xx + yy) % 2) == 0, 0.1, 0.3).astype(np.float32)
    return _t(np.repeat(base[..., None], 3, axis=-1))


def _prop_sample_count_ramps_trust():
    refl, d = _checker(), torch.full((8, 8), 0.9)
    kw = dict(temporal_alpha=0.9, depth=d)
    young, nh = tssr.denoise_reflections(refl, torch.ones(8, 8), torch.zeros(8, 8),
                                         _hist(torch.full((8, 8, 3), 0.25), d, 1.0), **kw)
    old, _ = tssr.denoise_reflections(refl, torch.ones(8, 8), torch.zeros(8, 8),
                                      _hist(torch.full((8, 8, 3), 0.25), d, 32.0), **kw)
    pull_young = float((young - refl).abs().mean())
    assert float((old - refl).abs().mean()) > pull_young * 1.5
    assert float(nh[..., 6].min()) > 1.0 and float(nh[..., 6].max()) == 2.0


def _prop_disocclusion_drops_history():
    refl, now = _checker(), torch.full((8, 8), 0.9)
    rgb = torch.full((8, 8, 3), 0.25)
    same, _ = tssr.denoise_reflections(refl, torch.ones(8, 8), torch.zeros(8, 8),
                                       _hist(rgb, now), temporal_alpha=0.75, depth=now)
    dis, nh = tssr.denoise_reflections(refl, torch.ones(8, 8), torch.zeros(8, 8),
                                       _hist(rgb, torch.full((8, 8), 0.2)),
                                       temporal_alpha=0.75, depth=now)
    assert float((same - refl).abs().max()) > 0.05
    np.testing.assert_allclose(dis.numpy(), refl.numpy(), atol=1e-5)
    np.testing.assert_allclose(nh[..., 6].numpy(), 1.0, atol=1e-5)


def _prop_moving_ghost_sequence():
    w = 32
    dark = torch.full((8, w, 3), 0.1)
    bright = dark.clone()
    bright[:, :16] = 1.0
    d = torch.full((8, w), 0.5)
    hist = tssr.init_history(8, w)
    for _ in range(6):
        _, hist = tssr.denoise_reflections(bright, torch.ones(8, w), torch.zeros(8, w),
                                           hist, temporal_alpha=0.9, depth=d)
    panned = dark.clone()
    panned[:, :8] = 1.0
    motion = torch.zeros((8, w, 2))
    motion[..., 0] = -8.0 / (w * 0.5)
    out, _ = tssr.denoise_reflections(panned, torch.ones(8, w), torch.zeros(8, w), hist,
                                      motion=motion, temporal_alpha=0.9, depth=d)
    assert float(out[:, 10:14].max()) < 0.2


def _prop_rough_pixels_blurred():
    img = torch.zeros((32, 32, 3))
    img[16, 16] = 10.0
    out_s, _ = tssr.denoise_reflections(img, torch.ones(32, 32), torch.zeros(32, 32))
    out_r, _ = tssr.denoise_reflections(img, torch.ones(32, 32), torch.full((32, 32), 0.9))
    assert float(out_s.max()) > float(out_r.max())


def _prop_smooth_metal_gets_reflection():
    up = torch.tensor([0.0, 1.0, 0.0]).expand(8, 8, 3)
    args = (torch.full((8, 8, 3), 0.1), torch.full((8, 8, 3), 2.0), torch.ones(8, 8))
    metal = tssr.apply_reflections(*args, torch.full((8, 8), 0.05), torch.ones(8, 8),
                                   torch.full((8, 8, 3), 0.9), up, up)
    rough = tssr.apply_reflections(*args, torch.full((8, 8), 0.95), torch.zeros(8, 8),
                                   torch.full((8, 8, 3), 0.9), up, up)
    assert float(metal.mean()) > float(rough.mean()) + 0.5


def _prop_compacted_matches_dense_on_active():
    s = floor_and_wall_scene()
    dense_r, dense_c = (a.numpy() for a in _trace("port", s))
    comp_r, comp_c = (a.numpy() for a in _trace("port", s, ray_frac=2))
    active = comp_c > 0
    assert active.any()
    np.testing.assert_allclose(comp_c[active], dense_c[active], atol=1e-6)
    np.testing.assert_allclose(comp_r[active], dense_r[active], atol=1e-6)
    assert not ((~active) & (dense_c > 1e-3)).any()


def _prop_ray_weight_prunes():
    s = floor_and_wall_scene()
    wgt = _t(np.where(np.arange(64)[:, None] < 32, 0.0, 1.0) * np.ones((64, 64)))
    _, c = _trace("port", s, ray_frac=2, ray_weight=wgt)
    c = c.numpy()
    assert (c[:32] == 0).all() and (c[32:] > 0).any()


PROPERTIES = {name[len("_prop_"):]: fn for name, fn in globals().items()
              if name.startswith("_prop_")}


@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_ssr_properties_on_port(prop):
    """tests/test_ssr.py's thirteen properties (the march, the denoiser's
    temporal resolve, clamps and disocclusion, the composite, the ray
    compaction), on the port."""
    PROPERTIES[prop]()
