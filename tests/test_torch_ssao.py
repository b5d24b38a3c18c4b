"""Parity of the port's SSAO (ops/ssao.py) and SPD mip pyramid (ops/ffx.py)
with the JAX package on the CPU: every function on seeded inputs, each
preset of the CACAO ladder, render_forward's SSAO branch on a Default
frame's G-buffer, and tests/test_ssao.py's ten properties on the port (the
default_ssao golden runs in tests/test_torch_ssr.py beside default_ssr, so
that one process builds the default environment's BRDF LUT for both).

The reference runs op by op, at one set of shapes (the 96x48 Default
frame's half and quarter resolution; the step scene at the half),
its artefacts shared through module-scoped fixtures; its ops/sparse.py runs
compiled whole, which leaves its outputs bit for bit
(test_torch_msaa._EXACT). Each tap's pyramid fetch is recorded on both
sides (the reference's gather_scalar_rows4, the port's ssao._gather): the
flat index holds the tap's level and texel, so equal indices mean 0 level
mismatches. Where the two libraries' exp round otherwise (the blur and the
upsample weights), the comparison states its bar.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_msaa import _EXACT
from vqengine_tpu.ops import ffx as jffx
from vqengine_tpu.ops import ssao as jssao
from vqengine_tpu.render import graph as jg
from vqengine_tpu.utils import math3d as jm3
from vqengine_tpu_torch.engine.scene_load import load_scene
from vqengine_tpu_torch.ops import ffx as tffx
from vqengine_tpu_torch.ops import ssao as tssao
from vqengine_tpu_torch.render import graph as tg
from vqengine_tpu_torch.render.renderer import VQRendererTorch
from vqengine_tpu_torch.utils import math3d as tm3

torch.set_num_threads(1)

CPU = torch.device("cpu")
FW, FH = 96, 48                 # the Default frame: every preset fits
H2, W2 = FH // 2, FW // 2       # the step scene: the frame's half resolution
BLUR_TOL = 2e-6                 # the blur's exp weights: ulps of exp
PRESETS = list(tssao.PRESETS)


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(out, ref, what=""):
    out, ref = bits(out), bits(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref, what)


@pytest.fixture(scope="module", autouse=True)
def compiled_exact_ops():
    """The reference's ops/sparse.py compiled whole (as in
    tests/test_torch_msaa.py; it rounds nothing)."""
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in _EXACT]
    for mod, name, static in _EXACT:
        setattr(mod, name, jax.jit(getattr(mod, name), static_argnames=static))
    yield
    for mod, name, fn in orig:
        setattr(mod, name, fn)


@contextlib.contextmanager
def recorded(ref_calls: list, port_calls: list, blur: dict | None = None):
    """Record every tap's flat pyramid index on both sides (and, with blur,
    the AO each side hands to its blur: the unblurred result)."""
    j_gather, t_gather = jssao.gather_scalar_rows4, tssao._gather
    j_blur, t_blur = jssao._bilateral_blur, tssao._bilateral_blur

    def jg_(flat, idx):
        ref_calls.append(np.asarray(idx))
        return j_gather(flat, idx)

    def tg_(flat, idx):
        port_calls.append(idx.numpy().copy())
        return t_gather(flat, idx)

    def jb(ao, zv, *a, **k):
        blur["ref"] = np.asarray(ao)
        return j_blur(ao, zv, *a, **k)

    def tb(ao, zv, *a, **k):
        blur["port"] = ao.clone()
        return t_blur(ao, zv, *a, **k)
    jssao.gather_scalar_rows4, tssao._gather = jg_, tg_
    if blur is not None:
        jssao._bilateral_blur, tssao._bilateral_blur = jb, tb
    try:
        yield
    finally:
        jssao.gather_scalar_rows4, tssao._gather = j_gather, t_gather
        jssao._bilateral_blur, tssao._bilateral_blur = j_blur, t_blur


def fetch_mismatches(ref_calls, port_calls) -> list[int]:
    assert len(ref_calls) == len(port_calls) > 0
    return [int((bits(a) != bits(b)).sum()) for a, b in zip(ref_calls, port_calls)]


def ndc_depth(zv, near=0.1, far=100.0):
    return (far / (far - near)) - (near * far / (far - near)) / zv


def view_infos(eye=(0, 0, 0), target=(0, 0, 5), fov_deg=60.0):
    """The same view on both sides: (reference info, port info)."""
    base = {"near": 0.1, "far": 100.0, "fov_y": np.deg2rad(fov_deg)}
    return ({**base, "view": jnp.asarray(jm3.look_at_lh(eye, target))},
            {**base, "view": torch.from_numpy(tm3.look_at_lh(eye, target))})


@pytest.fixture(scope="module")
def step_scene():
    """A seeded half-resolution buffer: a depth step (contact occlusion),
    a second vertical step, noise on the far plane, normals tilted about
    the view axis -> numpy (depth [H2, W2], normals [H2, W2, 3])."""
    rng = np.random.default_rng(11)
    zv = np.full((H2, W2), 10.6, np.float32)
    zv[:, : W2 // 2] = 10.0
    zv[: H2 // 4] = 10.3
    zv += rng.uniform(0, 0.3, (H2, W2)).astype(np.float32) * (zv > 10.5)
    depth = ndc_depth(zv).astype(np.float32)
    n = rng.normal(size=(H2, W2, 3)).astype(np.float32) * 0.3
    n[..., 2] = -1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return depth, n.astype(np.float32)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,reduce,num_mips", [
    ((37, 50), "mean", None), ((37, 50, 3), "mean", 4), ((37, 50, 1), "mean", 3),
    ((37, 50), "min", 4), ((37, 50, 3), "max", None), ((48, 128), "mean", 5),
    ((24, 32, 2), "mean", None)])
def test_spd_mip_pyramid_bitwise(shape, reduce, num_mips):
    """spd_mip_pyramid on 2-D and 3-D inputs of odd sizes (truncated) and
    of power-of-two rows (where XLA sums a 2x2 block in pairs, not left to
    right): every level bitwise."""
    x = np.random.default_rng(3).uniform(0.1, 50, shape).astype(np.float32)
    ref = jffx.spd_mip_pyramid(jnp.asarray(x), num_mips=num_mips, reduce=reduce)
    out = tffx.spd_mip_pyramid(torch.from_numpy(x), num_mips=num_mips,
                               reduce=reduce)
    assert len(out) == len(ref) >= 3
    for a, b in zip(out, ref):
        assert_bitwise(a, b)


def test_view_depth_and_normals_bitwise(step_scene):
    """view_depth_from_ndc with Python and with 0-d f32 near/far, and the
    view-space normals (an FMA chain, as XLA rounds the three-term einsum),
    bitwise."""
    depth, n = step_scene
    d = depth.copy()
    d[0, :5] = 1.0                              # background -> far
    for near, far in ((0.1, 100.0), (np.float32(0.25), np.float32(3000.0))):
        ref = jssao.view_depth_from_ndc(jnp.asarray(d), jnp.asarray(near),
                                        jnp.asarray(far))
        out = tssao.view_depth_from_ndc(
            torch.from_numpy(d), torch.as_tensor(near, dtype=torch.float32),
            torch.as_tensor(far, dtype=torch.float32))
        assert_bitwise(out, ref)
    ref = jssao.view_depth_from_ndc(jnp.asarray(d), 0.1, 100.0)
    assert_bitwise(tssao.view_depth_from_ndc(torch.from_numpy(d), 0.1, 100.0), ref)
    rv, tv = view_infos(eye=(1, 2, -5), target=(0, 0, 5))
    assert_bitwise(tssao.view_normals(tv["view"], torch.from_numpy(n)),
                   jnp.einsum("ij,hwj->hwi", rv["view"][:3, :3], jnp.asarray(n)))


def test_spiral_taps_verbatim():
    for num, seed in ((4, 7), (12, 7), (12, 20), (8, 31)):
        np.testing.assert_array_equal(tssao._spiral_taps(num, seed),
                                      jssao._spiral_taps(num, seed))
    assert tssao.PRESETS == jssao.PRESETS


def _ref_level(d: np.ndarray, n_mips: int = 4) -> np.ndarray:
    """The reference's tap level (ssao.py:91-93) of f32 distances."""
    return np.asarray(jnp.clip(jnp.log2(jnp.maximum(jnp.asarray(d), 1.0)) - 3.0,
                               0, n_mips - 1).astype(jnp.int32))


def test_tap_level_thresholds_found_again():
    """MIP_DIST_THRESHOLDS are where the reference's level steps: found again
    over 200,000 f32 values either side of 2^(k+3), where the reference's
    level is monotone; tap_level equals the reference on them and on
    seeded distances, for 1 to 4 pyramid levels."""
    found = []
    for k in (1, 2, 3):
        c = np.float32(2.0 ** (k + 3)).view(np.int32)
        b = np.arange(c - 200_000, c + 200_000, dtype=np.int32)
        ge = _ref_level(b.view(np.float32)) >= k
        first = int(np.argmax(ge))
        assert ge[first:].all() and not ge[:first].any(), k
        found.append(int(b[first]))
    assert tuple(found) == tssao.MIP_DIST_THRESHOLD_BITS
    d = np.concatenate([
        np.random.default_rng(4).uniform(0, 150, 20_000).astype(np.float32),
        *[np.arange(t - 3000, t + 3000, dtype=np.int32).view(np.float32)
          for t in found]])
    for n_mips in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            tssao.tap_level(torch.from_numpy(d), n_mips).numpy(),
            _ref_level(d, n_mips))


def test_tan_half_matches_jax():
    """tan_half (libm's tanf of the f32 half angle) against the reference's
    jnp.tan(fov_y * 0.5) on 2,000 seeded f32 angles, bitwise; torch's tan
    rounds otherwise on some of them."""
    fov = np.random.default_rng(2).uniform(0.2, 2.6, 2000).astype(np.float32)
    ref = np.asarray(jnp.tan(jnp.asarray(fov) * 0.5))
    out = np.array([tssao.tan_half(torch.tensor(f)) for f in fov], np.float32)
    assert_bitwise(out, ref)
    assert tssao.tan_half(np.deg2rad(60.0)) == float(
        jnp.tan(np.deg2rad(60.0) * 0.5))


def test_importance_map_bitwise():
    """The per-block contrast, its 3x3 smooth and the edge-padded broadcast
    on a frame of whole blocks and on a ragged one, bitwise."""
    rng = np.random.default_rng(6)
    for shape in ((H2, W2), (27, 50)):
        ao = rng.uniform(0, 1, shape).astype(np.float32)
        assert_bitwise(tssao.importance_map(torch.from_numpy(ao)),
                       jssao.importance_map(jnp.asarray(ao)))


def test_blur_and_upsample_match_jax(step_scene):
    """_bilateral_blur and upsample_bilateral (exact and short fine sizes)
    within BLUR_TOL: their weights go through exp, whose last ulp the two
    libraries round otherwise."""
    depth, _ = step_scene
    rng = np.random.default_rng(8)
    ao = rng.uniform(0.2, 1, (H2, W2)).astype(np.float32)
    zv = np.asarray(jssao.view_depth_from_ndc(jnp.asarray(depth), 0.1, 100.0))
    ref = jssao._bilateral_blur(jnp.asarray(ao), jnp.asarray(zv))
    out = tssao._bilateral_blur(torch.from_numpy(ao), torch.from_numpy(zv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=BLUR_TOL)
    zf = np.repeat(np.repeat(zv, 2, 0), 2, 1) + rng.uniform(0, 0.2, (2 * H2, 2 * W2))
    zf = zf.astype(np.float32)
    for fh, fw in ((2 * H2, 2 * W2), (2 * H2 - 1, 2 * W2 - 1)):
        ref = jssao.upsample_bilateral(jnp.asarray(ao), jnp.asarray(zv),
                                       jnp.asarray(zf[:fh, :fw]))
        out = tssao.upsample_bilateral(torch.from_numpy(ao), torch.from_numpy(zv),
                                       torch.from_numpy(zf[:fh, :fw]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=BLUR_TOL)
    with pytest.raises(ValueError):   # the reference's pad refuses it too
        tssao.upsample_bilateral(torch.from_numpy(ao), torch.from_numpy(zv),
                                 torch.zeros(2 * H2 + 1, 2 * W2))


# ---------------------------------------------------------------------------
# the presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_ssao_preset_matches_jax(step_scene, preset):
    """ssao() with each preset's taps, refinement and deinterleave on the
    step scene: every tap's level and texel equal (0 fetch mismatches), the
    AO before the blur bitwise, the refinement's saturation equal, the
    blurred AO within BLUR_TOL."""
    depth, n = step_scene
    taps, extra, deint = tssao.PRESETS[preset]
    rv, tv = view_infos()
    kw = dict(radius_world=2.0, num_taps=taps, adaptive_taps=extra,
              deinterleave=deint)
    ref_calls, port_calls, blur = [], [], {}
    j_tel, t_tel = {}, {}
    with recorded(ref_calls, port_calls, blur):
        ref = jssao.ssao(jnp.asarray(depth), jnp.asarray(n), rv, telemetry=j_tel, **kw)
        out = tssao.ssao(torch.from_numpy(depth), torch.from_numpy(n), tv,
                         telemetry=t_tel, **kw)
    assert fetch_mismatches(ref_calls, port_calls) == [0] * len(ref_calls)
    assert len(ref_calls) == taps + extra
    assert_bitwise(blur["port"], blur["ref"], "ao before the blur")
    assert set(t_tel) == set(j_tel)
    for k in j_tel:
        assert float(t_tel[k]) == float(j_tel[k]), k
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=BLUR_TOL)
    assert float(out.min()) < 0.9        # the step occludes something


@pytest.fixture(scope="module")
def default_frame():
    """The Default scene's port renderer at FW x FH and its frame's depth
    and unit normals, as render_forward hands them to SSAO -> (renderer,
    FrameConstants, depth, normals)."""
    s = load_scene("Default", FW, FH)
    r = VQRendererTorch(CPU)
    r.load_scene(s.buffers)
    c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    depth, _, attrs, _, _ = tg.geometry_pass(r.scene, c, FW, FH)
    return r, c, depth, tg.unit3(attrs["wnrm"])


def _ref_branch(depth, n, pp, view, quality, tel):
    """The reference's SSAO branch of render_forward (graph.py:1466-1489),
    on jnp inputs."""
    info = {"near": pp[0], "far": pp[1], "fov_y": pp[2], "view": view}
    d_h, n_h = jg.pool2(depth), jg.pool2(n)
    if quality in ("lowest", "low"):
        d_q = jg.pool2(d_h)
        ao = jssao.ssao(d_q, jg.pool2(n_h), info,
                        num_taps=jssao.PRESETS[quality][0])
        ao = jssao.upsample_bilateral(ao, d_q, d_h)
    else:
        taps, extra, deint = jssao.PRESETS[quality]
        ao = jssao.ssao(d_h, n_h, info, num_taps=taps, adaptive_taps=extra,
                        deinterleave=deint, telemetry=tel)
    return jssao.upsample_bilateral(ao, d_h, depth)[:depth.shape[0], :depth.shape[1]]


@pytest.mark.parametrize("preset", PRESETS)
def test_render_ssao_branch_matches_jax(default_frame, preset):
    """VQRendererTorch.render with enable_ssao and each ssao_quality
    (lowest and low at quarter resolution) on the Default scene: out["ao"]
    against the reference's SSAO branch on the same depth and normals, 0
    tap fetch mismatches, within BLUR_TOL, the same saturation; the AO
    darkens the frame's ambient term and nothing else."""
    r, c, depth, n = default_frame
    ref_calls, port_calls = [], []
    j_tel = {}
    with recorded(ref_calls, port_calls):
        ref = _ref_branch(jnp.asarray(depth.numpy()), jnp.asarray(n.numpy()),
                          jnp.asarray(c.proj_params.numpy()),
                          jnp.asarray(c.view_matrix.numpy()), preset, j_tel)
        out = r.render(c, FW, FH, enable_shadows=False, env=None,
                       enable_ssao=True, ssao_quality=preset)
    assert fetch_mismatches(ref_calls, port_calls) == [0] * len(ref_calls)
    ao = out["ao"]
    assert ao.shape == (FH, FW)
    np.testing.assert_allclose(ao.numpy(), np.asarray(ref), rtol=0, atol=BLUR_TOL)
    for k in j_tel:
        assert float(out["saturation"][k]) == float(j_tel[k]), k
    assert float(ao.min()) < 0.95 and float(ao.max()) <= 1.0
    base = r.render(c, FW, FH, enable_shadows=False, env=None)
    assert "ao" not in base
    darker = out["hdr"] <= base["hdr"]
    assert bool(darker.all()) and not torch.equal(out["hdr"], base["hdr"])


# ---------------------------------------------------------------------------
# tests/test_ssao.py's properties, on the port
# ---------------------------------------------------------------------------

def _info(eye=(0, 0, 0)):
    return {"near": 0.1, "far": 100.0, "fov_y": np.deg2rad(60.0),
            "view": torch.from_numpy(tm3.look_at_lh(eye, (0, 0, 5)))}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _prop_view_depth_roundtrip():
    z = np.linspace(0.5, 50, 32).astype(np.float32)
    back = tssao.view_depth_from_ndc(_t(ndc_depth(z)), 0.1, 100.0).numpy()
    np.testing.assert_allclose(back, z, rtol=1e-3)


def _prop_background_is_far():
    out = tssao.view_depth_from_ndc(torch.ones((4, 4)), 0.1, 100.0).numpy()
    np.testing.assert_allclose(out, 100.0)


def _prop_flat_plane_unoccluded():
    depth = torch.full((64, 64), float(np.float32(ndc_depth(10.0))))
    normals = torch.tensor([0.0, 0.0, -1.0]).expand(64, 64, 3)
    assert float(tssao.ssao(depth, normals, _info()).mean()) > 0.9


def _step(h=64, w=64):
    depth = np.full((h, w), ndc_depth(10.5), np.float32)
    depth[:, : w // 2] = ndc_depth(10.0)
    normals = np.tile([0, 0, -1], (h, w, 1)).astype(np.float32)
    return _t(depth), _t(normals)


def _prop_corner_occluded():
    depth, normals = _step()
    ao = tssao.ssao(depth, normals, _info(), radius_world=2.0).numpy()
    assert ao[:, 33:36].mean() < ao[:, -8:].mean() - 0.05


def _prop_range_and_finite():
    rng = np.random.default_rng(0)
    depth = _t(ndc_depth(rng.uniform(5, 20, (32, 32))))
    n = rng.normal(size=(32, 32, 3)).astype(np.float32)
    n[..., 2] = -np.abs(n[..., 2]) - 0.5
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ao = tssao.ssao(depth, _t(n), {**_info((0, 2, -5))}).numpy()
    assert np.isfinite(ao).all() and (ao >= 0).all() and (ao <= 1).all()


def _prop_importance_map_flags_contrast():
    assert float(tssao.importance_map(torch.ones((32, 32))).max()) == 0.0
    checker = _t(np.indices((32, 32)).sum(0) % 2)
    assert float(tssao.importance_map(checker).max()) > 0.5


def _prop_adaptive_refines_toward_dense():
    depth, normals = _step()
    kw = dict(radius_world=2.0, skip_blur=True)
    base = tssao.ssao(depth, normals, _info(), num_taps=8, **kw).numpy()
    ref = tssao.ssao(depth, normals, _info(), num_taps=32, **kw).numpy()
    adapt = tssao.ssao(depth, normals, _info(), num_taps=8, adaptive_taps=8,
                       **kw).numpy()
    assert np.isfinite(adapt).all() and (adapt >= 0).all() and (adapt <= 1).all()
    refined = np.abs(adapt - base) > 1e-7
    assert refined.any()
    np.testing.assert_array_equal(adapt[8:-8, -8:], base[8:-8, -8:])
    assert (np.abs(adapt[refined] - ref[refined]).mean()
            < np.abs(base[refined] - ref[refined]).mean())


def _prop_upsample_bilateral_respects_depth_edges():
    h, w = 16, 16
    z_c = np.full((h, w), 0.8, np.float32)
    z_c[:, : w // 2] = 0.2
    ao_c = np.where(z_c < 0.5, 0.2, 1.0).astype(np.float32)
    z_f = np.repeat(np.repeat(z_c, 2, 0), 2, 1)
    up = tssao.upsample_bilateral(_t(ao_c), _t(z_c), _t(z_f)).numpy()
    assert up.shape == (2 * h, 2 * w)
    assert up[:, w + 1].min() > 0.95 and up[:, w - 2].max() < 0.25


def _truth(depth, normals, info, radius_world=2.0, num_taps=256):
    """tests/test_ssao.py's brute-force estimator (256 spiral taps on the
    full-resolution view depth; no pyramid, blur or compaction), in numpy
    on the port's own view_depth_from_ndc and spiral."""
    h, w = depth.shape
    zv = tssao.view_depth_from_ndc(depth, info["near"], info["far"]).numpy()
    tan_half = np.tan(info["fov_y"] * 0.5)
    ndc_x = ((np.arange(w) + 0.5) / w * 2.0 - 1.0)[None, :]
    ndc_y = (1.0 - (np.arange(h) + 0.5) / h * 2.0)[:, None]
    pos = np.stack([ndc_x * tan_half * (w / h) * zv, ndc_y * tan_half * zv, zv], -1)
    nv = np.einsum("ij,hwj->hwi", info["view"].numpy()[:3, :3], normals.numpy())
    r_px = np.clip(radius_world / (zv * tan_half * 2.0) * h, 2.0, 96.0)
    taps = tssao._spiral_taps(num_taps)
    occ = np.zeros((h, w), np.float32)
    py, px = np.mgrid[0:h, 0:w]
    for t in range(num_taps):
        sx = np.clip(px + 0.5 + taps[t, 0] * r_px, 0.5, w - 0.5)
        sy = np.clip(py + 0.5 + taps[t, 1] * r_px, 0.5, h - 0.5)
        z_t = zv[sy.astype(int), sx.astype(int)]
        sv = np.stack([((sx / w) * 2.0 - 1.0) * tan_half * (w / h) * z_t,
                       (1.0 - (sy / h) * 2.0) * tan_half * z_t, z_t], -1)
        d = sv - pos
        dist = np.linalg.norm(d, axis=-1)
        cos_h = (d / np.maximum(dist, 1e-6)[..., None] * nv).sum(-1)
        occ += np.clip(cos_h - 0.1, 0.0, 1.0) * np.clip(1.0 - dist / radius_world, 0, 1)
    ao = 1.0 - np.clip(occ / num_taps * 2.0, 0.0, 1.0)
    return ao * np.sqrt(ao)


def _prop_presets_monotone_and_close_to_truth():
    h, w = 96, 128
    depth = np.full((h, w), ndc_depth(10.6), np.float32)
    depth[:, : w // 2] = ndc_depth(10.0)
    depth[: h // 4] = ndc_depth(10.3)
    depth, normals = _t(depth), _t(np.tile([0, 0, -1], (h, w, 1)))
    truth = _truth(depth, normals, _info())
    errs = {}
    for name, (taps, extra, deint) in tssao.PRESETS.items():
        ao = tssao.ssao(depth, normals, _info(), radius_world=2.0, num_taps=taps,
                        adaptive_taps=extra, deinterleave=deint).numpy()
        errs[name] = float(np.abs(ao - truth).mean())
    order = ["lowest", "low", "medium", "high", "adaptive"]
    for a, b in zip(order, order[1:]):
        assert errs[b] <= errs[a] + 0.01, (a, b, errs)
    assert errs["high"] < 0.05 and errs["adaptive"] < 0.04, errs


def _prop_deinterleave_improves_effective_sampling():
    rng = np.random.default_rng(5)
    h, w = 96, 128
    zv = 10.0 + rng.uniform(0, 0.5, (h, w)).astype(np.float32)
    depth, normals = _t(ndc_depth(zv)), _t(np.tile([0, 0, -1], (h, w, 1)))
    truth = _truth(depth, normals, _info())
    mono = tssao.ssao(depth, normals, _info(), radius_world=2.0, num_taps=8)
    deint = tssao.ssao(depth, normals, _info(), radius_world=2.0, num_taps=8,
                       deinterleave=True)
    assert (np.abs(deint.numpy() - truth).mean()
            < np.abs(mono.numpy() - truth).mean())


PROPERTIES = {name[len("_prop_"):]: fn for name, fn in globals().items()
              if name.startswith("_prop_")}


@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_ssao_properties_on_port(prop):
    """tests/test_ssao.py's ten properties (view depth, the flat plane, the
    step's contact occlusion, range, the importance map, the adaptive
    refinement, the upsample's depth edges, the quality ladder against a
    brute-force integral, deinterleaving), on the port."""
    PROPERTIES[prop]()
