"""Parity of the port's post tail with the JAX package on the CPU: CAS,
RCAS, EASU and FSR1 (ops/ffx.py), the gaussian blur, the ST.2084 tonemap
and its pieces (ops/postprocess.py, ops/colorspace.py: the PQ curve, the
Rec. 709/2020 matrices, the exact sRGB pair) and the debug views
(ops/visualization.py: every draw mode, the magnifier and the outline),
each on identical seeded f32 inputs with flat areas, edges and values
above 1; and tests/test_ffx.py's CAS, RCAS and EASU properties on the
port.

The reference runs op by op at one set of shapes (48x27 images; EASU from
32x18 at 2x and at 1.5x). Its selections are recorded as it computes them
(a stand-in for its module's jnp that keeps the outputs of its floor,
sqrt, where and clip calls) and compared element for element with the
port's (the `record` argument): EASU's tap origin and direction mask and
its deringing bounds, the magnifier's source texels and its lens and ring
masks, the outline's rim. Every output is bitwise the reference's where
the rounding rules of ROADMAP queue 3 reach; the bar is 1e-6.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqengine_tpu.ops._backend  # noqa: F401  (the reference's matmul precision)
from vqengine_tpu.ops import colorspace as jcs
from vqengine_tpu.ops import ffx as jffx
from vqengine_tpu.ops import postprocess as jpp
from vqengine_tpu.ops import visualization as jviz
from vqengine_tpu_torch.ops import colorspace as tcs
from vqengine_tpu_torch.ops import ffx as tffx
from vqengine_tpu_torch.ops import postprocess as tpp
from vqengine_tpu_torch.ops import visualization as tviz

torch.set_num_threads(1)

H, W = 27, 48                    # the images
SH, SW = 18, 32                  # EASU's source
TOL = 1e-6


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_match(out, ref, what=""):
    """Within TOL, and bitwise (the rounding rules reach every function
    here)."""
    out_np = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out_np.shape == ref.shape, (what, out_np.shape, ref.shape)
    np.testing.assert_allclose(out_np, ref, rtol=0, atol=TOL, err_msg=what)
    np.testing.assert_array_equal(bits(out_np), bits(ref), what)


def image(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w, 3] f32: noise up to 2.5 over a flat band (top third), a hard
    edge from 0.1 to 3.0 (middle third) and a smooth ramp (bottom)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 2.5, (h, w, 3)).astype(np.float32)
    a, b = h // 3, 2 * h // 3
    img[:a] = 0.4
    img[a:b, : w // 2] = 0.1
    img[a:b, w // 2:] = 3.0
    ramp = np.linspace(0.0, 1.6, w, dtype=np.float32)
    img[b:, :, 1] = ramp
    return img


IMG = image(H, W, 0)
LDR = np.clip(IMG / (IMG + 1.0), 0, 1).astype(np.float32)
SRC = image(SH, SW, 1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(a)


@contextlib.contextmanager
def recorded_jnp(module, rec: dict):
    """While the context lasts, `module`'s jnp keeps the outputs of floor
    and sqrt, the conditions of where and the bounds of clip, in call
    order (rec["floor"], rec["sqrt"], rec["where"], rec["clip"])."""
    for k in ("floor", "sqrt", "where", "clip"):
        rec[k] = []
    real = module.jnp

    def floor(x):
        rec["floor"].append(np.asarray(real.floor(x)))
        return real.floor(x)

    def sqrt(x):
        rec["sqrt"].append(np.asarray(real.sqrt(x)))
        return real.sqrt(x)

    def where(c, *a):
        rec["where"].append(np.asarray(c))
        return real.where(c, *a)

    def clip(x, lo=None, hi=None):
        rec["clip"].append((np.asarray(x), np.asarray(lo), np.asarray(hi)))
        return real.clip(x, lo, hi)

    class Recording(types.SimpleNamespace):
        def __getattr__(self, name):
            return getattr(real, name)

    module.jnp = Recording(floor=floor, sqrt=sqrt, where=where, clip=clip)
    try:
        yield rec
    finally:
        module.jnp = real


# ---------------------------------------------------------------------------
# ops/ffx.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sharpness", [0.0, 0.5, 1.0])
def test_cas_matches(sharpness):
    assert_match(tffx.cas(t(IMG), sharpness), jffx.cas(j(IMG), sharpness))


@pytest.mark.parametrize("stops", [0.0, 0.2, 1.5])
def test_rcas_matches(stops):
    assert_match(tffx.rcas(t(LDR), stops), jffx.rcas(j(LDR), stops))


@pytest.mark.parametrize("out_hw", [(2 * SH, 2 * SW), (27, 48)])
def test_easu_matches(out_hw):
    """EASU at 2x (32x18 -> 64x36) and 1.5x (-> 48x27), with its integer
    tap origin, direction mask and deringing bounds equal element for
    element."""
    oh, ow = out_hw
    rec = {}
    with recorded_jnp(jffx, {}) as jrec:
        ref = jffx.easu(j(SRC), oh, ow)
    out = tffx.easu(t(SRC), oh, ow, record=rec)
    assert_match(out, ref, "easu")
    x0, y0 = jrec["floor"]
    np.testing.assert_array_equal(rec["x0i"].numpy(), x0.astype(np.int32))
    np.testing.assert_array_equal(rec["y0i"].numpy(), y0.astype(np.int32))
    (dl,) = jrec["sqrt"]
    valid = rec["valid"].numpy()
    np.testing.assert_array_equal(valid, dl > np.float32(1e-5))
    assert valid.any() and not valid.all()        # edges and flat areas
    _, lo, hi = jrec["clip"][-1]
    assert_match(rec["lo"], lo, "lo")
    assert_match(rec["hi"], hi, "hi")


def test_fsr1_matches():
    rec = {}
    assert_match(tffx.fsr1(t(SRC), 27, 48, record=rec),
                 jffx.fsr1(j(SRC), 27, 48), "fsr1")
    assert rec["x0i"].shape == (27, 48)


def test_gaussian_blur_matches():
    for radius, sigma in ((4, 2.0), (2, 1.2)):
        assert_match(tpp.gaussian_blur(t(IMG), radius, sigma),
                     jpp.gaussian_blur(j(IMG), radius, sigma), "blur")


# ---------------------------------------------------------------------------
# ops/colorspace.py, ops/postprocess.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space", [tcs.COLOR_SPACE_REC709, tcs.COLOR_SPACE_REC2020])
@pytest.mark.parametrize("brightness", [200.0, 1000.0])
def test_tonemap_st2084_matches(space, brightness):
    kw = dict(content_color_space=space,
              display_reference_brightness=brightness)
    assert_match(tpp.tonemap(t(IMG), tcs.DISPLAY_CURVE_ST2084, **kw),
                 jpp.tonemap(j(IMG), jcs.DISPLAY_CURVE_ST2084, **kw), "st2084")


def test_colorspace_matches():
    """The PQ curve (two powf: m2 scales every ulp of the base ~79-fold),
    the Rec. 709/2020 matrices (the CPU dot's sum order, color_matrix) and
    the exact sRGB pair."""
    big = IMG * np.float32(40.0)
    assert_match(tcs.linear_to_st2084(t(IMG / 50)), jcs.linear_to_st2084(j(IMG / 50)), "pq")
    assert_match(tcs.rec709_to_rec2020(t(big)), jcs.rec709_to_rec2020(j(big)), "709->2020")
    assert_match(tcs.rec2020_to_rec709(t(big)), jcs.rec2020_to_rec709(j(big)), "2020->709")
    levels = np.concatenate([LDR.ravel(), np.arange(256, dtype=np.float32) / 255])
    assert_match(tcs.linear_to_srgb(t(levels)), jcs.linear_to_srgb(j(levels)), "oetf")
    assert_match(tcs.srgb_to_linear(t(levels)), jcs.srgb_to_linear(j(levels)), "eotf")


# ---------------------------------------------------------------------------
# ops/visualization.py
# ---------------------------------------------------------------------------

def gbuffer(seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rng.uniform(0.9, 1.0, (H, W)).astype(np.float32)
    depth[:, :6] = 1.0
    oid = rng.integers(-1, 12, (H, W)).astype(np.int32)
    oid[0, :4] = [2**31 - 1, 2**30 + 7, 123456789, 65537]
    return dict(depth=depth, normals=n,
                roughness=rng.uniform(0, 1, (H, W)).astype(np.float32),
                metalness=rng.uniform(0, 1, (H, W)).astype(np.float32),
                ao=rng.uniform(0, 1, (H, W)).astype(np.float32),
                albedo=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
                motion=rng.uniform(-0.1, 0.1, (H, W, 2)).astype(np.float32),
                object_id=oid)


GBUF = gbuffer()


@pytest.mark.parametrize("mode", range(9))
def test_visualize_matches(mode):
    out = tviz.visualize(mode, t(LDR), **{k: t(v) for k, v in GBUF.items()})
    ref = jviz.visualize(mode, j(LDR), **{k: j(v) for k, v in GBUF.items()})
    assert_match(out, ref, f"mode {mode}")
    assert mode == 0 or not np.array_equal(out.numpy(), LDR)


@pytest.mark.parametrize("kw", [dict(), dict(center_uv=(0.08, 0.85), radius=0.4,
                                              magnification=2.5, border_px=3)])
def test_magnifier_matches(kw):
    """The lens at the center and one off the corner (source texels
    clamped at the image border), with its taps and masks equal."""
    rec = {}
    with recorded_jnp(jviz, {}) as jrec:
        ref = jviz.magnifier(j(LDR), **kw)
    out = tviz.magnifier(t(LDR), **kw, record=rec)
    assert_match(out, ref, "magnifier")
    (tx, _, _), (ty, _, _) = jrec["clip"]
    np.testing.assert_array_equal(rec["tx"].numpy(), np.broadcast_to(
        np.clip(tx, 0, W - 1), (H, W)))
    np.testing.assert_array_equal(rec["ty"].numpy(), np.broadcast_to(
        np.clip(ty, 0, H - 1), (H, W)))
    inside, ring = jrec["where"]
    np.testing.assert_array_equal(rec["inside"].numpy(), inside[..., 0])
    np.testing.assert_array_equal(rec["ring"].numpy(), ring[..., 0])
    assert rec["inside"].any() and rec["ring"].any()


def test_outline_matches():
    oid = np.full((H, W), -1, np.int32)
    oid[8:16, 10:22] = 3
    oid[0:5, 40:] = 3               # wraps around the border (jnp.roll)
    oid[20:24, 2:6] = 5
    rec = {}
    with recorded_jnp(jviz, {}) as jrec:
        ref = jviz.outline(j(LDR), j(oid), 3)
    out = tviz.outline(t(LDR), t(oid), 3, record=rec)
    assert_match(out, ref, "outline")
    (rim,) = jrec["where"]
    np.testing.assert_array_equal(rec["rim"].numpy(), rim[..., 0])
    assert rec["rim"][H - 1].any()


# ---------------------------------------------------------------------------
# tests/test_ffx.py's CAS, RCAS and EASU properties on the port
# ---------------------------------------------------------------------------

def checker(h=32, w=32, period=8):
    y, x = np.mgrid[0:h, 0:w]
    v = (((y // period) + (x // period)) % 2).astype(np.float32)
    return np.stack([v, v, v], -1)


class TestCas:
    def test_flat_image_unchanged(self):
        img = torch.full((16, 16, 3), 0.5)
        np.testing.assert_allclose(tffx.cas(img, 0.5).numpy(), 0.5, atol=1e-5)

    def test_sharpening_increases_contrast(self):
        img = t(checker() * 0.5 + 0.25)
        blurred = tpp.gaussian_blur(img, radius=2, sigma=1.0)
        out = tffx.cas(blurred, 1.0).numpy()
        assert out.std() > blurred.numpy().std()
        assert np.isfinite(out).all()


class TestRcas:
    def test_flat_unchanged(self):
        img = torch.full((16, 16, 3), 0.25)
        np.testing.assert_allclose(tffx.rcas(img).numpy(), 0.25, atol=1e-5)

    def test_sharpens(self):
        img = t(checker() * 0.6 + 0.2)
        blurred = tpp.gaussian_blur(img, radius=2, sigma=1.2)
        out = tffx.rcas(blurred, sharpness_stops=0.0).numpy()
        assert out.std() > blurred.numpy().std() * 1.01


class TestEasu:
    def test_identity_scale_close_to_source(self):
        # smooth gradient image (the lanczos lobes ring on pure noise)
        y, x = np.mgrid[0:24, 0:24].astype(np.float32) / 24
        img = np.stack([x, y, 0.5 * (x + y)], -1)
        out = tffx.easu(t(img), 24, 24).numpy()
        assert np.abs(out - img).mean() < 0.02

    def test_upscale_shape_and_range(self):
        out = tffx.easu(t(checker(20, 20, 5)), 40, 40).numpy()
        assert out.shape == (40, 40, 3)
        assert out.min() >= -1e-4 and out.max() <= 1 + 1e-4  # deringing clamp

    def test_edges_stay_sharper_than_bilinear(self):
        # vertical edge upscaled 2x: EASU's edge adaptation should produce
        # fewer intermediate values than bilinear
        img = np.zeros((16, 16, 3), np.float32)
        img[:, 8:] = 1.0
        out = tffx.easu(t(img), 32, 32).numpy()
        mid_fraction = ((out[:, :, 0] > 0.2) & (out[:, :, 0] < 0.8)).mean()
        assert mid_fraction < 0.2

    def test_fsr1_pipeline(self):
        out = tffx.fsr1(t(checker(16, 16, 4) * 0.8), 32, 32).numpy()
        assert out.shape == (32, 32, 3)
        assert np.isfinite(out).all()
