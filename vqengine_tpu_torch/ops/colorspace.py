"""Color-space curves — counterpart of ``vqengine_tpu/ops/colorspace.py``
(HDR.hlsl): the exact piecewise sRGB pair and the tonemapper's 2-sqrt sRGB
polynomial, the pow-2.2 texture decode, the Rec. 709 <-> Rec. 2020
primaries and the ST.2084 (PQ) curve of the HDR10 output.

Every jnp.power of the reference is glibc's powf (powf below), and its
3x3 color matrix products sum in the order XLA's CPU dot sums them
(color_matrix).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .raster import _fma, div_true

# PQ reference display (HDR.hlsl:44)
ST2084_MAX = 10000.0

# display curve enum (HDR.hlsl:35-37)
DISPLAY_CURVE_SRGB = 0
DISPLAY_CURVE_ST2084 = 1
DISPLAY_CURVE_LINEAR = 2

# color space enum (HDR.hlsl:40-41)
COLOR_SPACE_REC709 = 0
COLOR_SPACE_REC2020 = 1


def linear_to_srgb_fast(c: torch.Tensor) -> torch.Tensor:
    """sRGB OETF with x^(1/2.4) replaced by the reference's 2-sqrt
    polynomial (max |error| 7e-4 on [0.0031308, 1])."""
    x = torch.clamp(c, 0.0, 1.0)
    u2 = torch.sqrt(x)
    u4 = torch.sqrt(u2)
    p = 0.11983648 * u4 + 1.23117423 * u2 - 0.49498088 * u2 * u4 + 0.14414322 * x
    return torch.where(x < 0.0031308, 12.92 * x, 1.055 * p - 0.055)


# the reference's exponents as its weak-typed Python floats round them
_F32_2_2 = float(np.float32(2.2))
_F32_2_4 = float(np.float32(2.4))
_F32_INV_2_4 = float(np.float32(1.0 / 2.4))
_F32_SRGB_CUT = float(np.float32(0.0031308))
_F32_SRGB_CUT_INV = float(np.float32(0.04045))

# glibc's powf (sysdeps/ieee754/flt-32/e_powf.c, the reference's libm): the
# tables and polynomials of its log2 (__powf_log2_data: 16 subintervals of
# [0x3f330000, 2 * 0x3f330000), (1/c, log2 c)) and its exp2
# (__exp2f_data: 2^(j/32) and the cubic), as glibc 2.36 stores them
_POWF_OFF = 0x3F330000
_POWF_LOG2_TAB = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POWF_LOG2_POLY = tuple(float.fromhex(a) for a in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2_TAB = tuple(float.fromhex(a) for a in (
    "0x1.0000000000000p+0", "0x1.059b0d3158574p+0", "0x1.0b5586cf9890fp+0",
    "0x1.11301d0125b51p+0", "0x1.172b83c7d517bp+0", "0x1.1d4873168b9aap+0",
    "0x1.2387a6e756238p+0", "0x1.29e9df51fdee1p+0", "0x1.306fe0a31b715p+0",
    "0x1.371a7373aa9cbp+0", "0x1.3dea64c123422p+0", "0x1.44e086061892dp+0",
    "0x1.4bfdad5362a27p+0", "0x1.5342b569d4f82p+0", "0x1.5ab07dd485429p+0",
    "0x1.6247eb03a5585p+0", "0x1.6a09e667f3bcdp+0", "0x1.71f75e8ec5f74p+0",
    "0x1.7a11473eb0187p+0", "0x1.82589994cce13p+0", "0x1.8ace5422aa0dbp+0",
    "0x1.93737b0cdc5e5p+0", "0x1.9c49182a3f090p+0", "0x1.a5503b23e255dp+0",
    "0x1.ae89f995ad3adp+0", "0x1.b7f76f2fb5e47p+0", "0x1.c199bdd85529cp+0",
    "0x1.cb720dcef9069p+0", "0x1.d5818dcfba487p+0", "0x1.dfc97337b9b5fp+0",
    "0x1.ea4afa2a490dap+0", "0x1.f50765b6e4540p+0"))
_EXP2_POLY = tuple(float.fromhex(a) for a in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2_SHIFT = float.fromhex("0x1.8p+47")    # 0x1.8p52 / 32: rounds to k / 32
_POWF_OFLOW = float.fromhex("0x1.fffffffa3aae2p+6")   # |x^y| may reach 2^128
_MIN_NORMAL = 2.0 ** -126


@functools.cache
def _powf_tables(device: torch.device) -> tuple:
    """(1/c, log2 c) [16] and 2^(j/32) [32] as f64 tensors on `device`
    (copied once per device)."""
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.tensor([a for a, _ in _POWF_LOG2_TAB], **f64),
            torch.tensor([b for _, b in _POWF_LOG2_TAB], **f64),
            torch.tensor(_EXP2_TAB, **f64))


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """glibc's powf(x, y) for f32 x >= 0 (or NaN) and y > 0 a number exact
    in f32, in
    f64 tensor ops: log2(x) from a 16-entry table and a quintic, y log2(x)
    split into k / 32 + r, 2^(k/32) from a 32-entry table times a cubic in
    r, rounded once to f32; a result below the smallest normal is 0 (as
    XLA flushes it), past 2^128 inf.
    glibc's FMA build contracts the polynomials' multiply-adds; the port
    rounds them twice in f64, which moves the f64 result by an ulp or two,
    far below what the final f32 rounding sees (0 of 200,000 values in
    [0, 1], the 256 RGBA8 levels and 500,000 values over [1e-45, 10]
    differ from the reference's jnp.power)."""
    invc_t, logc_t, exp2_t = _powf_tables(x.device)
    ix = x.view(torch.int32)
    tmp = ix - _POWF_OFF
    i = ((tmp >> 19) & 15).long()
    top = tmp & -0x800000                       # 0xff800000
    z = (ix - top).view(torch.float32).double()
    k = (top >> 23).double()
    a = _POWF_LOG2_POLY
    r = z * invc_t[i] - 1.0
    y0 = logc_t[i] + k
    r2 = r * r
    q = (a[2] * r + a[3]) * r2 + (a[4] * r + y0)
    logx = (a[0] * r + a[1]) * (r2 * r2) + q
    ylogx = logx * y
    kd = (ylogx + _EXP2_SHIFT) - _EXP2_SHIFT     # k / 32, k = round(32 ylogx)
    r = ylogx - kd
    kj = (kd * 32.0).long()
    # 2^(k/32): the table's 2^(j/32) with k // 32 added to its exponent
    s = exp2_t[kj & 31] * (((kj >> 5) + 1023) << 52).view(torch.float64)
    c = _EXP2_POLY
    e = ((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)) * s
    out = e.float()
    # XLA's CPU threads flush denormals: a result below 2^-126, and so the
    # power of a subnormal x, is 0
    out = torch.where((out < _MIN_NORMAL) | (x == 0.0), 0.0, out)
    out = torch.where(ylogx > _POWF_OFLOW, float("inf"), out)
    return torch.where(torch.isnan(x) | torch.isinf(x), x, out)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """HDR.hlsl:76-80, the exact piecewise sRGB OETF (x^(1/2.4) as powf)."""
    return torch.where(c < _F32_SRGB_CUT, 12.92 * c,
                       1.055 * powf(torch.abs(c), _F32_INV_2_4) - 0.055)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """HDR.hlsl:82-86, the exact piecewise sRGB EOTF (x^2.4 as powf; the
    divisions by 12.92 and 1.055 rounded once)."""
    return torch.where(c < _F32_SRGB_CUT_INV, div_true(c, 12.92),
                       powf(div_true(torch.abs(c + 0.055), 1.055), _F32_2_4))


def srgb_to_linear_fast(c: torch.Tensor) -> torch.Tensor:
    """ShadingMath.hlsl:65, the pow-2.2 approximation the forward-lighting
    shader uses for the albedo and emissive decode: the reference's
    jnp.power is libm's powf, which powf() mirrors (torch's f32 pow differs
    on 1.8% of inputs in [0, 1], its f64 pow rounded to f32 on 0.06%)."""
    return powf(torch.clamp(c.float(), min=0.0), _F32_2_2)


_REC709_TO_REC2020 = ((0.627402, 0.329292, 0.043306),
                      (0.069095, 0.919544, 0.011360),
                      (0.016394, 0.088028, 0.895578))
_REC2020_TO_REC709 = ((1.660496, -0.587656, -0.072840),
                      (-0.124547, 1.132895, -0.008348),
                      (-0.018154, -0.100597, 1.118751))


@functools.cache
def _matrix(m: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(m, dtype=torch.float32, device=device)


def _pair_rows(n: int) -> int:
    """Of N rows, how many lead rows XLA's CPU dot adds in pairs in output
    channels 0 and 1 (measured over N = 1-139 and around powers of two):
    whole blocks of 8 from N = 32 on, and below that for N of 16-19 and
    24-27 only."""
    if n < 16 or (n < 32 and (n // 4) % 2):
        return 0
    return n // 8 * 8


def color_matrix(c: torch.Tensor, m) -> torch.Tensor:
    """c [..., 3] @ m.T for a 3x3 f32 matrix m, summed as XLA's CPU dot
    sums the reference's `c @ M.T` over its N = c.numel() / 3 rows
    (measured, tools/rounding_probes_torch.py): output channel 2 is an FMA
    chain, fma(c2, m20, fma(c1, m21, p0)); channels 0 and 1 add their
    three products in pairs, (p0 + p1) + p2, in the lead rows _pair_rows(N)
    and run the FMA chain in the rest."""
    mt = _matrix(m, c.device)
    x = [c[..., None, j] for j in range(3)]
    col = [mt[:, j] for j in range(3)]
    p0 = x[0] * col[0]
    fma = _fma(x[2], col[2], _fma(x[1], col[1], p0))
    rows = c.numel() // 3
    lead = _pair_rows(rows)
    if lead == 0:
        return fma
    pairs = (p0[..., :2] + x[1] * col[1][:2]) + x[2] * col[2][:2]
    flat = torch.cat([pairs, fma[..., 2:]], dim=-1).reshape(rows, 3)
    if lead < rows:
        flat = torch.cat([flat[:lead], fma.reshape(rows, 3)[lead:]])
    return flat.reshape(fma.shape)


def rec709_to_rec2020(c: torch.Tensor) -> torch.Tensor:
    return color_matrix(c, _REC709_TO_REC2020)


def rec2020_to_rec709(c: torch.Tensor) -> torch.Tensor:
    return color_matrix(c, _REC2020_TO_REC709)


# the PQ constants (HDR.hlsl:110-119), each exact in f32
_PQ_M1 = 2610.0 / 4096.0 / 4
_PQ_M2 = 2523.0 / 4096.0 * 128
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32
_PQ_C3 = 2392.0 / 4096.0 * 32


def linear_to_st2084(c: torch.Tensor) -> torch.Tensor:
    """HDR.hlsl:110-119, the PQ curve (input normalized to ST2084_MAX):
    ((c1 + c2 |c|^m1) / (1 + c3 |c|^m1))^m2, both powers glibc's powf; the
    base rounds op by op as the reference's, so the ~79-fold m2 sees the
    same bits."""
    cp = powf(torch.abs(c), _PQ_M1)
    return powf((_PQ_C1 + _PQ_C2 * cp) / (1.0 + _PQ_C3 * cp), _PQ_M2)
