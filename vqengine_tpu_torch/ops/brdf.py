"""PBR BRDF math — counterpart of ``vqengine_tpu/ops/brdf.py`` (BRDF.hlsl:
GGX NDF :64-79, Smith-Schlick geometry :81-129, Schlick Fresnel :131-156,
Cook-Torrance :163-194, EnvironmentBRDF split-sum :196-207, GGX importance
sampling :217-238, BRDF-integration LUT :239-283; ShadingMath.hlsl
Hammersley :119-127).

Elementwise over [..., 3] / [...] tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import _backend
from .raster import _fma
from .shadow import _sqrt, norm3

PI = math.pi


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _dot(a, b):
    return (a * b).sum(dim=-1)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def norm(v):
    return torch.sqrt(_dot(v, v))


def normalize(v, eps: float = 1e-12):
    return v / torch.clamp(norm(v), min=eps)[..., None]


def reflect(i, n):
    """HLSL reflect(): i - 2*dot(n,i)*n; the dot sums left to right, as
    XLA reduces the reference's three products on the CPU."""
    p = n * i
    d = (p[..., 0] + p[..., 1]) + p[..., 2]
    return i - 2.0 * d[..., None] * n


def ndf_ggx(ndoth, roughness):
    """Trowbridge-Reitz GGX (BRDF.hlsl:65-79)."""
    a = roughness * roughness
    a2 = a * a
    nh2 = ndoth * ndoth
    denom = PI * torch.square(nh2 * (a2 - 1.0) + 1.0)
    return torch.where(denom < 1e-12, torch.ones_like(denom),
                       a2 / torch.clamp(denom, min=1e-12))


def geometry_smith_schlick_ggx(n, v, roughness):
    """Direct-lighting variant, k = (r+1)^2/8 (BRDF.hlsl:82-97)."""
    k = torch.square(roughness + 1.0) / 8.0
    nv = torch.clamp(_dot(n, v), min=0.0)
    return nv / (nv * (1.0 - k) + k + 1e-4)


def geometry_smith_schlick_ggx_ibl(n, v, roughness):
    """IBL variant, k = r^2/2 (BRDF.hlsl:100-115)."""
    k = torch.square(roughness) / 2.0
    nv = torch.clamp(_dot(n, v), min=0.0)
    return nv / (nv * (1.0 - k) + k + 1e-4)


def geometry_smith(n, v, l, roughness):
    """BRDF.hlsl:118-121."""
    return (geometry_smith_schlick_ggx(n, v, roughness)
            * geometry_smith_schlick_ggx(n, l, roughness))


def geometry_smith_ibl(n, v, l, roughness):
    """BRDF.hlsl:124-129."""
    return (geometry_smith_schlick_ggx_ibl(n, v, roughness)
            * geometry_smith_schlick_ggx_ibl(n, l, roughness))


def fresnel_schlick(n, v, f0):
    """BRDF.hlsl:132-136: F0 + (1-F0)*(1 - max(0, dot(N,V)))^5."""
    p = _pow5(1.0 - torch.clamp(_dot(n, v), min=0.0))
    return f0 + (1.0 - f0) * p[..., None]


def fresnel_with_roughness(cos_theta, f0, roughness):
    """BRDF.hlsl:152-156 (Lagarde) for IBL."""
    one_minus_r = (1.0 - roughness)[..., None]
    return f0 + (torch.maximum(one_minus_r, f0) - f0) * _pow5(1.0 - cos_theta)[..., None]


def lambert_diffuse(kd):
    """BRDF.hlsl:158-161."""
    return kd / PI


def brdf(normal, albedo, roughness, metalness, wi, v):
    """fr(s, Wi, V) as BRDF.hlsl:163-194 (Fresnel evaluated with (H, V))."""
    wo = normalize(v)
    n = normalize(normal)
    h = normalize(wo + wi)
    ndoth = saturate(_dot(n, h))
    ndotv = saturate(_dot(n, wo))
    ndotl = saturate(_dot(n, wi))

    f0 = 0.04 + (albedo - 0.04) * metalness[..., None]   # lerp(0.04, albedo, m)
    f = fresnel_schlick(h, v, f0)
    g = geometry_smith(n, wo, wi, roughness)
    d = ndf_ggx(ndoth, roughness)
    denom = torch.clamp(4.0 * ndotv * ndotl, min=1e-4)
    specular = d[..., None] * f * g[..., None] / denom[..., None]

    kd = (1.0 - f) * (1.0 - metalness[..., None])
    return lambert_diffuse(kd * albedo) + specular


def environment_brdf(ndotv, roughness, metallic, diffuse_color,
                     diffuse_irradiance, prefiltered_specular, f0_scale_bias):
    """Split-sum IBL combine (BRDF.hlsl:196-207).
    f0_scale_bias: [..., 2] from the BRDF-integration LUT."""
    f0 = 0.04 + (diffuse_color - 0.04) * metallic[..., None]
    ks = fresnel_with_roughness(ndotv, f0, roughness)
    kd = (1.0 - ks) * (1.0 - metallic[..., None])
    diffuse = diffuse_irradiance * diffuse_color
    specular = prefiltered_specular * (ks * f0_scale_bias[..., 0:1]
                                       + f0_scale_bias[..., 1:2])
    return kd * diffuse + specular


# ---------------------------------------------------------------------------
# quasi-Monte-Carlo sampling (ShadingMath.hlsl:87-127, BRDF.hlsl:217-283)
# ---------------------------------------------------------------------------

def radical_inverse_vdc(bits: torch.Tensor) -> torch.Tensor:
    """Van der Corput via 32-bit bit reversal (ShadingMath.hlsl:87-95), on
    int64 with masks (torch has no uint32 shifts)."""
    b = bits.to(torch.int64) & 0xFFFFFFFF
    b = ((b << 16) | (b >> 16)) & 0xFFFFFFFF
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    return b.to(torch.float32) * 2.3283064365386963e-10


def hammersley(i: torch.Tensor, count: int) -> torch.Tensor:
    """[N] -> [N, 2] low-discrepancy sequence (ShadingMath.hlsl:119-127)."""
    return torch.stack([i.to(torch.float32) / count, radical_inverse_vdc(i)],
                       dim=-1)


def importance_sample_ggx(xi: torch.Tensor, n: torch.Tensor,
                          roughness) -> torch.Tensor:
    """GGX-biased half-vector sampling (BRDF.hlsl:217-238).
    xi: [..., 2], n: [..., 3] -> h [..., 3] world space."""
    a = roughness * roughness
    phi = 2.0 * PI * xi[..., 0]
    cos_theta = torch.sqrt((1.0 - xi[..., 1])
                           / (1.0 + (a * a - 1.0) * xi[..., 1]))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    h_t = torch.stack([torch.cos(phi) * sin_theta,
                       torch.sin(phi) * sin_theta,
                       cos_theta], dim=-1)
    # tangent basis around n (BRDF.hlsl:232-236)
    z_up = torch.tensor([0.0, 0.0, 1.0], device=n.device).expand(n.shape)
    x_up = torch.tensor([1.0, 0.0, 0.0], device=n.device).expand(n.shape)
    up = torch.where(torch.abs(n[..., 2:3]) < 0.999, z_up, x_up)
    tangent = normalize(torch.linalg.cross(up, n))
    bitangent = torch.linalg.cross(n, tangent)
    return normalize(tangent * h_t[..., 0:1] + bitangent * h_t[..., 1:2]
                     + n * h_t[..., 2:3])


# integrate_brdf computes its samples' terms this many at a time (fewer,
# larger launches; the same values: each term is its own elementwise chain)
LUT_SAMPLE_CHUNK = 32


def _sample_angles(xi0: torch.Tensor):
    """cos and sin of the samples' phi = xi0 * f32(2 pi), as the reference's
    compiled scan takes them: libm's cosf and sinf (XLA lowers its f32
    cosine and sine to them), on the host -> two [S] f32 tensors on xi0's
    device."""
    c2pi = np.float32(6.28318548)
    phi = (xi0.cpu().numpy().astype(np.float32) * c2pi).astype(np.float32)
    cos_f, sin_f = _backend.libm_f32("cosf"), _backend.libm_f32("sinf")
    return (torch.tensor([cos_f(float(x)) for x in phi], dtype=torch.float32,
                         device=xi0.device),
            torch.tensor([sin_f(float(x)) for x in phi], dtype=torch.float32,
                         device=xi0.device))


def integrate_brdf(ndotv: torch.Tensor, roughness: torch.Tensor,
                   num_samples: int = 512) -> torch.Tensor:
    """Split-sum BRDF integration -> (F0 scale, F0 bias) (BRDF.hlsl:239-283).
    ndotv/roughness [...] -> [..., 2]. Rounded as XLA compiles the
    reference's lax.scan body on the CPU: every multiply whose one use is an
    add or a subtract fused into it, the three-term dots and norms as FMA
    chains, true divisions and square roots, libm's cosf and sinf
    (_sample_angles); the normal is +z, so the tangent frame is (0, -1, 0),
    (1, 0, 0) and the half vector before its normalization is (h1, -h0,
    cos theta) exactly. The samples accumulate one after another, in the
    scan's order, their terms computed LUT_SAMPLE_CHUNK at a time."""
    dev = ndotv.device
    ndotv = torch.clamp(ndotv, min=1e-4)
    vx = _sqrt(1.0 - ndotv * ndotv)
    vz = ndotv
    r = roughness
    a = r * r
    aa1 = _fma(a, a, -1.0)                          # a * a - 1
    k = (r * r) * 0.5
    omk = 1.0 - k

    def g1(nx):                                     # Smith-Schlick, IBL k
        return nx / (_fma(nx, omk, k) + 1e-4)
    g_v = g1(torch.clamp(vz, min=0.0))
    xi = hammersley(torch.arange(num_samples, device=dev), num_samples)
    cphi, sphi = _sample_angles(xi[:, 0])
    scale = torch.zeros_like(ndotv)
    bias = torch.zeros_like(ndotv)
    zero = torch.zeros_like(ndotv)
    for s0 in range(0, num_samples, LUT_SAMPLE_CHUNK):
        sl = slice(s0, s0 + LUT_SAMPLE_CHUNK)
        shape = (xi[sl].shape[0],) + (1,) * ndotv.ndim
        xi1 = xi[sl, 1].reshape(shape)
        cos_t = _sqrt((1.0 - xi1) / _fma(aa1, xi1, 1.0))
        sin_t = _sqrt(torch.clamp(_fma(-cos_t, cos_t, 1.0), min=0.0))
        hx = sphi[sl].reshape(shape) * sin_t
        hy = -(cphi[sl].reshape(shape) * sin_t)
        hz = cos_t
        hn = torch.clamp(norm3(torch.stack([hx, hy, hz], dim=-1)), min=1e-12)
        hx, hy, hz = hx / hn, hy / hn, hz / hn
        # reflect(-v, h) = i - 2 dot(h, i) h, i = -v (its y is 0)
        d2 = _fma(hz, -vz, hx * -vx) * 2.0
        rx, ry, rz = _fma(-d2, hx, -vx), _fma(-d2, hy, 0.0), _fma(-d2, hz, -vz)
        rn = torch.clamp(norm3(torch.stack([rx, ry, rz], dim=-1)), min=1e-12)
        lz = rz / rn
        ndotl = torch.clamp(lz, min=0.0)
        ndoth = torch.clamp(hz, min=0.0)
        vdoth = torch.clamp(_fma(vz, hz, vx * hx), min=0.0)
        g = g_v * g1(ndotl)
        g_vis = torch.clamp(g * vdoth / torch.clamp(ndoth * ndotv, min=1e-6),
                            min=1e-4)
        x = 1.0 - vdoth
        x4 = (x * x) * (x * x)
        lit = ndotl > 0
        d_scale = torch.where(lit, _fma(-x4, x, 1.0) * g_vis, zero)
        d_bias = torch.where(lit, (x4 * x) * g_vis, zero)
        for j in range(d_scale.shape[0]):
            scale = scale + d_scale[j]
            bias = bias + d_bias[j]
    return torch.stack([scale, bias], dim=-1) / num_samples


def brdf_integration_lut(size: int = 256, num_samples: int = 512, *,
                         device: torch.device | str) -> torch.Tensor:
    """The BRDF_INTEGRATION_CS LUT (BRDF.hlsl:239-283; created once at load,
    Renderer.h:77-84) on `device` (no default: the caller names where it is
    computed): [size, size, 2], x: NdotV, y: roughness."""
    g = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    r, nv = torch.meshgrid(g, g, indexing="ij")
    return integrate_brdf(nv, r, num_samples)
