"""Image-based lighting — counterpart of ``vqengine_tpu/ops/ibl.py``: the
equirect <-> direction maps, the samplers, the load-time prefilter (diffuse
irradiance cube, GGX specular mips, SH9 projection, BRDF LUT and its
Chebyshev fit), the shading-time environment term and the skydome lookup
(CubemapConvolution.hlsl, EnvironmentMapRendering.cpp:139-486,
Lighting.hlsl:348-395).

The load-time convolutions are dense products over the equirect texels,
the converged limits of the reference's Monte-Carlo loops:

    irradiance(N)  = sum_p env_p * max(0, N . w_p) * dw_p / pi
    prefilter_r(N) = sum_p env_p * k_r(N . w_p) * dw_p / sum_p k_r * dw_p

They run in row chunks (each output row's sum is independent of the
others), so the transient kernel matrix stays small (CHUNK_ELEMS). The numpy
helpers (texel directions, the procedural sky, the Chebyshev least-squares
fit, the SH9 projection) are the reference's, verbatim.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import brdf as B
from .shadow import _cube_face_uv, _sqrt, norm3

PI = float(np.pi)
# elements of a load-time product's row chunk: 4 MiB of f32 on the CPU
# (cache-sized; large chunks are freed and faulted in again per chunk),
# 32 MiB on a card (a few launches per mip; the transient peak is a few
# such chunks and an f64 square root of one)
CHUNK_ELEMS = {"cpu": 1 << 20, "cuda": 1 << 23}


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


# ---------------------------------------------------------------------------
# direction <-> equirect mapping (ShadingMath.hlsl:70-80)
# ---------------------------------------------------------------------------

def direction_to_equirect_uv(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> uv [..., 2] (exact DirectionToEquirectUV); the norm is
    rounded as the reference's jnp.linalg.norm (shadow.norm3)."""
    u = torch.atan2(v[..., 2], v[..., 0]) / (-2.0 * PI) + 0.5
    w = torch.asin(-v[..., 1] / torch.clamp(norm3(v), min=1e-9)) / PI + 0.5
    return torch.stack([u, w], dim=-1)


def equirect_texel_directions(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (dirs [H*W, 3], solid_angles [H*W]) for equirect texel centers.
    Inverts DirectionToEquirectUV: u = atan2(z,x)/(-2pi)+0.5, v = asin(-y)/pi+0.5."""
    us = (np.arange(width) + 0.5) / width
    vs = (np.arange(height) + 0.5) / height
    U, V = np.meshgrid(us, vs)                       # [H, W]
    phi = (0.5 - U) * 2.0 * np.pi                    # atan2(z, x)
    elev = (V - 0.5) * np.pi                         # asin(-y)
    y = -np.sin(elev)
    c = np.cos(elev)
    x = c * np.cos(phi)
    z = c * np.sin(phi)
    dirs = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    # solid angle: dphi * dtheta * sin(polar theta); polar = pi/2 + elev
    sin_polar = np.clip(np.cos(elev), 1e-6, 1.0)     # cos(elev) == sin(polar)
    omega = (2.0 * np.pi / width) * (np.pi / height) * sin_polar
    return dirs, omega.reshape(-1).astype(np.float32)


def cube_texel_directions(size: int) -> np.ndarray:
    """World-space directions of cube texel centers [6, S, S, 3], matching
    the D3D face conventions in scene/light.py cubemap_view_matrix."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size
    a = t * 2.0 - 1.0                                # face-local in [-1, 1]
    u, v = np.meshgrid(a, -a)                        # u right, v up (y-down rows)
    one = np.ones_like(u)
    d = np.zeros((6, size, size, 3), dtype=np.float32)
    # face 0 +X: dir = f*x_hat + u*(-z_hat) + v*(y_hat)
    d[0] = np.stack([one, v, -u], axis=-1)
    d[1] = np.stack([-one, v, u], axis=-1)
    d[2] = np.stack([u, one, -v], axis=-1)   # +Y: r=+x, u=-z, f=+y
    d[3] = np.stack([u, -one, v], axis=-1)   # -Y: r=+x, u=+z, f=-y
    d[4] = np.stack([u, v, one], axis=-1)    # +Z
    d[5] = np.stack([-u, v, -one], axis=-1)  # -Z
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d


# ---------------------------------------------------------------------------
# sampling (every gathered bf16 texel is upcast before it meets a weight:
# torch would keep bf16 where one side is a 0-dim f32 tensor, JAX promotes)
# ---------------------------------------------------------------------------

def sample_equirect_bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """img [H, W, C], uv [..., 2] -> [..., C]; wraps in u, clamps in v."""
    h, w = img.shape[0], img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)     # floor modulo, as jnp.mod
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = img.reshape(-1, img.shape[-1])

    def tap(yi, xi):
        return flat[(yi * w + xi).long()].to(torch.float32)
    c00, c10 = tap(y0i, x0i), tap(y0i, x1i)
    c01, c11 = tap(y1i, x0i), tap(y1i, x1i)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def flatten_mip_pyramid(mips: list[torch.Tensor]):
    """Flatten a list of [..., S_m, S_m, C] mips into one [Ntexels, C]
    tensor + per-level offsets, so that a per-pixel mip-varying fetch is
    one gather. -> (flat [N, C], offsets list, shapes list)."""
    flats, offsets, off = [], [], 0
    for m in mips:
        flats.append(m.reshape(-1, m.shape[-1]))
        offsets.append(off)
        off += flats[-1].shape[0]
    return torch.cat(flats, dim=0), offsets, [tuple(m.shape) for m in mips]


def cube_pyramid_index(offsets, shapes, dirs: torch.Tensor,
                       level: torch.Tensor) -> torch.Tensor:
    """The flat texel index of sample_cube_pyramid_nearest: the nearest
    texel of dirs [..., 3] in mip `level` [...] (int32)."""
    face, uv = _cube_face_uv(dirs)
    idx = torch.zeros(level.shape, dtype=torch.int32, device=dirs.device)
    for m, (off, shp) in enumerate(zip(offsets, shapes)):
        s = shp[1]
        tx = torch.clamp((uv[..., 0] * s).to(torch.int32), 0, s - 1)
        ty = torch.clamp((uv[..., 1] * s).to(torch.int32), 0, s - 1)
        cand = off + (face * s + ty) * s + tx
        idx = torch.where(level == m, cand, idx)
    return idx


def sample_cube_pyramid_nearest(flat: torch.Tensor, offsets, shapes,
                                dirs: torch.Tensor, level: torch.Tensor
                                ) -> torch.Tensor:
    """Nearest sample from a flattened cubemap mip pyramid:
    flat from flatten_mip_pyramid over [6,S,S,C] mips; dirs [...,3];
    level [...] int32. One gather."""
    idx = cube_pyramid_index(offsets, shapes, dirs, level)
    return flat[idx.long()].to(torch.float32)


def sample_cube(cube: torch.Tensor, dirs: torch.Tensor,
                bilinear: bool = True) -> torch.Tensor:
    """cube [6, S, S, C], dirs [..., 3] -> [..., C] (clamped within face)."""
    face, uv = _cube_face_uv(dirs)
    s = cube.shape[1]
    flat = cube.reshape(-1, cube.shape[-1])
    if not bilinear:
        tx = torch.clamp((uv[..., 0] * s).to(torch.int32), 0, s - 1)
        ty = torch.clamp((uv[..., 1] * s).to(torch.int32), 0, s - 1)
        return flat[((face * s + ty) * s + tx).long()].to(torch.float32)
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int32), 0, s - 1)
    x1i = torch.clamp(x0i + 1, 0, s - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, s - 1)
    y1i = torch.clamp(y0i + 1, 0, s - 1)
    base = face * (s * s)

    def tap(yi, xi):
        return flat[(base + yi * s + xi).long()].to(torch.float32)
    c00, c10 = tap(y0i, x0i), tap(y0i, x1i)
    c01, c11 = tap(y1i, x0i), tap(y1i, x1i)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


# ---------------------------------------------------------------------------
# load-time convolutions (dense products, in row chunks)
# ---------------------------------------------------------------------------

def downsample_equirect(img: torch.Tensor, target_w: int) -> torch.Tensor:
    """Box-average an equirect map down to target_w x target_w/2."""
    h, w = img.shape[0], img.shape[1]
    th = target_w // 2
    fy, fx = h // th, w // target_w
    if fy < 1 or fx < 1:
        return img
    img = img[: th * fy, : target_w * fx]
    blocks = img.reshape(th, fy, target_w, fx, -1)
    return blocks.sum(dim=(1, 3)) / (fy * fx)


def equirect_to_cubemap(equirect: torch.Tensor, size: int) -> torch.Tensor:
    """-> [6, S, S, 3] (the reference's equirect->cube draw,
    EnvironmentMapRendering.cpp:197-260)."""
    dirs = _f32(cube_texel_directions(size), equirect.device)
    return sample_equirect_bilinear(equirect, direction_to_equirect_uv(dirs))


def _chunked_rows(n: int, cols: int, device: torch.device, fn) -> torch.Tensor:
    """cat([fn(rows) for row slices]) over n output rows of a product with
    `cols` terms per row, CHUNK_ELEMS[device type] kernel entries at once."""
    step = max(1, CHUNK_ELEMS.get(device.type, CHUNK_ELEMS["cuda"]) // cols)
    return torch.cat([fn(slice(i, min(i + step, n)))
                      for i in range(0, n, step)], dim=0)


def diffuse_irradiance_cube(equirect: torch.Tensor, size: int = 64,
                            source_width: int = 64) -> torch.Tensor:
    """Exact cosine convolution (the converged limit of
    PSMain_DiffuseIrradiance, CubemapConvolution.hlsl:112-163):
    irradiance(N) = sum_p env_p max(0, N.w_p) dw_p / pi."""
    dev = equirect.device
    src = downsample_equirect(equirect, source_width)
    sh, sw = src.shape[0], src.shape[1]
    dirs_p, omega_p = equirect_texel_directions(sw, sh)
    dirs_n = _f32(cube_texel_directions(size).reshape(-1, 3), dev)
    dp_t, op = _f32(dirs_p, dev).T, _f32(omega_p, dev)
    src_flat = src.reshape(-1, 3)

    def rows(sl):
        cosm = torch.clamp(dirs_n[sl] @ dp_t, min=0.0)
        return ((cosm * op[None, :]) @ src_flat) / PI
    return _chunked_rows(dirs_n.shape[0], op.shape[0], dev,
                         rows).reshape(6, size, size, 3)


def _ggx_prefilter_kernel(cos_gamma: torch.Tensor, roughness: float) -> torch.Tensor:
    """Radial GGX prefilter kernel under the reference's V=N approximation:
    L is at angle gamma from N with gamma = 2*theta_H, weighted by NdotL."""
    cg = torch.clamp(cos_gamma, -1.0, 1.0)
    cos_half = _sqrt(torch.clamp(0.5 * (1.0 + cg), min=0.0))  # cos(gamma/2)
    r = torch.tensor(roughness, dtype=torch.float32, device=cg.device)
    d = B.ndf_ggx(cos_half, r)
    return d * cos_half * torch.clamp(cg, min=0.0)


def specular_prefilter_mips(equirect: torch.Tensor, base_size: int = 128,
                            num_mips: int = 6,
                            source_width: int = 128) -> list[torch.Tensor]:
    """GGX specular prefilter chain: mip m has roughness m/(num_mips-1)
    (EnvironmentMapRendering.cpp:432). Mip 0 (mirror) is a direct resample;
    rougher mips are kernel products, normalized per row."""
    dev = equirect.device
    mips = [equirect_to_cubemap(equirect, base_size)]
    src = downsample_equirect(equirect, source_width)
    sh, sw = src.shape[0], src.shape[1]
    dirs_p, omega_p = equirect_texel_directions(sw, sh)
    dp_t, op = _f32(dirs_p, dev).T, _f32(omega_p, dev)
    src_flat = src.reshape(-1, 3)
    for m in range(1, num_mips):
        size = max(base_size >> m, 4)
        roughness = m / (num_mips - 1)
        dirs_n = _f32(cube_texel_directions(size).reshape(-1, 3), dev)

        def rows(sl, dirs_n=dirs_n, roughness=roughness):
            k = _ggx_prefilter_kernel(dirs_n[sl] @ dp_t, roughness) * op[None, :]
            norm = torch.clamp(k.sum(dim=1, keepdim=True), min=1e-9)
            return (k @ src_flat) / norm
        mips.append(_chunked_rows(dirs_n.shape[0], op.shape[0], dev,
                                  rows).reshape(6, size, size, 3))
    return mips


def sh9_basis(d):
    """Real spherical-harmonics basis l<=2 at unit directions [..., 3] ->
    [..., 9] (ordering: 00, 1-1, 10, 11, 2-2, 2-1, 20, 21, 22); numpy in,
    numpy out, else torch."""
    is_np = isinstance(d, np.ndarray)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ones = np.ones_like(x) if is_np else torch.ones_like(x)
    terms = [0.282095 * ones,
             0.488603 * y, 0.488603 * z, 0.488603 * x,
             1.092548 * x * y, 1.092548 * y * z,
             0.315392 * (3.0 * z * z - 1.0),
             1.092548 * x * z, 0.546274 * (x * x - y * y)]
    return np.stack(terms, axis=-1) if is_np else torch.stack(terms, dim=-1)


def sh9_irradiance_coeffs(equirect: torch.Tensor,
                          source_width: int = 64) -> torch.Tensor:
    """Project the environment onto l<=2 SH and fold in the cosine-lobe
    convolution (Ramamoorthi-Hanrahan): [9, 3] coefficients C with
    E(N)/pi = sh9_basis(N) @ C. The projection is the reference's numpy
    product on the host, on the downsampled map."""
    src = downsample_equirect(equirect, source_width)
    sh, sw = src.shape[0], src.shape[1]
    dirs_p, omega_p = equirect_texel_directions(sw, sh)
    basis = sh9_basis(dirs_p)                                    # [P, 9]
    L = (basis * omega_p[:, None]).T @ np.asarray(
        src.reshape(-1, 3).cpu().numpy(), np.float32)            # [9, 3]
    a = np.array([np.pi, 2 * np.pi / 3, 2 * np.pi / 3, 2 * np.pi / 3,
                  np.pi / 4, np.pi / 4, np.pi / 4, np.pi / 4, np.pi / 4],
                 np.float32)
    return _f32(L * a[:, None] / np.pi, equirect.device)


def sh9_eval(normal: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """normal [..., 3], coeffs [9, C] -> [..., C]."""
    return torch.clamp(sh9_basis(normal) @ coeffs, min=0.0)


_BRDF_LUT_CACHE: dict = {}


def brdf_lut_cached(size: int = 256, num_samples: int = 512, *,
                    device: torch.device | str) -> torch.Tensor:
    """Process-cached BRDF integration LUT on `device` (computed once per
    size, sample count and device, there, like the reference's procedural
    BRDF_INTEGRATION_LUT texture, Renderer.h:77-84)."""
    key = (size, num_samples, str(torch.device(device)))
    lut = _BRDF_LUT_CACHE.get(key)
    if lut is None:
        lut = B.brdf_integration_lut(size, num_samples, device=device)
        _BRDF_LUT_CACHE[key] = lut
    return lut


def _cheb_basis(x: torch.Tensor, d: int) -> torch.Tensor:
    """Chebyshev T_0..T_{d-1} of x in [0,1] -> [..., d]."""
    xm = 2.0 * x - 1.0
    ts = [torch.ones_like(xm), xm]
    for _ in range(d - 2):
        ts.append(2.0 * xm * ts[-1] - ts[-2])
    return torch.stack(ts[:d], dim=-1)


_BRDF_POLY_CACHE: dict = {}


def brdf_poly_fit(lut: np.ndarray, degree: int = 20) -> np.ndarray:
    """Fit a 2D Chebyshev surface to the split-sum LUT (the reference's
    numpy least squares): [L, L, 2] -> coeffs [degree, degree, 2] with
    value(ndotv, rough) = sum_ij C[i,j] T_i(ndotv) T_j(rough). Cached by
    the LUT's bytes (the card's and the CPU's LUTs may differ in an ulp)."""
    lut = np.asarray(lut, np.float32)
    key = (hashlib.sha256(lut.tobytes()).hexdigest(), lut.shape, degree)
    hit = _BRDF_POLY_CACHE.get(key)
    if hit is not None:
        return hit
    l = lut.shape[0]
    g = (np.arange(l) + 0.5) / l
    b = _cheb_basis(torch.from_numpy(g.astype(np.float32)), degree).numpy()
    # lut[iy, ix]: ix -> ndotv, iy -> roughness (brdf_integration_lut)
    a = np.einsum("xi,yj->yxij", b, b).reshape(l * l, degree * degree)
    sol, *_ = np.linalg.lstsq(a, lut.reshape(l * l, 2), rcond=None)
    coeffs = sol.reshape(degree, degree, 2).astype(np.float32)
    _BRDF_POLY_CACHE[key] = coeffs
    return coeffs


def brdf_poly_eval(coeffs: torch.Tensor, ndotv: torch.Tensor,
                   roughness: torch.Tensor) -> torch.Tensor:
    """-> [..., 2] (f0 scale, bias) from the fitted Chebyshev surface."""
    d0, d1 = coeffs.shape[0], coeffs.shape[1]
    tx = _cheb_basis(torch.clamp(ndotv, 0.0, 1.0), d0)
    ty = _cheb_basis(torch.clamp(roughness, 0.0, 1.0), d1)
    tmp = (tx.reshape(-1, d0) @ coeffs.reshape(d0, -1)).reshape(
        tx.shape[:-1] + (d1, coeffs.shape[2]))                  # [..., j, c]
    return (tmp * ty[..., None]).sum(dim=-2)


# ---------------------------------------------------------------------------
# shading-time environment illumination (Lighting.hlsl:348-395)
# ---------------------------------------------------------------------------

def hdri_rotation(v: torch.Tensor, yaw_rad) -> torch.Tensor:
    """GetHDRIRotationMatrix (Lighting.hlsl:348-358): rotate sample
    direction about +Y by -yaw. cos and sin are taken in f64 and rounded
    to f32 (torch's f32 cos differs from XLA's on more inputs)."""
    yaw = torch.as_tensor(yaw_rad, dtype=torch.float32, device=v.device)
    c = torch.cos(-yaw.double()).float()
    s = torch.sin(-yaw.double()).float()
    x = c * v[..., 0] + s * v[..., 2]
    z = -s * v[..., 0] + c * v[..., 2]
    return torch.stack([x, v[..., 1], z], dim=-1)


def environment_illumination(normal: torch.Tensor, view: torch.Tensor,
                             roughness: torch.Tensor, metalness: torch.Tensor,
                             albedo: torch.Tensor,
                             diffuse_cube: torch.Tensor,
                             specular_mips: list[torch.Tensor],
                             brdf_lut: torch.Tensor,
                             hdri_yaw=0.0,
                             sh_irradiance: torch.Tensor | None = None,
                             brdf_poly: torch.Tensor | None = None) -> torch.Tensor:
    """CalculateEnvironmentMapIllumination (Lighting.hlsl:360-380): IBL
    diffuse (SH9, or the diffuse cube) + prefiltered specular (one gather
    through the flattened mip pyramid) with the split-sum BRDF (its
    Chebyshev fit, or the LUT)."""
    p = normal * view
    ndotv = torch.clamp((p[..., 0] + p[..., 1]) + p[..., 2], 0.0, 1.0)
    r = hdri_rotation(B.reflect(-view, normal), hdri_yaw)
    n_rot = hdri_rotation(normal, hdri_yaw)

    max_lod = len(specular_mips) - 1
    # integer mip select like the reference (int MIP_LEVEL = r * MAX_LOD)
    mip = torch.clamp((roughness * max_lod).to(torch.int32), 0, max_lod)
    flat, offs, shapes = flatten_mip_pyramid(list(specular_mips))
    spec = sample_cube_pyramid_nearest(flat, offs, shapes, r, mip)

    if brdf_poly is not None:
        f0_scale_bias = brdf_poly_eval(brdf_poly, ndotv, roughness)
    else:
        lut_n = brdf_lut.shape[0]
        ix = torch.clamp((ndotv * lut_n).to(torch.int32), 0, lut_n - 1)
        iy = torch.clamp((roughness * lut_n).to(torch.int32), 0, lut_n - 1)
        f0_scale_bias = brdf_lut.reshape(-1, 2)[(iy * lut_n + ix).long()].to(
            torch.float32)

    if sh_irradiance is not None:
        diffuse_irr = sh9_eval(n_rot, sh_irradiance)
    else:
        diffuse_irr = sample_cube(diffuse_cube, n_rot, bilinear=False)
    return B.environment_brdf(ndotv, roughness, metalness, albedo,
                              diffuse_irr, spec, f0_scale_bias)


def sky_radiance(dirs: torch.Tensor, equirect: torch.Tensor, hdri_yaw=0.0,
                 bilinear: bool = False) -> torch.Tensor:
    """Skydome sampling for background pixels (Skydome.hlsl behavior:
    equirect lookup of the view ray); nearest unless bilinear."""
    uv = direction_to_equirect_uv(hdri_rotation(dirs, hdri_yaw))
    if bilinear:
        return sample_equirect_bilinear(equirect, uv)
    h, w = equirect.shape[0], equirect.shape[1]
    tx = torch.remainder((uv[..., 0] * w).to(torch.int32), w)
    ty = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    return equirect.reshape(-1, equirect.shape[-1])[(ty * w + tx).long()].to(
        torch.float32)


# ---------------------------------------------------------------------------
# procedural fallback sky (the reference's HDRI files are not shipped)
# ---------------------------------------------------------------------------

def procedural_sky_equirect(width: int = 512, height: int = 256,
                            sun_dir=(0.3, 0.8, 0.5), sun_intensity: float = 50.0,
                            zenith=(0.25, 0.45, 0.85), horizon=(0.8, 0.85, 0.95),
                            ground=(0.25, 0.22, 0.2)) -> np.ndarray:
    """Simple physically-plausible HDR sky: gradient + sun disc + ground."""
    dirs, _ = equirect_texel_directions(width, height)
    y = dirs[:, 1]
    sun = np.asarray(sun_dir, np.float32)
    sun /= np.linalg.norm(sun)
    cos_sun = dirs @ sun
    sky_t = np.clip(y, 0.0, 1.0) ** 0.6
    col = (np.asarray(horizon, np.float32)[None] * (1 - sky_t[:, None])
           + np.asarray(zenith, np.float32)[None] * sky_t[:, None])
    g_t = np.clip(-y, 0.0, 1.0)[:, None]
    col = col * (1 - g_t) + np.asarray(ground, np.float32)[None] * g_t
    disc = np.exp((cos_sun - 1.0) * 2000.0)[:, None] * sun_intensity
    halo = np.exp((cos_sun - 1.0) * 20.0)[:, None] * 0.5
    col = col + (disc + halo) * np.asarray([1.0, 0.95, 0.85], np.float32)[None]
    return col.reshape(height, width, 3).astype(np.float32)
