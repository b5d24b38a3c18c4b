"""Shadow maps and shadow tests — counterpart of ``vqengine_tpu/ops/shadow.py``
(ShadowDepthPass.hlsl; Lighting.hlsl's omnidirectional 20-tap PCF, spot
and directional 5x5 PCF; the ESM prefilter and single-tap tests).

Shadow maps render depth-only through the tile rasterizer (kernel K2,
``raster.rasterize``); the tests evaluate densely over the main view and
return per-caster visibility maps for ``shading.shade_forward``.

Every function keeps the reference's name, argument order, layouts and
order of operations. The reference's rows-of-4 scalar gathers
(``ssao.gather_scalar_rows4``, a TPU layout trick) are plain flat-index
gathers here; they return the same values.
"""
from __future__ import annotations

import torch

from . import raster

# reference resolutions (Renderer.cpp:520-522)
SPOT_SHADOW_DIM = 1024
POINT_SHADOW_DIM = 1024
DIRECTIONAL_SHADOW_DIM = 2048

# 20 normalized omnidirectional PCF tap directions (Lighting.hlsl:120-133)
_F3 = 0.5773502691896258
_F2 = 0.7071067811865475
OMNI_TAPS = torch.tensor([
    [_F3, _F3, _F3], [_F3, -_F3, _F3], [-_F3, -_F3, _F3], [-_F3, _F3, _F3],
    [_F3, _F3, -_F3], [_F3, -_F3, -_F3], [-_F3, -_F3, -_F3], [-_F3, _F3, -_F3],
    [_F2, _F2, 0], [_F2, -_F2, 0], [-_F2, -_F2, 0], [-_F2, _F2, 0],
    [_F2, 0, _F2], [-_F2, 0, _F2], [_F2, 0, -_F2], [-_F2, 0, -_F2],
    [0, _F2, _F2], [0, -_F2, _F2], [0, -_F2, -_F2], [0, _F2, -_F2],
], dtype=torch.float32)

# Test-time exponent sharpening (see the reference): visibility =
# exp(K * c * (d_map - d)) with the stored map at c = 80.
ESM_TEST_SHARPNESS = 2.0


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (through f64): PyTorch's
    vectorized CPU sqrt is off by an ulp on some inputs, XLA's is not."""
    return torch.sqrt(x.double()).float()


# ---------------------------------------------------------------------------
# shadow map rendering (depth-only raster)
# ---------------------------------------------------------------------------

def bin_shadow_view(positions: torch.Tensor, item_of_vertex: torch.Tensor,
                    world: torch.Tensor, light_vp: torch.Tensor,
                    indices: torch.Tensor, size: int,
                    tri_mask: torch.Tensor | None = None) -> raster.BinnedTriangles:
    """The front end of render_shadow_depth: every triangle of the index
    buffer is set up (padded, degenerate ones included; setup kills them)
    and binned into 16-row records at the default pair capacity."""
    wvp = raster.world_view_proj(light_vp, world)
    clip = raster.transform_clip_instanced(positions, item_of_vertex, wvp)
    setup = raster.setup_triangles(clip[indices.long()], size, size,
                                   tri_mask=tri_mask)
    return raster.bin_triangles(setup, size, size)


def render_shadow_depth(positions: torch.Tensor, item_of_vertex: torch.Tensor,
                        world: torch.Tensor, light_vp: torch.Tensor,
                        indices: torch.Tensor, size: int,
                        tri_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Depth-only render from a light: -> z_ndc depth map [size, size],
    rasterized by kernel K2."""
    binned = bin_shadow_view(positions, item_of_vertex, world, light_vp,
                             indices, size, tri_mask)
    depth, _ = raster.rasterize(binned, size, size)
    return depth


def ndc_depth_to_radial(depth: torch.Tensor, near, far) -> torch.Tensor:
    """A 90-degree face's z_ndc map -> linear radial distance / far (the
    point-light ShadowDepthPass.hlsl stores dist(P, light) / far);
    background (depth 1) -> 1."""
    s = depth.shape[0]
    uv = (torch.arange(s, dtype=torch.float32, device=depth.device) + 0.5) / s * 2.0 - 1.0
    u = uv[None, :]
    v = -uv[:, None]  # screen y down -> ndc y up
    denom = torch.clamp(far - depth * (far - near), min=1e-9)
    z_view = near * far / denom
    radial = z_view * _sqrt(1.0 + u * u + v * v)
    return torch.where(depth >= 1.0, torch.ones_like(radial), radial / far)


# ---------------------------------------------------------------------------
# shadow tests (dense over the main view)
# ---------------------------------------------------------------------------

def _mat_apply(m: torch.Tensor, v4: list) -> list:
    """m [..., 4, 4] applied to the homogeneous point v4 = [x, y, z, w]
    (tensors broadcasting against m's leading dims) -> the 4 clip
    components. The products are summed in pairs, (0 + 1) + (2 + 3), as
    XLA sums the reference's projection einsums on the CPU."""
    return [(m[..., i, 0] * v4[0] + m[..., i, 1] * v4[1])
            + (m[..., i, 2] * v4[2] + m[..., i, 3] * v4[3]) for i in range(4)]


def _ndc(wpos: torch.Tensor, light_vps: torch.Tensor):
    """world pos [..., 3] through light_vps [4, 4] (or [C, 1, 1, 4, 4])
    -> (ndc [..., 3] stacked last, w, in_frustum)."""
    v4 = [wpos[..., 0], wpos[..., 1], wpos[..., 2], torch.ones_like(wpos[..., 0])]
    x, y, z, w = _mat_apply(light_vps, v4)
    safe_w = torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
    ndc = torch.stack([x, y, z], dim=-1) / safe_w[..., None]
    inside = ((ndc[..., 0] >= -1) & (ndc[..., 0] <= 1)
              & (ndc[..., 1] >= -1) & (ndc[..., 1] <= 1)
              & (ndc[..., 2] >= 0) & (ndc[..., 2] <= 1) & (w > 0))
    return ndc, inside


def _project_to_light(wpos: torch.Tensor, light_vp: torch.Tensor):
    """world pos [..., 3] -> (uv in [0,1]^2 y-down, z_ndc, in_frustum)."""
    ndc, inside = _ndc(wpos, light_vp)
    uv = torch.stack([0.5 + 0.5 * ndc[..., 0], 0.5 - 0.5 * ndc[..., 1]], dim=-1)
    return uv, ndc[..., 2], inside


def _texel(coord: torch.Tensor, s: int) -> torch.Tensor:
    """clip(int32(coord), 0, s - 1): truncation toward zero, then clip.
    The clamp to [-1, s] first reproduces XLA's saturating float->int
    conversion for out-of-range values without changing any other."""
    return coord.clamp(-1.0, float(s)).to(torch.int32).clamp(0, s - 1)


def _gather_flat(maps: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """maps.reshape(-1)[idx] as f32 (the reference's gather_scalar_rows4
    returns the same values)."""
    return maps.reshape(-1)[idx.long()].to(torch.float32)


def _fetch_nearest(shadow_map: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-texel fetch (the reference uses PointSampler for PCF taps)."""
    s = shadow_map.shape[-1]
    tx = _texel(uv[..., 0] * s, s)
    ty = _texel(uv[..., 1] * s, s)
    return _gather_flat(shadow_map, ty * s + tx)


def shadow_test_pcf(wpos: torch.Tensor, ndotl: torch.Tensor,
                    light_vp: torch.Tensor, shadow_map: torch.Tensor,
                    depth_bias, slope_scaled: bool = True) -> torch.Tensor:
    """5x5 PCF (ShadowTestPCF, Lighting.hlsl:177-218) -> visibility [0, 1];
    out-of-frustum returns 0 (unlit), as in the reference. slope_scaled:
    spot lights use bias * tan(acos(NdotL)); the directional variant
    uses the raw bias."""
    uv, z, inside = _project_to_light(wpos, light_vp)
    if slope_scaled:
        nl = torch.clamp(ndotl, 1e-4, 1.0)
        bias = depth_bias * _sqrt(torch.clamp(1.0 - nl * nl, min=0.0)) / nl
    else:
        bias = torch.as_tensor(depth_bias, dtype=torch.float32,
                               device=wpos.device).expand(ndotl.shape)
    s = shadow_map.shape[-1]
    texel = 1.0 / s
    shadow = torch.zeros_like(z)
    for dx in range(-2, 3):
        for dy in range(-2, 3):
            off = torch.tensor([dx * texel, dy * texel], dtype=torch.float32,
                               device=wpos.device)
            closest = _fetch_nearest(shadow_map, uv + off)
            shadow = shadow + (z - bias > closest).to(torch.float32)
    shadow = shadow / 25.0
    return torch.where(inside, 1.0 - shadow, torch.zeros_like(shadow))


def _cube_face_uv(d: torch.Tensor):
    """direction [..., 3] -> (face [...], uv [..., 2] y-down in [0, 1]);
    D3D cube faces +X -X +Y -Y +Z -Z as scene/light.py's
    cubemap_view_matrix orients them."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    i32 = dict(dtype=torch.int32, device=d.device)
    face_x = torch.where(x >= 0, torch.tensor(0, **i32), torch.tensor(1, **i32))
    face_y = torch.where(y >= 0, torch.tensor(2, **i32), torch.tensor(3, **i32))
    face_z = torch.where(z >= 0, torch.tensor(4, **i32), torch.tensor(5, **i32))
    face = torch.where((ax >= ay) & (ax >= az), face_x,
                       torch.where(ay >= az, face_y, face_z))
    # +X: r=-z u=+y f=+x | -X: r=+z u=+y f=-x | +Y: r=+x u=-z f=+y
    # -Y: r=+x u=+z f=-y | +Z: r=+x u=+y f=+z | -Z: r=-x u=+y f=-z
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    sx = torch.sign(x)
    sy = torch.sign(y)
    sz = torch.sign(z)
    rr = torch.where(is_x, -sx * z, torch.where(is_y, x, sz * x))
    uu = torch.where(is_y, -sy * z, y)
    ff = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ff = torch.clamp(ff, min=1e-9)
    uv = torch.stack([0.5 + 0.5 * rr / ff, 0.5 - 0.5 * uu / ff], dim=-1)
    return face, uv


def _box_blur_clamped(e: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box blur with clamped (edge-replicated) borders over the
    last two axes; the shifts are summed from -radius to radius, starting
    from zeros, as in the reference."""
    def blur_axis(a, axis):
        n = a.shape[axis]
        acc = torch.zeros_like(a)
        for o in range(-radius, radius + 1):
            if o < 0:       # shift down: replicate leading edge
                first = a.narrow(axis, 0, 1)
                body = a.narrow(axis, 0, n + o)
                shifted = torch.cat([first] * (-o) + [body], dim=axis)
            elif o > 0:     # shift up: replicate trailing edge
                last = a.narrow(axis, n - 1, 1)
                body = a.narrow(axis, o, n - o)
                shifted = torch.cat([body] + [last] * o, dim=axis)
            else:
                shifted = a
            acc = acc + shifted
        return acc / (2 * radius + 1)
    return blur_axis(blur_axis(e, e.ndim - 2), e.ndim - 1)


def pool2_map(m: torch.Tensor, times: int = 1) -> torch.Tensor:
    """Mean-pool the last two axes 2x `times` times. A 2x2 block (a b /
    c d) sums as (a + b) + (c + d), as XLA reduces the reference's
    reshape on the CPU."""
    for _ in range(times):
        h, w = m.shape[-2] // 2 * 2, m.shape[-1] // 2 * 2
        m = m[..., :h, :w]
        m = ((m[..., 0::2, 0::2] + m[..., 0::2, 1::2])
             + (m[..., 1::2, 0::2] + m[..., 1::2, 1::2])) / 4.0
    return m


def prefilter_esm(shadow_map: torch.Tensor, c: float = 80.0,
                  radius: int = 2, pool: int = 0) -> torch.Tensor:
    """Exponential shadow map prefilter: blur exp(c * d_occluder), then
    pool `pool` times, and store the log back in depth units. Works on
    any [..., S, S] stack."""
    lead = shadow_map.shape[:-2]
    s2 = shadow_map.shape[-2:]
    e = shadow_map.reshape((-1,) + tuple(s2)) if lead else shadow_map
    e = torch.exp(torch.clamp(e, 0.0, 1.0) * c - c)      # normalized exp
    e = _box_blur_clamped(e, radius)
    if pool:
        e = pool2_map(e, pool)
    out = torch.log(torch.clamp(e, min=1e-30)) / c + 1.0  # back to depth units
    return out.reshape(tuple(lead) + tuple(out.shape[-2:])) if lead else out


def shadow_test_esm(wpos: torch.Tensor, light_vp: torch.Tensor,
                    esm_map: torch.Tensor, depth_bias,
                    c: float = 80.0) -> torch.Tensor:
    """Single-tap exponential shadow test against a prefilter_esm map:
    clamp(exp(K * c * (d_map - d_receiver + bias))); out-of-frustum = 0."""
    uv, z, inside = _project_to_light(wpos, light_vp)
    closest = _fetch_nearest(esm_map, uv)
    vis = torch.exp(torch.clamp((closest - z + depth_bias) * c * ESM_TEST_SHARPNESS,
                                -60.0, 0.0))
    return torch.where(inside, vis, torch.zeros_like(vis))


def shadow_test_esm_batch(wpos: torch.Tensor, light_vps: torch.Tensor,
                          esm_maps: torch.Tensor, depth_biases: torch.Tensor,
                          c: float = 80.0) -> torch.Tensor:
    """All C spot/dir casters at once. wpos [h, w, 3], light_vps [C, 4, 4],
    esm_maps [C, S, S], depth_biases [C] -> visibility [C, h, w]."""
    ndc, inside = _ndc(wpos[None], light_vps[:, None, None])
    s = esm_maps.shape[-1]
    tx = _texel((0.5 + 0.5 * ndc[..., 0]) * s, s)
    ty = _texel((0.5 - 0.5 * ndc[..., 1]) * s, s)
    cbase = (torch.arange(esm_maps.shape[0], dtype=torch.int32,
                          device=wpos.device) * (s * s))[:, None, None]
    closest = _gather_flat(esm_maps, cbase + ty * s + tx)
    z = ndc[..., 2]
    bias = depth_biases[:, None, None]
    vis = torch.exp(torch.clamp((closest - z + bias) * c * ESM_TEST_SHARPNESS,
                                -60.0, 0.0))
    return torch.where(inside, vis, torch.zeros_like(vis))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over 3 components, added left to right as XLA adds
    the reference's sums on the CPU."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis (3 components), rounded as XLA rounds the
    reference's jnp.linalg.norm on the CPU: a chain of fused
    multiply-adds."""
    return _sqrt(raster._fma(v[..., 2], v[..., 2],
                             raster._fma(v[..., 1], v[..., 1],
                                         v[..., 0] * v[..., 0])))


def omni_shadow_test_esm_batch(wpos: torch.Tensor, light_pos: torch.Tensor,
                               esm_cubes: torch.Tensor, fars: torch.Tensor,
                               depth_biases: torch.Tensor,
                               c: float = 80.0) -> torch.Tensor:
    """All C point casters at once. wpos [h, w, 3], light_pos [C, 3],
    esm_cubes [C, 6, S, S], fars / depth_biases [C] -> visibility
    [C, h, w]."""
    lw = light_pos[:, None, None, :] - wpos[None]           # [C, h, w, 3]
    far = torch.clamp(fars, min=1e-6)[:, None, None]
    dist = norm3(lw) / far
    face, uv = _cube_face_uv(-lw)
    s = esm_cubes.shape[-1]
    tx = _texel(uv[..., 0] * s, s)
    ty = _texel(uv[..., 1] * s, s)
    cbase = (torch.arange(esm_cubes.shape[0], dtype=torch.int32,
                          device=wpos.device) * (6 * s * s))[:, None, None]
    closest = _gather_flat(esm_cubes, cbase + (face * s + ty) * s + tx)
    bias_n = (depth_biases[:, None, None] + 0.001) / far
    return torch.exp(torch.clamp((closest - dist + bias_n) * c * ESM_TEST_SHARPNESS,
                                 -60.0, 0.0))


def omni_shadow_test_esm(wpos: torch.Tensor, light_pos: torch.Tensor,
                         esm_cube: torch.Tensor, far, depth_bias,
                         c: float = 80.0) -> torch.Tensor:
    """Single-tap exponential omnidirectional test against a radial-
    distance ESM cube [6, S, S] (prefilter_esm of radial / far)."""
    far_c = torch.clamp(torch.as_tensor(far, dtype=torch.float32,
                                        device=wpos.device), min=1e-6)
    lw = light_pos - wpos
    dist = norm3(lw) / far_c
    face, uv = _cube_face_uv(-lw)
    s = esm_cube.shape[-1]
    tx = _texel(uv[..., 0] * s, s)
    ty = _texel(uv[..., 1] * s, s)
    closest = _gather_flat(esm_cube, (face * s + ty) * s + tx)
    bias_n = (depth_bias + 0.001) / far_c
    return torch.exp(torch.clamp((closest - dist + bias_n) * c * ESM_TEST_SHARPNESS,
                                 -60.0, 0.0))


def omni_shadow_test_pcf(wpos: torch.Tensor, light_pos: torch.Tensor,
                         cube_maps: torch.Tensor, far, depth_bias,
                         cam_pos: torch.Tensor) -> torch.Tensor:
    """20-tap omnidirectional PCF (OmnidirectionalShadowTestPCF,
    Lighting.hlsl:110-174); cube_maps [6, S, S] hold radial distance /
    far. -> visibility [0, 1]."""
    lw = light_pos - wpos                     # pixel -> light
    dist = norm3(lw)
    view_dist = norm3(wpos - cam_pos)
    disk_radius = (1.0 + view_dist / far) / 8.0
    s = cube_maps.shape[-1]
    taps = OMNI_TAPS.to(wpos.device)
    shadow = torch.zeros_like(dist)
    for i in range(taps.shape[0]):
        sample_vec = -(lw + taps[i] * disk_radius[..., None])
        face, uv = _cube_face_uv(sample_vec)
        tx = _texel(uv[..., 0] * s, s)
        ty = _texel(uv[..., 1] * s, s)
        closest = _gather_flat(cube_maps, (face * s + ty) * s + tx) * far
        shadow = shadow + (dist > closest + depth_bias + 0.001).to(torch.float32)
    return 1.0 - shadow / taps.shape[0]
