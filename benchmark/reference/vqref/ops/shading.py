"""Forward PBR shading — counterpart of ``vqengine_tpu/ops/shading.py``
(ForwardLighting.hlsl PSMain :222-391, Lighting.hlsl :29-73, :308-345).

Light tensor layouts (scene/light.py pack_*):
  point [P, 12]: position(3) range color(3) brightness depth_bias shadow_far pad(2)
  spot  [S, 12]: position(3) outer_cos_angle color(3) brightness dir(3) depth_bias
  spot_extra [S, 4]: inner_angle range pad(2)
  directional [12]: dir(3) brightness color(3) depth_bias shadowing enabled

Accumulation order as in the reference: ambient + emissive, the
environment term, point lights, spot lights, shadowed point casters,
shadowed spot casters, directional.
"""
from __future__ import annotations

import torch

from . import brdf as B


def _point_light_radiance(lrow, p, n, v, albedo, roughness, metalness):
    """CalculatePointLightIllumination (Lighting.hlsl:308-322)."""
    to_l = lrow[0:3] - p
    d = B.norm(to_l)
    wi = to_l / torch.clamp(d, min=1e-9)[..., None]
    ndotl = B.saturate(B._dot(n, wi))
    radiance = ((1.0 / torch.clamp(d * d, min=1e-9))[..., None]
                * lrow[4:7] * lrow[7])
    fr = B.brdf(n, albedo, roughness, metalness, wi, v)
    contrib = fr * radiance * ndotl[..., None]
    return torch.where((d < lrow[3])[..., None], contrib,
                       torch.zeros_like(contrib))


def _spot_intensity(spot_dir, outer, inner, lpos, p):
    """SpotlightIntensity (Lighting.hlsl:57-73): angular falloff between
    the inner and outer cone angles (radians)."""
    pix_dir = B.normalize(p - lpos)
    cos_t = B._dot(pix_dir, B.normalize(spot_dir.expand(p.shape)))
    theta = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
    t = 1.0 - (theta - inner) / torch.clamp(outer - inner, min=1e-6)
    return torch.where(theta > outer, torch.zeros_like(t),
                       torch.where(theta <= inner, torch.ones_like(t), t))


def _spot_light_radiance(lrow, extra, p, n, v, albedo, roughness, metalness):
    """CalculateSpotLightIllumination (Lighting.hlsl:323-333)."""
    lpos = lrow[0:3]
    to_l = lpos - p
    d = B.norm(to_l)
    wi = to_l / torch.clamp(d, min=1e-9)[..., None]
    ndotl = B.saturate(B._dot(n, wi))
    intensity = _spot_intensity(lrow[8:11], lrow[3], extra[0], lpos, p)
    radiance = ((intensity / torch.clamp(d * d, min=1e-9))[..., None]
                * lrow[4:7] * lrow[7])
    fr = B.brdf(n, albedo, roughness, metalness, wi, v)
    return fr * radiance * ndotl[..., None]


def directional_light_radiance(drow, n, v, albedo, roughness, metalness):
    """CalculateDirectionalLightIllumination (Lighting.hlsl:334-345)."""
    wi = B.normalize(-drow[0:3]).expand(n.shape)
    radiance = drow[4:7] * drow[3]
    ndotl = B.saturate(B._dot(n, wi))
    fr = B.brdf(n, albedo, roughness, metalness, wi, v)
    return fr * radiance * ndotl[..., None] * drow[9]  # * enabled


def shade_forward(world_pos, normal, albedo, roughness, metalness, emissive,
                  ao, camera_pos, point_lights, spot_lights, spot_extra,
                  directional, point_casters=None, point_shadow=None,
                  spot_casters=None, spot_caster_extra=None, spot_shadow=None,
                  dir_shadow=None, env_illumination=None):
    """The PSMain illumination sum (ForwardLighting.hlsl:288-377): ambient
    + emissive + environment (env_illumination [..., 3] from
    ibl.environment_illumination) + the lights."""
    v = B.normalize(camera_pos - world_pos)
    total = albedo * ao[..., None] + emissive
    if env_illumination is not None:
        total = total + env_illumination
    args = (world_pos, normal, v, albedo, roughness, metalness)
    for i in range(point_lights.shape[0]):
        total = total + _point_light_radiance(point_lights[i], *args)
    for i in range(spot_lights.shape[0]):
        total = total + _spot_light_radiance(spot_lights[i], spot_extra[i],
                                             *args)
    if point_casters is not None:
        for i in range(point_casters.shape[0]):
            c = _point_light_radiance(point_casters[i], *args)
            total = total + c * point_shadow[i][..., None]
    if spot_casters is not None:
        for i in range(spot_casters.shape[0]):
            c = _spot_light_radiance(spot_casters[i], spot_caster_extra[i],
                                     *args)
            total = total + c * spot_shadow[i][..., None]
    dir_contrib = directional_light_radiance(directional, normal, v, albedo,
                                             roughness, metalness)
    if dir_shadow is not None:
        factor = torch.where(directional[8] > 0, dir_shadow,
                             torch.ones_like(dir_shadow))
        dir_contrib = dir_contrib * factor[..., None]
    return total + dir_contrib
