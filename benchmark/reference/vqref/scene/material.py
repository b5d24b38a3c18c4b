"""Materials — counterpart of reference Source/Engine/Scene/Material.{h,cpp}
and the GPU MaterialData struct (Shaders/LightingConstantBufferData.h:127-146).

PBR parameters + 9 texture slots; the texture-config bitfield encoding matches
LightingConstantBufferData.h:116-124 (HasDiffuseMap == bit 0, etc.) so the
shading kernel's Has*Map tests mirror the HLSL exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# texture slot names in bit order (LightingConstantBufferData.h:116-124)
TEXTURE_SLOTS = (
    "diffuse",      # bit 0
    "normal",       # bit 1
    "ao",           # bit 2 (ambient occlusion)
    "alpha_mask",   # bit 3
    "roughness",    # bit 4
    "metallic",     # bit 5
    "height",       # bit 6
    "emissive",     # bit 7
    "orm",          # bit 8 (occlusion-roughness-metalness combined)
)

MATERIAL_STRIDE = 32  # floats per material in the packed GPU tensor
_TEX_ID_BASE = 20     # slots [20..28]: per-slot texture ids (-1 = none)


@dataclass
class Material:
    name: str = "DefaultMaterial"
    diffuse: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=np.float32))
    alpha: float = 1.0
    specular: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=np.float32))
    emissive_color: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    emissive_intensity: float = 0.0
    roughness: float = 0.8
    metalness: float = 0.0
    normal_map_mip_bias: float = 0.0
    displacement: float = 0.0
    uv_scale: np.ndarray = field(default_factory=lambda: np.ones(2, dtype=np.float32))
    uv_offset: np.ndarray = field(default_factory=lambda: np.zeros(2, dtype=np.float32))
    # texture IDs into the TextureManager (-1 = none), keyed by TEXTURE_SLOTS
    textures: dict[str, int] = field(default_factory=dict)
    # upload-time combined auxiliary map (normal.xy | roughness | metalness
    # in RGBA): one sampled fetch replaces three — the texture cost is
    # fetch-count-bound on TPU. Set by TextureManager.combine_aux_maps.
    combined_aux: int = -1
    # upload-time (diffuse, combined_aux) PAIR texture id: both quads in
    # one 32 B gather row — the material pass's two dense fetches become
    # one (fetch-count economy). Set by TextureManager.combine_pair_quads.
    pair_map: int = -1
    # tessellation config (reference Material.h packed tess byte): a mesh
    # whose material enables tessellation promotes its base triangles to
    # TRI-domain control patches (ops/tessellation.amplify_tri), displaced
    # along normals by `displacement` x height_map_image (the engine fills
    # the image from the height texture slot). tessellation_scale is the
    # view distance at which the adaptive edge factor halves.
    tessellation_enabled: bool = False
    tessellation_scale: float = 100.0
    height_map_image: np.ndarray | None = None

    def texture_config(self) -> int:
        """Bitfield matching Material::GetTextureConfig / Has*Map (HLSL)."""
        cfg = 0
        for bit, slot in enumerate(TEXTURE_SLOTS):
            if self.textures.get(slot, -1) >= 0:
                cfg |= 1 << bit
        return cfg

    def pack(self) -> np.ndarray:
        """GPU MaterialData layout (LightingConstantBufferData.h:127-146),
        flattened to MATERIAL_STRIDE floats:
        [diffuse(3), alpha, emissiveColor(3), emissiveIntensity,
         uvScale(2), uvOffset(2), roughness, metalness, displacement,
         textureConfig, normalMapMipBias, pad(3),
         texture ids per TEXTURE_SLOTS (9), pad(3)]"""
        out = np.zeros(MATERIAL_STRIDE, dtype=np.float32)
        out[0:3] = self.diffuse
        out[3] = self.alpha
        out[4:7] = self.emissive_color
        out[7] = self.emissive_intensity
        out[8:10] = self.uv_scale
        out[10:12] = self.uv_offset
        out[12] = self.roughness
        out[13] = self.metalness
        out[14] = self.displacement
        out[15] = float(self.texture_config())
        out[16] = self.normal_map_mip_bias
        for bit, slot in enumerate(TEXTURE_SLOTS):
            out[_TEX_ID_BASE + bit] = float(self.textures.get(slot, -1))
        out[29] = float(self.combined_aux)
        out[30] = float(self.pair_map)
        return out


def pack_materials(materials: list[Material]) -> np.ndarray:
    if not materials:
        out = np.zeros((1, MATERIAL_STRIDE), dtype=np.float32)
        out[:, _TEX_ID_BASE:31] = -1.0   # no texture/combined-aux/pair ids
        return out
    return np.stack([m.pack() for m in materials])
