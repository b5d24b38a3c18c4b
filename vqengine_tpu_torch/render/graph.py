"""The forward render graph — counterpart of ``vqengine_tpu/render/graph.py``
for the main path: cull + LOD, raster front end, G-buffer raster (with or
without MSAA), material fetch and texture sampling, SSAO, motion vectors,
shadow maps and shadow tests, direct-light and environment (IBL) shading,
the MSAA edge resolve, the skydome or clear color background,
screen-space reflections with their temporal history, the depth-peeled
transparent pass (and the alpha-mask peel) and tonemap; the environment
maps' load-time build.

PyTorch runs eagerly, so a render graph here is a plain function of
(DeviceScene, FrameConstants) tensors on one device; nothing is traced or
compiled per resolution. The functions that a screen band of the
multi-GPU renderer calls (parallel/multichip.py) take the reference's band
arguments: full_height and y_offset place the band's rows in the frame,
halo and hdr_halo carry its neighbours' seam rows. Where the reference
shifts a band's vertices (raster.setup_triangles' y_offset), a band here
rasters the frame's rows up to its end with the frame's setup and keeps
its own (raster.rasterize_gbuf_band), and its MSAA records are the
frame's, evaluated at frame rows: its rows are then the frame's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import colorspace as cs
from ..ops import culling, ffx, ibl, palette, raster, shading, shadow, sparse
from ..ops import tessellation as tess
from ..ops import msaa as msaa_ops
from ..ops import ssao as ssao_ops
from ..ops import ssr as ssr_ops
from ..ops import texture as tex_ops
from ..ops import postprocess as pp
from ..utils import trace

# capacity of the MSAA edge compaction: frame pixels / MSAA_EDGE_CAP_FRAC,
# rounded up to a multiple of 4096 (at least 4096)
MSAA_EDGE_CAP_FRAC = 32
# capacity of the anisotropic ellipse walk: frame pixels / TEX_ANISO_WALK_FRAC
TEX_ANISO_WALK_FRAC = 32


def _tensor(a, device) -> torch.Tensor:
    """numpy -> tensor on `device`, 64-bit types narrowed to 32 bits as
    jnp.asarray narrows them."""
    a = np.array(a)           # a writable, contiguous copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


@dataclass(frozen=True)
class EnvironmentMaps:
    """Device-resident IBL resources (the output of the reference's
    load-time PreFilterEnvironmentMap, EnvironmentMapRendering.cpp:139-486),
    all on `device`. The shading-time sample tables are bf16, as the
    reference stores them (its samplers upcast to f32)."""
    device: torch.device
    equirect: torch.Tensor                 # [He, We, 3] bf16 linear HDR
    diffuse_cube: torch.Tensor             # [6, Sd, Sd, 3] bf16
    specular_mips: tuple                   # tuple of [6, S_m, S_m, 3] bf16
    brdf_lut: torch.Tensor                 # [L, L, 2] f32
    sh_irradiance: torch.Tensor            # [9, 3] f32 SH9 diffuse coefficients
    brdf_poly: torch.Tensor                # [D, D, 2] f32 Chebyshev LUT fit

    def to(self, device: torch.device) -> "EnvironmentMaps":
        """The same tables, bit for bit, on `device`."""
        device = torch.device(device)
        return EnvironmentMaps(
            device=device, equirect=self.equirect.to(device),
            diffuse_cube=self.diffuse_cube.to(device),
            specular_mips=tuple(m.to(device) for m in self.specular_mips),
            brdf_lut=self.brdf_lut.to(device),
            sh_irradiance=self.sh_irradiance.to(device),
            brdf_poly=self.brdf_poly.to(device))


def build_environment(equirect_np, device: torch.device,
                      diffuse_size: int = 64, specular_base: int = 128,
                      specular_mips: int = 6,
                      lut_size: int = 256) -> EnvironmentMaps:
    """Load-time IBL prefilter on `device` (the reference's
    build_environment): the diffuse cube and the specular mips as row-chunked
    products, the SH9 projection, the BRDF LUT (cached per device) and its
    Chebyshev fit."""
    device = torch.device(device)
    eq = torch.as_tensor(np.asarray(equirect_np, np.float32), device=device)
    lut = ibl.brdf_lut_cached(lut_size, device=device)
    return EnvironmentMaps(
        device=device,
        equirect=eq.to(torch.bfloat16),
        diffuse_cube=ibl.diffuse_irradiance_cube(
            eq, size=diffuse_size).to(torch.bfloat16),
        specular_mips=tuple(
            m.to(torch.bfloat16) for m in ibl.specular_prefilter_mips(
                eq, base_size=specular_base, num_mips=specular_mips)),
        brdf_lut=lut,
        sh_irradiance=ibl.sh9_irradiance_coeffs(eq),
        brdf_poly=torch.as_tensor(ibl.brdf_poly_fit(lut.cpu().numpy()),
                                  device=device),
    )


# how far two builds of the same environment may differ (another device,
# or the reference): the products sum their terms in another order, so an
# f32 ulp can flip a bf16 rounding of a few table entries, by one bf16 ulp;
# the f32 tables by their normwise relative error (the largest difference
# over the largest entry; the LUT's 512-sample sums round per device, and
# the degree-20 least-squares fit magnifies the LUT's difference about
# tenfold: a coefficient-wise error would be ruled by the smallest ones)
ENV_BF16_MAX_ULPS = 1
ENV_BF16_MAX_SHARE = 0.01
ENV_F32_MAX_REL = {"sh_irradiance": 1e-5, "brdf_lut": 2e-5, "brdf_poly": 2e-4}


def environment_differences(a: EnvironmentMaps, b: EnvironmentMaps) -> dict:
    """Two builds' tables compared: {bf16 table: (entries that differ,
    largest difference in bf16 ulps, entries)} and {f32 table: normwise
    relative error}; "ok" says whether every table is within the ENV_*
    bars."""
    def ulps(x, y):
        d = (x.cpu().view(torch.int16).to(torch.int32)
             - y.cpu().view(torch.int16).to(torch.int32)).abs()
        return int((d > 0).sum()), int(d.max()), d.numel()

    def rel(x, y):
        x, y = x.cpu().double(), y.cpu().double()
        return float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
    out = {"equirect": ulps(a.equirect, b.equirect),
           "diffuse_cube": ulps(a.diffuse_cube, b.diffuse_cube)}
    for m, (x, y) in enumerate(zip(a.specular_mips, b.specular_mips)):
        out[f"specular_mip{m}"] = ulps(x, y)
    for name in ENV_F32_MAX_REL:
        out[name] = rel(getattr(a, name), getattr(b, name))
    out["ok"] = all(
        (v[1] <= ENV_BF16_MAX_ULPS and v[0] <= ENV_BF16_MAX_SHARE * v[2])
        if isinstance(v, tuple) else v <= ENV_F32_MAX_REL[k]
        for k, v in out.items())
    return out


@dataclass(frozen=True)
class DeviceScene:
    """Device-resident scene geometry (see the reference's DeviceScene).
    Triangle-indexed buffers are padded to a power-of-two bucket; the
    corner tables hold positions[indices] etc. for the live triangles,
    rounded up to the raster group size (num_tris_live). Tessellated
    items carry their control patches and templates (the patch items'
    factor-1 base triangles sit at rows >= num_tris_live of the
    triangle-indexed buffers, which only the shadow maps render)."""
    positions: torch.Tensor        # [Vp, 3]
    normals: torch.Tensor
    tangents: torch.Tensor
    uvs: torch.Tensor              # [Vp, 2]
    item_of_vertex: torch.Tensor   # [Vp] int32
    indices: torch.Tensor          # [Tp, 3] int32
    tri_item: torch.Tensor         # [Tp] int32
    tri_lod: torch.Tensor          # [Tp] int32
    materials: torch.Tensor        # [M, 32]
    item_material: torch.Tensor    # [N] int32
    item_object: torch.Tensor      # [N] int32
    item_num_lods: torch.Tensor    # [N] int32
    aabb_center: torch.Tensor      # [N, 3]
    aabb_extent: torch.Tensor      # [N, 3]
    corner_positions: torch.Tensor  # [3Tl, 3]
    corner_normals: torch.Tensor
    corner_tangents: torch.Tensor
    corner_uvs: torch.Tensor        # [3Tl, 2]
    corner_morph_mid: torch.Tensor | None = None  # [3Tl, 3] geomorph targets
    num_tris_live: int = 0
    # quad patches (ops/tessellation.amplify): control data and the
    # static max-level template
    patch_corners: torch.Tensor | None = None     # [P, 4, 3]
    patch_normals: torch.Tensor | None = None     # [P, 4, 3]
    patch_uvs: torch.Tensor | None = None         # [P, 4, 2]
    patch_item: torch.Tensor | None = None        # [P] int32
    patch_heightmap: torch.Tensor | None = None   # [S, S]
    patch_params: torch.Tensor | None = None      # [Vt, 2] template grid
    patch_tri_idx: torch.Tensor | None = None     # [Tt, 3] template triangles
    patch_disp_scale: float = 0.0
    patch_tess_scale: float = 100.0
    # tri patches of items whose material enables tessellation
    # (ops/tessellation.amplify_tri)
    tpatch_corners: torch.Tensor | None = None    # [P, 3, 3]
    tpatch_normals: torch.Tensor | None = None    # [P, 3, 3]
    tpatch_uvs: torch.Tensor | None = None        # [P, 3, 2]
    tpatch_item: torch.Tensor | None = None       # [P] int32
    tpatch_heightmap: torch.Tensor | None = None  # [S, S]
    tpatch_bary: torch.Tensor | None = None       # [Vt, 3] template barycentrics
    tpatch_tri_idx: torch.Tensor | None = None    # [Tt, 3] template triangles
    tpatch_disp_scale: float = 0.0
    tpatch_tess_scale: float = 100.0


# the leaves every scene has; the rest are None or static numbers
_SCENE_TENSORS = ("positions", "normals", "tangents", "uvs", "item_of_vertex",
                  "indices", "tri_item", "tri_lod", "materials",
                  "item_material", "item_object", "item_num_lods",
                  "aabb_center", "aabb_extent", "corner_positions",
                  "corner_normals", "corner_tangents", "corner_uvs")
_SCENE_STATIC = ("patch_disp_scale", "patch_tess_scale", "tpatch_disp_scale",
                 "tpatch_tess_scale")
_SCENE_OPTIONAL = tuple(f.name for f in dataclasses.fields(DeviceScene)
                        if f.name not in _SCENE_TENSORS + _SCENE_STATIC
                        + ("num_tris_live",))


def device_scene_from_numpy(fields: dict, num_tris_live: int,
                            device: torch.device) -> DeviceScene:
    """DeviceScene from numpy leaves named as the reference's DeviceScene
    fields (extra keys are ignored; a missing optional leaf is None)."""
    kw = {name: _tensor(fields[name], device) for name in _SCENE_TENSORS}
    kw.update({name: (None if fields.get(name) is None
                      else _tensor(fields[name], device))
               for name in _SCENE_OPTIONAL})
    kw.update({name: float(fields[name]) for name in _SCENE_STATIC
               if name in fields})
    return DeviceScene(**kw, num_tris_live=int(num_tris_live))


def _bucket(n: int, minimum: int = 256) -> int:
    """Next power-of-two bucket >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def scene_fields_numpy(buffers, bucketize: bool = True) -> tuple[dict, int]:
    """SceneBuffers -> (numpy leaves of a DeviceScene, num_tris_live),
    padded exactly as the reference's upload_scene pads them."""
    v = buffers.positions.shape[0]
    t = buffers.indices.shape[0]
    t_main = t if buffers.num_tris_main is None else buffers.num_tris_main
    n = max(1, len(buffers.items))
    tl = raster.cdiv(max(t_main, 1), raster.GROUP) * raster.GROUP
    vp = _bucket(max(v, 1)) if bucketize else v
    tp = _bucket(max(t, 1)) if bucketize else max(t, tl)

    def padv(a, rows):
        if a.shape[0] == rows:
            return a
        pad = np.zeros((rows - a.shape[0],) + a.shape[1:], dtype=a.dtype)
        return np.concatenate([a, pad], axis=0)

    # padded triangles index vertex 0 three times: zero area, killed by
    # triangle setup
    idx_l = padv(buffers.indices[:t_main], tl).reshape(-1)
    morph = getattr(buffers, "morph_mid", None)
    fields = dict(
        positions=padv(buffers.positions, vp),
        normals=padv(buffers.normals, vp),
        tangents=padv(buffers.tangents, vp),
        uvs=padv(buffers.uvs, vp),
        item_of_vertex=padv(buffers.item_of_vertex, vp),
        indices=padv(buffers.indices, tp),
        tri_item=padv(buffers.tri_item, tp),
        tri_lod=padv(buffers.tri_lod, tp),
        materials=buffers.materials,
        item_material=buffers.item_material,
        item_object=buffers.item_object,
        item_num_lods=(buffers.item_num_lods if buffers.item_num_lods is not None
                       else np.ones(n, np.int32)),
        aabb_center=(buffers.aabb_center if buffers.aabb_center is not None
                     else np.zeros((n, 3), np.float32)),
        aabb_extent=(buffers.aabb_extent if buffers.aabb_extent is not None
                     else np.ones((n, 3), np.float32)),
        corner_positions=padv(buffers.positions, max(v, 1))[idx_l],
        corner_normals=padv(buffers.normals, max(v, 1))[idx_l],
        corner_tangents=padv(buffers.tangents, max(v, 1))[idx_l],
        corner_uvs=padv(buffers.uvs, max(v, 1))[idx_l],
        corner_morph_mid=(padv(morph, max(v, 1))[idx_l]
                          if morph is not None else None),
    )
    if getattr(buffers, "patch_corners", None) is not None:
        params, tri_idx = tess.build_patch_template()
        fields.update(
            patch_corners=buffers.patch_corners,
            patch_normals=buffers.patch_normals,
            patch_uvs=buffers.patch_uvs,
            patch_item=buffers.patch_item,
            patch_heightmap=buffers.patch_heightmap,
            patch_params=params, patch_tri_idx=tri_idx,
            patch_disp_scale=float(buffers.patch_disp_scale),
            patch_tess_scale=float(buffers.patch_tess_scale))
    if getattr(buffers, "tpatch_corners", None) is not None:
        bary, tri_idx_t = tess.build_tri_template()
        fields.update(
            tpatch_corners=buffers.tpatch_corners,
            tpatch_normals=buffers.tpatch_normals,
            tpatch_uvs=buffers.tpatch_uvs,
            tpatch_item=buffers.tpatch_item,
            tpatch_heightmap=buffers.tpatch_heightmap,
            tpatch_bary=bary, tpatch_tri_idx=tri_idx_t,
            tpatch_disp_scale=float(buffers.tpatch_disp_scale),
            tpatch_tess_scale=float(buffers.tpatch_tess_scale))
    return fields, tl


def upload_scene(buffers, device: torch.device,
                 bucketize: bool = True) -> DeviceScene:
    fields, tl = scene_fields_numpy(buffers, bucketize)
    return device_scene_from_numpy(fields, tl, device)


@dataclass(frozen=True)
class FrameConstants:
    """Per-frame data (the PerFrame/PerView constant buffers); same
    fields and shapes as the reference's FrameConstants."""
    world: torch.Tensor          # [N, 4, 4]
    normal_mats: torch.Tensor    # [N, 3, 3]
    view_proj: torch.Tensor      # [4, 4]
    camera_pos: torch.Tensor     # [3]
    point_lights: torch.Tensor   # [P, 12]
    spot_lights: torch.Tensor    # [S, 12]
    spot_extra: torch.Tensor     # [S, 4]
    directional: torch.Tensor    # [12]
    ambient_factor: torch.Tensor  # scalar
    clear_color: torch.Tensor    # [3]
    frustum_planes: torch.Tensor  # [6, 4]
    inv_view_proj: torch.Tensor  # [4, 4]
    hdri_yaw: torch.Tensor       # scalar
    view_matrix: torch.Tensor    # [4, 4]
    proj_params: torch.Tensor    # [4]: near, far, fov_y, aspect
    prev_world: torch.Tensor     # [N, 4, 4]
    prev_view_proj: torch.Tensor  # [4, 4]
    spot_casters: torch.Tensor      # [SC, 12]
    spot_caster_extra: torch.Tensor  # [SC, 4]
    spot_caster_vps: torch.Tensor   # [SC, 4, 4]
    point_casters: torch.Tensor     # [PC, 12]
    point_caster_vps: torch.Tensor  # [PC, 6, 4, 4]
    point_caster_range: torch.Tensor  # [PC, 2]
    dir_vp: torch.Tensor            # [0 or 1, 4, 4]


def frame_constants_from_numpy(fields: dict,
                               device: torch.device) -> FrameConstants:
    """FrameConstants from numpy leaves named as the reference's fields.
    Each non-empty leaf is a pageable upload, which synchronizes the card."""
    names = [f.name for f in dataclasses.fields(FrameConstants)]
    with trace.blocking("frame.upload",
                        sum(1 for k in names if np.size(fields[k]))):
        return FrameConstants(**{k: _tensor(fields[k], device)
                                 for k in names})


def _unproject(ndc_x: torch.Tensor, ndc_y: torch.Tensor, depth: torch.Tensor,
               inv_view_proj: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(ndc_x, ndc_y, depth, 1) through inv_view_proj -> world position
    [..., 3] (w below eps in magnitude divides by eps). The four products
    are summed in pairs, as XLA sums the reference's einsum "ij,hwj->hwi"
    and its clip @ inv_view_proj.T on the CPU: the shadow tests amplify an
    ulp of wpos into a texel flip."""
    clip = (ndc_x, ndc_y, depth, torch.ones_like(depth))
    m = inv_view_proj
    wp = [(m[i, 0] * clip[0] + m[i, 1] * clip[1])
          + (m[i, 2] * clip[2] + m[i, 3] * clip[3]) for i in range(4)]
    w = torch.where(wp[3].abs() > eps, wp[3], torch.full_like(wp[3], eps))
    return torch.stack(wp[:3], dim=-1) / w[..., None]


def world_pos_from_depth(depth: torch.Tensor, consts: FrameConstants,
                         width: int, height: int,
                         full_height: int | None = None,
                         y_offset: int = 0) -> torch.Tensor:
    """World position from the depth buffer through inv_view_proj; a
    screen band's rows sit at y_offset of a full_height-tall frame."""
    px, py = ssao_ops.ndc_axes(height, width, depth.device, y_offset,
                               full_height)
    return _unproject(px[None, :].expand(height, width),
                      py[:, None].expand(height, width), depth,
                      consts.inv_view_proj)


def _attrs_from_gbuf(scene: DeviceScene, consts: FrameConstants,
                     depth, tri_id, gbuf, width: int, height: int,
                     full_height: int | None = None, y_offset: int = 0):
    """The raster kernel's G-buffer channels -> the attribute dict shading
    consumes (full_height and y_offset place a screen band's rows)."""
    mask = tri_id != raster.BG_ID
    wpos = world_pos_from_depth(depth, consts, width, height, full_height,
                                y_offset)
    return {
        "wpos": torch.where(mask[..., None], wpos, torch.zeros_like(wpos)),
        "wnrm": gbuf[0:3].permute(1, 2, 0),
        "wtan": gbuf[3:6].permute(1, 2, 0),
        "uv": gbuf[6:8].permute(1, 2, 0),
        "mrow": palette.palette_lookup(gbuf[8].to(torch.int32), scene.materials),
        "ids": gbuf[9:11].permute(1, 2, 0),
    }, mask


def unit3(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-9) over the last axis, |v| rounded as the
    reference's jnp.linalg.norm on the CPU (shadow.norm3)."""
    return v / torch.clamp(shadow.norm3(v), min=1e-9)[..., None]


def append_amplified_patches(scene: DeviceScene, consts: FrameConstants,
                             visible, wvp, clip_c, corner_n, corner_t,
                             corner_u, tri_item, tri_mask_c):
    """Amplify the scene's quad patches (Terrain) and tri patches
    (material-driven) through their static templates (ops/tessellation.py)
    and append the frame's corner tables to the static ones; a patch
    triangle lives where its patch survives the cull, it is not
    collapsed, and its item is visible."""
    produced = []
    if scene.patch_corners is not None:
        produced.append(tess.amplify(
            scene.patch_corners, scene.patch_normals, scene.patch_uvs,
            scene.patch_item, consts.world, consts.camera_pos,
            consts.frustum_planes, scene.patch_params,
            scene.patch_tri_idx, scene.patch_tess_scale,
            heightmap=scene.patch_heightmap,
            disp_scale=scene.patch_disp_scale))
    if scene.tpatch_corners is not None:
        produced.append(tess.amplify_tri(
            scene.tpatch_corners, scene.tpatch_normals, scene.tpatch_uvs,
            scene.tpatch_item, consts.world, consts.camera_pos,
            consts.frustum_planes, scene.tpatch_bary,
            scene.tpatch_tri_idx, scene.tpatch_tess_scale,
            heightmap=scene.tpatch_heightmap,
            disp_scale=scene.tpatch_disp_scale))
    for cp, cn, ct, cu, ti_p, live_p in produced:
        live_p = live_p & visible[ti_p.long()]
        clip_p = raster.transform_clip_corners(cp, ti_p, wvp)
        clip_c = torch.cat([clip_c, clip_p])
        corner_n = torch.cat([corner_n, cn])
        corner_t = torch.cat([corner_t, ct])
        corner_u = torch.cat([corner_u, cu])
        tri_item = torch.cat([tri_item, ti_p])
        tri_mask_c = torch.cat([tri_mask_c, live_p])
    return clip_c, corner_n, corner_t, corner_u, tri_item, tri_mask_c


def geometry_setup_gbuf(scene: DeviceScene, consts: FrameConstants,
                        width: int, height: int):
    """Raster front end: cull + LOD + corner transform (with the geomorph
    where the scene has morph targets) + patch amplification + triangle
    setup + packed G-buffer attributes -> (TriangleSetup, extra record
    columns)."""
    with trace.span("vq.raster.setup", consts.view_proj.device):
        visible, lod = culling.cull_and_select_lod(
            consts.world, scene.aabb_center, scene.aabb_extent,
            consts.frustum_planes, consts.view_proj, scene.item_num_lods)
        tri_mask = culling.triangle_mask_from_items(
            scene.tri_item, scene.tri_lod, visible, lod)
        wvp = raster.world_view_proj(consts.view_proj, consts.world)
        tl = scene.num_tris_live
        tri_item = scene.tri_item[:tl]
        if scene.corner_morph_mid is not None:
            # the per-item factor from the same projected area the LOD uses
            wc, we = culling.world_aabbs(consts.world, scene.aabb_center,
                                         scene.aabb_extent)
            area = culling.projected_bb_area(wc, we, consts.view_proj)
            morph_w = culling.tessellation_morph_factor(lod, area,
                                                        scene.item_num_lods)
            clip_c = raster.transform_clip_corners_morph(
                scene.corner_positions, scene.corner_morph_mid, tri_item, wvp,
                morph_w)
        else:
            clip_c = raster.transform_clip_corners(scene.corner_positions,
                                                   tri_item, wvp)
        clip_c, corner_n, corner_t, corner_u, tri_item, tri_mask_c = \
            append_amplified_patches(scene, consts, visible, wvp, clip_c,
                                     scene.corner_normals,
                                     scene.corner_tangents, scene.corner_uvs,
                                     tri_item, tri_mask[:tl])
        setup = raster.setup_triangles(clip_c, width, height,
                                       tri_mask=tri_mask_c)
        ti = tri_item.long()
        extra = raster.pack_gbuf_extra_corners(
            corner_n, corner_t, corner_u, tri_item, consts.normal_mats,
            scene.item_material[ti], scene.item_object[ti])
    return setup, extra


def probe_pair_demand(scene: DeviceScene, consts: FrameConstants,
                      width: int, height: int) -> torch.Tensor:
    """The binning pair demand of one frame (the geometry front end only),
    which feeds raster.pair_cap_bucket."""
    setup, _ = geometry_setup_gbuf(scene, consts, width, height)
    return raster.pair_demand_of(setup)


def geometry_pass(scene: DeviceScene, consts: FrameConstants,
                  width: int, height: int, msaa: bool = False,
                  return_binned: bool = False,
                  pair_capacity: int | None = None, tel: dict | None = None):
    """Cull + raster front end + binning + G-buffer raster ->
    (depth, tri_id, attrs, mask, coverage), and the binning last with
    return_binned (the alpha-mask peel rasterizes it again). attrs carries
    the binning overflow and pair demand of the frame. With msaa, coverage
    is the kernel's per-sample coverage [4, H, W] and attrs["records"] the
    packed per-triangle records the edge resolve re-tests; else coverage is
    None."""
    setup, extra = geometry_setup_gbuf(scene, consts, width, height)
    binned = raster.bin_triangles(setup, width, height, extra=extra,
                                  pair_capacity=pair_capacity)
    if tel is not None:
        tel["raster_pairs"] = raster.div_true(binned.demand.to(torch.float32),
                                              binned.pair_cap)
    coverage = None
    if msaa:
        depth, tri_id, gbuf, coverage = raster.rasterize_gbuf(
            binned, width, height, msaa=True)
    else:
        depth, tri_id, gbuf = raster.rasterize_gbuf(binned, width, height)
    attrs, mask = _attrs_from_gbuf(scene, consts, depth, tri_id, gbuf,
                                   width, height)
    attrs["overflow"] = binned.overflow
    attrs["pair_demand"] = binned.demand
    if msaa:
        attrs["records"] = raster.pack_records(setup, extra)
    if return_binned:
        return depth, tri_id, attrs, mask, coverage, binned
    return depth, tri_id, attrs, mask, coverage


def slots_used_of(materials) -> tuple:
    """Static texture-slot usage of a packed [M, 32] materials array: 9
    per-slot flags and the combined-aux flag (col 29). The texture-config
    PSO permutation analog: unused slots never sample."""
    m = np.asarray(materials)
    flags = [bool((m[:, 20 + k] >= 0).any()) for k in range(9)]
    flags.append(bool((m[:, 29] >= 0).any()))
    return tuple(flags)


def material_pass(wnrm: torch.Tensor, mrow: torch.Tensor, ids: torch.Tensor,
                  uv: torch.Tensor | None = None,
                  wtan: torch.Tensor | None = None,
                  textures: tex_ops.PackedTextures | list | None = None,
                  aniso_taps: int = 0, slots_used: tuple | None = None,
                  lod: torch.Tensor | None = None,
                  mip_jitter: torch.Tensor | None = None,
                  telemetry: dict | None = None) -> dict:
    """The PSMain material block (ForwardLighting.hlsl:226-277): the
    material row's constants, and with textures the sampled slots, each
    gated by its Has*Map test: albedo and emissive decode sRGB, the
    combined aux map (normal xy, roughness, metalness) and the slots 1-8
    perturb the normal and scale the row's factors; the alpha is the
    diffuse map's (or the slot-3 alpha mask's) where there is one, else the
    row's. With pair rows (TextureManager.combine_pair_quads) the diffuse
    and aux maps come from one tap, anisotropic with aniso_taps > 1 (the
    adaptive ellipse walk, capacity frame / TEX_ANISO_WALK_FRAC, its
    saturation into telemetry). slots_used: the scene's slot flags
    (slots_used_of); None samples every slot. Shape-blind: [H, W] images
    or the compacted [R2, 512] lanes of the "shade" resolve (uv gradients
    then difference neighbouring lanes, as in the reference)."""
    out = {
        "albedo": mrow[..., 0:3],
        "alpha": mrow[..., 3],
        "emissive": mrow[..., 4:7] * mrow[..., 7:8],
        "roughness": mrow[..., 12],
        "metalness": mrow[..., 13],
        "local_ao": torch.ones_like(mrow[..., 0]),
        "normal": wnrm,
        "object_id": ids[..., 0].to(torch.int32),
        "item_id": ids[..., 1].to(torch.int32),
    }
    if textures is None or uv is None:
        return out

    uv_t = uv * mrow[..., 8:10] + mrow[..., 10:12]          # uvScaleOffset
    max_lod = tex_ops.tex_num_levels(textures) - 1
    if lod is None:
        lod = tex_ops.uv_mip_level(uv_t, tex_ops.tex_base_size(textures), max_lod)

    def slot_id(bit):
        return mrow[..., 20 + bit].to(torch.int32)

    def has(bit):
        return slot_id(bit) >= 0

    def used(bit):
        return slots_used is None or (bit < len(slots_used) and bool(slots_used[bit]))

    def sample(bit, lod_bias=None):
        lv = lod if lod_bias is None else torch.clamp(lod + lod_bias, 0.0, float(max_lod))
        return tex_ops.sample_texture_array(textures, slot_id(bit), uv_t, lv,
                                            jitter=mip_jitter)

    # the pair rows: the diffuse and combined-aux quads in one tap
    pair_ok = (isinstance(textures, tex_ops.PackedTextures)
               and textures.pair_flat is not None and (used(0) or used(9)))
    diffuse_s = aux = None
    if pair_ok:
        pid = mrow[..., 30].to(torch.int32)
        if aniso_taps > 1:
            diffuse_s, aux = tex_ops.sample_texture_pair_aniso(
                textures, pid, slot_id(0), uv_t, num_taps=aniso_taps,
                jitter=mip_jitter, adaptive_frac=TEX_ANISO_WALK_FRAC,
                telemetry=telemetry)
        else:
            diffuse_s, aux = tex_ops.sample_texture_pair(textures, pid, uv_t, lod,
                                                         jitter=mip_jitter)
    if used(0):
        if diffuse_s is None:
            if aniso_taps > 1:
                diffuse_s = tex_ops.sample_texture_array_aniso(
                    textures, slot_id(0), uv_t, num_taps=aniso_taps,
                    jitter=mip_jitter, adaptive_frac=TEX_ANISO_WALK_FRAC,
                    telemetry=telemetry)
            else:
                diffuse_s = sample(0)
        h0 = has(0)
        out["albedo"] = torch.where(
            h0[..., None], cs.srgb_to_linear_fast(diffuse_s[..., :3]) * mrow[..., 0:3],
            mrow[..., 0:3])
        out["alpha"] = torch.where(h0, diffuse_s[..., 3], mrow[..., 3])
    # a dedicated alpha-mask map (slot 3) overrides the diffuse alpha
    if used(3):
        out["alpha"] = torch.where(has(3), sample(3)[..., 0], out["alpha"])
    if wtan is not None and used(1):
        n_mapped = tex_ops.unpack_normal_map(
            sample(1, lod_bias=mrow[..., 16])[..., :3], wnrm, wtan)
        out["normal"] = torch.where(has(1)[..., None], n_mapped, wnrm)
    # the combined auxiliary map (normal.xy | roughness | metalness)
    if used(9):
        has_c = mrow[..., 29].to(torch.int32) >= 0
        if aux is None:
            l_aux = torch.clamp(lod + mrow[..., 16], 0.0, float(max_lod))
            aux = tex_ops.sample_texture_array(textures, mrow[..., 29].to(torch.int32),
                                               uv_t, l_aux, jitter=mip_jitter)
        if wtan is not None:
            n_c = tex_ops.unpack_normal_map_xy(aux[..., 0:2], wnrm, wtan)
            out["normal"] = torch.where(has_c[..., None], n_c, out["normal"])
        out["roughness"] = torch.where(has_c, mrow[..., 12] * aux[..., 2],
                                       out["roughness"])
        out["metalness"] = torch.where(has_c, mrow[..., 13] * aux[..., 3],
                                       out["metalness"])
    if used(2):
        out["local_ao"] = torch.where(has(2), sample(2)[..., 0], out["local_ao"])
    if used(4):
        out["roughness"] = torch.where(has(4), out["roughness"] * sample(4)[..., 0],
                                       out["roughness"])
    if used(5):
        out["metalness"] = torch.where(has(5), out["metalness"] * sample(5)[..., 0],
                                       out["metalness"])
    if used(7):
        out["emissive"] = torch.where(
            has(7)[..., None],
            cs.srgb_to_linear_fast(sample(7)[..., :3]) * mrow[..., 4:7] * mrow[..., 7:8],
            out["emissive"])
    if used(8):
        orm = sample(8)
        out["roughness"] = torch.where(has(8), out["roughness"] * orm[..., 1],
                                       out["roughness"])
        out["metalness"] = torch.where(has(8), out["metalness"] * orm[..., 2],
                                       out["metalness"])
    return out


def pool2(x: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """2x2 downsample of [H, W, ...]: ffx.reduce2, which sums a 2x2 block
    in XLA's CPU order for the reference's reshape."""
    return ffx.reduce2(x, reduce)


def up2_fit(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """2x nearest upsample of [Hq, Wq, ...] fitted to exactly (h, w): odd
    targets get an edge-replicated last row or column."""
    y = x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:h, :w]
    if y.shape[0] < h:
        y = torch.cat([y, y[-1:].expand(h - y.shape[0], *y.shape[1:])], dim=0)
    if y.shape[1] < w:
        y = torch.cat([y, y[:, -1:].expand(y.shape[0], w - y.shape[1],
                                           *y.shape[2:])], dim=1)
    return y


def _mat4_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., 4, 4] @ b [..., 4, 4], each entry an FMA chain over j, as
    XLA rounds the reference's 4x4 `@` and its einsum "nij,njk->nik" on the
    CPU."""
    acc = a[..., :, 0, None] * b[..., None, 0, :]
    for j in range(1, 4):
        acc = raster._fma(a[..., :, j, None], b[..., None, j, :], acc)
    return acc


def inv4(m: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 4, 4] f32 matrices, bit for bit as the reference's
    jnp.linalg.inv on the CPU: LAPACK's sgetrf and two strsm (the
    scipy-linked kernels XLA calls). The factorization is left-looking with
    partial pivoting: a column's upper entries subtract a dot product
    summed as an FMA chain from its last term back, its lower entries one
    summed as an FMA chain from its first term, and the multipliers scale
    by the pivot's reciprocal; the solves of P I are right-looking with
    fused updates, the upper one scaling by the diagonal's reciprocal (0 of
    64,800 entries differ on 2,000 random rigid and 2,050 random matrices;
    torch.linalg.inv differs on 61% of random matrices' entries)."""
    a = m.clone()
    perm = torch.arange(4, device=m.device).expand(m.shape[:-1])
    one = raster.scalar_on(1.0, m.device)
    for j in range(4):
        for i in range(1, j):
            s = a[..., i, i - 1] * a[..., i - 1, j]
            for k in reversed(range(i - 1)):
                s = raster._fma(a[..., i, k], a[..., k, j], s)
            a[..., i, j] = a[..., i, j] - s
        if j:
            for i in range(j, 4):
                s = a[..., i, 0] * a[..., 0, j]
                for k in range(1, j):
                    s = raster._fma(a[..., i, k], a[..., k, j], s)
                a[..., i, j] = a[..., i, j] - s
        # swap row j with the pivot's (the first largest |a| at or below j)
        p = j + torch.argmax(a[..., j:, j].abs(), dim=-1, keepdim=True)
        rows = torch.arange(4, device=m.device).expand(perm.shape).clone()
        rows[..., j:j + 1] = p
        rows.scatter_(-1, p, j)
        perm = torch.gather(perm, -1, rows)
        a = torch.gather(a, -2, rows[..., None].expand(a.shape)).clone()
        a[..., j + 1:, j] = a[..., j + 1:, j] * raster.div_true(one, a[..., j, j])[..., None]
    c = torch.nn.functional.one_hot(perm, 4).to(m.dtype)   # P I
    for i in range(4):
        for k in range(i + 1, 4):
            c[..., k, :] = raster._fma(-c[..., i, :], a[..., k, i, None], c[..., k, :])
    for i in reversed(range(4)):
        c[..., i, :] = c[..., i, :] * raster.div_true(one, a[..., i, i])[..., None]
        for k in range(i):
            c[..., k, :] = raster._fma(-c[..., i, :], a[..., k, i, None], c[..., k, :])
    return c


def _xyw_rows(m: torch.Tensor) -> torch.Tensor:
    """Rows 0, 1 and 3 (x, y, w) of [..., 4, 4] (slices: no index tensor to
    copy to the device)."""
    return torch.cat([m[..., 0:2, :], m[..., 3:4, :]], dim=-2)


def _clip_xyw(rows: torch.Tensor, wpos: torch.Tensor) -> torch.Tensor:
    """rows [3, 4] (the x, y, w rows of a clip transform) x (wpos, 1) ->
    [..., 3], the four products summed in pairs as XLA sums the reference's
    einsum "ij,hwj->hwi" on the CPU."""
    x, y, z = wpos.unbind(-1)
    return torch.stack([(rows[i, 0] * x + rows[i, 1] * y)
                        + (rows[i, 2] * z + rows[i, 3]) for i in range(3)], dim=-1)


def motion_vectors(scene: DeviceScene, consts: FrameConstants,
                   wpos: torch.Tensor, tri_id: torch.Tensor, mask: torch.Tensor,
                   item_id: torch.Tensor | None = None,
                   dynamic_item_ids: tuple | None = None) -> torch.Tensor:
    """NDC-space motion [H, W, 2] = curr.xy/w - prev.xy/w at the resolved
    surface (ForwardLighting.hlsl:385-388), 0 off the mask. The previous
    position follows rigid motion: prev_world @ inv(world) per item.

    dynamic_item_ids (the items whose transform changed): static geometry
    reprojects by prev_view_proj alone and each listed item overrides its
    pixels with its own rows, so a static camera gives exactly 0. None (or
    more than 16 items) takes the palette path: each item's folded
    prev_view_proj @ delta rows [N, 12] fetched per pixel by K3. item_id:
    the per-pixel item ids of the G-buffer (else gathered from tri_id)."""
    curr_clip = _clip_xyw(_xyw_rows(consts.view_proj), wpos)
    if dynamic_item_ids is not None and len(dynamic_item_ids) > 16:
        dynamic_item_ids = None
    if item_id is None and (dynamic_item_ids is None or len(dynamic_item_ids)):
        item_id = scene.tri_item[tri_id.clamp(min=0).long()]
    if dynamic_item_ids is not None:
        prev_clip = _clip_xyw(_xyw_rows(consts.prev_view_proj), wpos)
        for i in dynamic_item_ids:
            delta_i = _mat4_fma(consts.prev_world[i], inv4(consts.world[i]))
            rows_i = _xyw_rows(_mat4_fma(consts.prev_view_proj, delta_i))
            prev_clip = torch.where((item_id == i)[..., None],
                                    _clip_xyw(rows_i, wpos), prev_clip)
    else:
        delta = _mat4_fma(consts.prev_world, inv4(consts.world))
        rows = _xyw_rows(raster.world_view_proj(consts.prev_view_proj, delta))
        dm = palette.palette_lookup(item_id, rows.reshape(-1, 12).contiguous()) \
            .reshape(item_id.shape + (3, 4))
        x, y, z = wpos.unbind(-1)
        # "hwij,hwj->hwi": an FMA chain over j; the last term's factor is 1
        prev_clip = torch.stack([dm[..., i, 3] + raster._fma(
            dm[..., i, 2], z, raster._fma(dm[..., i, 1], y, dm[..., i, 0] * x))
            for i in range(3)], dim=-1)

    def safe_w(c):
        w = c[..., 2:3]
        return torch.where(torch.abs(w) > 1e-9, w, torch.full_like(w, 1e-9))
    motion = curr_clip[..., :2] / safe_w(curr_clip) - prev_clip[..., :2] / safe_w(prev_clip)
    return torch.where(mask[..., None], motion, torch.zeros_like(motion))


SHADOW_DIMS = (shadow.SPOT_SHADOW_DIM, shadow.POINT_SHADOW_DIM,
               shadow.DIRECTIONAL_SHADOW_DIM)


def render_shadow_maps(scene: DeviceScene, consts: FrameConstants,
                       shadow_dims: tuple[int, int, int] = SHADOW_DIMS,
                       filter_mode: str = "esm") -> dict:
    """Render every caster's depth map (the per-light shadow passes,
    SceneRendering.cpp:1114-1263), one kernel-K2 view at a time: spot
    maps, then the six faces of each point cube (radial distance / far),
    then the directional map. ESM maps are prefiltered and stored as
    bf16: spot and directional pooled once, point cubes twice. Caster
    counts come from the leading sizes of the caster arrays."""
    maps: dict = {}
    sc = int(consts.spot_casters.shape[0])
    pc = int(consts.point_casters.shape[0])
    has_dir = int(consts.dir_vp.shape[0]) > 0
    esm = filter_mode == "esm"

    def depth_of(vp, size):
        return shadow.render_shadow_depth(
            scene.positions, scene.item_of_vertex, consts.world, vp,
            scene.indices, size)

    if sc:
        dm = torch.stack([depth_of(consts.spot_caster_vps[i], shadow_dims[0])
                          for i in range(sc)])
        maps["spot"] = (shadow.prefilter_esm(dm, pool=1).to(torch.bfloat16)
                        if esm else dm)
    if pc:
        vps6 = consts.point_caster_vps.reshape(pc * 6, 4, 4)
        nf6 = consts.point_caster_range.repeat_interleave(6, dim=0)
        faces = torch.stack([
            shadow.ndc_depth_to_radial(depth_of(vps6[k], shadow_dims[1]),
                                       nf6[k, 0], nf6[k, 1])
            for k in range(pc * 6)])
        cubes = faces.reshape(pc, 6, shadow_dims[1], shadow_dims[1])
        maps["point"] = (shadow.prefilter_esm(cubes, pool=2).to(torch.bfloat16)
                         if esm else cubes)
    if has_dir:
        d = depth_of(consts.dir_vp[0], shadow_dims[2])
        maps["dir"] = (shadow.prefilter_esm(d, pool=1).to(torch.bfloat16)
                       if esm else d)
    return maps


def shadow_pass(scene: DeviceScene, consts: FrameConstants,
                wpos: torch.Tensor, normal: torch.Tensor,
                shadow_dims: tuple[int, int, int] = SHADOW_DIMS,
                filter_mode: str = "esm",
                shadow_maps: dict | None = None):
    """Per-caster shadow visibility over the main view -> (spot [SC, H, W],
    point [PC, H, W], dir [H, W]), each None without such casters. Maps
    come from `shadow_maps` (cached for static lights) or are rendered
    in the frame by render_shadow_maps. ESM tests the directional caster
    at half resolution and spot and point casters at quarter resolution,
    then scales them back up (edge rows and columns replicated where a
    side is odd); PCF tests at full resolution."""
    sc = int(consts.spot_casters.shape[0])
    pc = int(consts.point_casters.shape[0])
    has_dir = int(consts.dir_vp.shape[0]) > 0
    if shadow_maps is None:
        shadow_maps = render_shadow_maps(scene, consts, shadow_dims,
                                         filter_mode)
    esm = filter_mode == "esm"
    full_h, full_w = wpos.shape[:2]
    if esm:
        wpos_h = pool2(wpos)
        wpos_q = pool2(wpos_h)

    def up(v, times=1):
        if not esm:
            return v
        for _ in range(times):
            v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        v = v[..., :full_h, :full_w]
        ph = full_h - v.shape[-2]
        pw = full_w - v.shape[-1]
        if ph > 0:
            v = torch.cat([v] + [v[..., -1:, :]] * ph, dim=-2)
        if pw > 0:
            v = torch.cat([v] + [v[..., :, -1:]] * pw, dim=-1)
        return v

    spot_vis = None
    if sc:
        if esm:
            vis = shadow.shadow_test_esm_batch(
                wpos_q, consts.spot_caster_vps[:sc], shadow_maps["spot"][:sc],
                consts.spot_casters[:, 11])
        else:
            per = []
            for i in range(sc):
                lrow = consts.spot_casters[i]
                wi = unit3(lrow[0:3] - wpos)
                ndotl = torch.clamp(shadow.dot3(normal, wi), 0.0, 1.0)
                per.append(shadow.shadow_test_pcf(
                    wpos, ndotl, consts.spot_caster_vps[i],
                    shadow_maps["spot"][i], lrow[11], slope_scaled=True))
            vis = torch.stack(per)
        spot_vis = up(vis, times=2)

    point_vis = None
    if pc:
        if esm:
            vis = shadow.omni_shadow_test_esm_batch(
                wpos_q, consts.point_casters[:, 0:3], shadow_maps["point"][:pc],
                consts.point_casters[:, 9], consts.point_casters[:, 8])
        else:
            vis = torch.stack([shadow.omni_shadow_test_pcf(
                wpos, consts.point_casters[i, 0:3], shadow_maps["point"][i],
                consts.point_casters[i, 9], consts.point_casters[i, 8],
                consts.camera_pos) for i in range(pc)])
        point_vis = up(vis, times=2)

    dir_vis = None
    if has_dir:
        # the directional shadowing flag rides in directional[8]
        dmap = shadow_maps["dir"]
        if esm:
            dir_vis = shadow.shadow_test_esm(
                wpos_h, consts.dir_vp[0], dmap, consts.directional[7])
        else:
            wi = -consts.directional[0:3]
            wi = wi / torch.clamp(shadow.norm3(wi), min=1e-9)
            ndotl = torch.clamp(shadow.dot3(normal, wi), 0.0, 1.0)
            dir_vis = shadow.shadow_test_pcf(
                wpos, ndotl, consts.dir_vp[0], dmap, consts.directional[7],
                slope_scaled=False)
        dir_vis = up(dir_vis)
    return spot_vis, point_vis, dir_vis


def msaa_edge_cap(width: int, height: int) -> int:
    """The edge compaction's capacity: frame pixels / MSAA_EDGE_CAP_FRAC,
    rounded up to a multiple of 4096 (at least 4096)."""
    return -(-max(4096, (width * height) // MSAA_EDGE_CAP_FRAC) // 4096) * 4096


def _msaa_edge_neighbor(attrs: dict, tri_id: torch.Tensor,
                        depth: torch.Tensor, mask: torch.Tensor,
                        cov_s: torch.Tensor, hdr: torch.Tensor,
                        width: int, height: int,
                        telemetry: dict | None = None,
                        halo: tuple | None = None,
                        hdr_halo: torch.Tensor | None = None,
                        cap: int | None = None, choose=None,
                        y_offset: int = 0):
    """The neighbor-color MSAA edge resolve (the default mode): exact
    per-sample visibility from msaa.resolve_secondary, and the secondary
    surface's color taken from the first 4-neighbor pixel whose primary
    winner is that surface (already shaded one pixel away), matched on the
    compacted lanes. -> (w_sec [H, W] the secondary's sample weight,
    sec_rgb [H, W, 3] its pre-weighted color). A screen band of a frame
    (parallel/multichip.py) passes halo and hdr_halo, its (tri_id, depth,
    object_id, mask) and hdr with one neighbour row above and below, the
    frame's records and y_offset, its first row (the records are
    evaluated at frame rows); the outputs stay the band's. cap (default
    msaa_edge_cap) and choose (the edge threshold's choice,
    msaa.resolve_secondary): a band resolves the whole frame's edge
    set."""
    cap = msaa_edge_cap(width, height) if cap is None else cap
    object_id = attrs["ids"][..., 0].to(torch.int32)
    det = halo if halo is not None else (tri_id, depth, object_id, mask)
    pad = 1 if halo is not None else 0
    idx, live, sec_id, n_sec, _, _ = msaa_ops.resolve_secondary(
        attrs["records"], det[0], det[1], det[2], det[3], cov_s, cap,
        pad=pad, telemetry=telemetry, choose=choose, y_offset=y_offset)
    tid_flat = det[0].reshape(-1)
    hp = det[0].shape[0]               # the padded rows
    px_i = idx % width
    py_i = torch.div(idx, width, rounding_mode="floor") + pad
    sel = torch.zeros_like(idx)
    found = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    for dy, dx in msaa_ops.NEIGHBOR_OFFSETS:
        nidx = ((py_i + dy).clamp(0, hp - 1) * width
                + (px_i + dx).clamp(0, width - 1))
        match = ~found & (tid_flat[nidx] == sec_id)
        sel = torch.where(match, nidx, sel)
        found = found | match
    sec_rgb = (hdr if hdr_halo is None else hdr_halo).reshape(-1, 3)[sel]
    # unfound secondaries keep the primary; live excludes n_sec == 0
    w_c = torch.where(found, n_sec * 0.25, torch.zeros_like(n_sec))
    w_img = sparse.scatter_pixels(
        torch.zeros((height, width), dtype=torch.float32, device=hdr.device),
        idx, w_c, live)
    sec_w = sparse.scatter_pixels(torch.zeros_like(hdr), idx,
                                  sec_rgb * w_c[:, None], live)
    return w_img, sec_w


def environment_term(consts: FrameConstants, env: EnvironmentMaps | None,
                     wpos: torch.Tensor, n: torch.Tensor, mat: dict):
    """The split-sum environment term of surfaces at wpos with normals n
    and material mat, viewed from the camera; None without env."""
    if env is None:
        return None
    v = unit3(consts.camera_pos - wpos)
    return ibl.environment_illumination(
        n, v, mat["roughness"], mat["metalness"], mat["albedo"],
        env.diffuse_cube, list(env.specular_mips), env.brdf_lut,
        hdri_yaw=consts.hdri_yaw, sh_irradiance=env.sh_irradiance,
        brdf_poly=env.brdf_poly)


def _msaa_edge_secondary(scene: DeviceScene, consts: FrameConstants,
                         attrs: dict, tri_id: torch.Tensor,
                         depth: torch.Tensor, mask: torch.Tensor,
                         cov_s: torch.Tensor, spot_vis, point_vis, dir_vis,
                         width: int, height: int, enable_shadows: bool,
                         telemetry: dict | None = None,
                         env: EnvironmentMaps | None = None,
                         ao_map: torch.Tensor | None = None,
                         textures=None, aniso_taps: int = 0,
                         slots_used: tuple | None = None,
                         mip_jit: torch.Tensor | None = None,
                         halo: tuple | None = None,
                         full_height: int | None = None,
                         y_offset: int = 0, cap: int | None = None,
                         choose=None):
    """The "shade" MSAA edge resolve: the secondary surface of each edge
    pixel (msaa.resolve_secondary) interpolated from its record at the
    pixel center (raster.interp_record_attrs), unprojected from its depth,
    and shaded by the same material, environment and direct-light path as
    the primary on the compacted list; shadow visibility is the pixel's
    own, and so is its SSAO term (ao_map [H, W], when given). With
    textures its material_pass runs on the compacted [cap / 512, 512]
    lanes, as in the reference: the uv gradients there difference
    neighbouring lanes, and the mip jitter is the edge pixel's. -> (w_sec
    [H, W], sec_rgb [H, W, 3] pre-weighted). A screen band passes halo, its
    (tri_id, depth, object_id, mask) with one neighbour row above and
    below, the frame's records, full_height and y_offset (the records are
    interpolated and the surface unprojected at frame rows), and cap and
    choose as _msaa_edge_neighbor does."""
    cap = msaa_edge_cap(width, height) if cap is None else cap
    fh = height if full_height is None else full_height
    object_id = attrs["ids"][..., 0].to(torch.int32)
    records = attrs["records"]
    det = halo if halo is not None else (tri_id, depth, object_id, mask)
    idx, live, sec_id, n_sec, px, py = msaa_ops.resolve_secondary(
        records, det[0], det[1], det[2], det[3], cov_s, cap,
        pad=1 if halo is not None else 0, telemetry=telemetry, choose=choose,
        y_offset=y_offset)
    a = raster.interp_record_attrs(records[sec_id.clamp(min=0).long()], px, py)

    wpos = _unproject(raster.div_true(px, width) * 2.0 - 1.0,
                      1.0 - raster.div_true(py, fh) * 2.0,
                      a["depth"], consts.inv_view_proj)

    def r2(v):                       # [cap(, k)] -> [cap / 512, 512(, k)]
        return v.reshape((cap // 512, 512) + tuple(v.shape[1:]))

    mrow = palette.palette_lookup(r2(a["mat_id"]), scene.materials)
    ids = torch.stack([a["object_id"].to(torch.float32),
                       a["item_id"].to(torch.float32)], dim=-1)
    mj = None if mip_jit is None else r2(sparse.gather_pixels(mip_jit, idx))
    # no telemetry: the walk's compaction runs on the capped edge list
    mat = material_pass(r2(unit3(a["wnrm"])), mrow, r2(ids), uv=r2(a["uv"]),
                        wtan=r2(a["wtan"]), textures=textures,
                        aniso_taps=aniso_taps, slots_used=slots_used,
                        mip_jitter=mj)
    mat = {k: v.reshape((cap,) + tuple(v.shape[2:])) for k, v in mat.items()}

    def gs(v):                       # [C, H, W] -> [C, cap]
        return torch.stack([v[c].reshape(-1)[idx] for c in range(v.shape[0])])

    ao = consts.ambient_factor * mat["local_ao"]
    if ao_map is not None:
        ao = ao * sparse.gather_pixels(ao_map, idx)
    hdr_c = shading.shade_forward(
        world_pos=wpos, normal=mat["normal"], albedo=mat["albedo"],
        roughness=mat["roughness"], metalness=mat["metalness"],
        emissive=mat["emissive"], ao=ao,
        camera_pos=consts.camera_pos, point_lights=consts.point_lights,
        spot_lights=consts.spot_lights, spot_extra=consts.spot_extra,
        directional=consts.directional,
        point_casters=consts.point_casters if enable_shadows else None,
        point_shadow=gs(point_vis) if point_vis is not None else None,
        spot_casters=consts.spot_casters if enable_shadows else None,
        spot_caster_extra=consts.spot_caster_extra if enable_shadows else None,
        spot_shadow=gs(spot_vis) if spot_vis is not None else None,
        dir_shadow=(sparse.gather_pixels(dir_vis, idx)
                    if dir_vis is not None else None),
        env_illumination=environment_term(consts, env, wpos, mat["normal"], mat))
    wt = torch.where(live, n_sec * 0.25, torch.zeros_like(n_sec))
    w_img = sparse.scatter_pixels(
        torch.zeros((height, width), dtype=torch.float32, device=px.device),
        idx, wt, live)
    rgb_img = sparse.scatter_pixels(
        torch.zeros((height, width, 3), dtype=torch.float32, device=px.device),
        idx, hdr_c * wt[:, None], live)
    return w_img, rgb_img


def _sky_dirs(consts: FrameConstants, px: torch.Tensor,
              py: torch.Tensor) -> torch.Tensor:
    """Unit world-space view rays through NDC columns px [W] and rows py
    [H] at depth 0.5 -> [H, W, 3]."""
    h, w = py.shape[0], px.shape[0]
    wp = _unproject(px[None, :].expand(h, w), py[:, None].expand(h, w),
                    torch.full((h, w), 0.5, device=px.device),
                    consts.inv_view_proj, eps=1e-9)
    return unit3(wp - consts.camera_pos)


def sky_directions(consts: FrameConstants, width: int,
                   height: int) -> torch.Tensor:
    """Per-pixel world-space view-ray directions for skydome sampling."""
    dev = consts.camera_pos.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width * 2.0 - 1.0
    py = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height * 2.0
    return _sky_dirs(consts, px, py)


def _sky_quarter_dirs(consts: FrameConstants, width: int, height: int,
                      y_offset: int = 0,
                      out_rows: int | None = None) -> torch.Tensor:
    """View-ray directions on the quarter-resolution grid whose cell (qy,
    qx) centers at full-res pixel coords (4qx + 2, y_offset + 4qy + 2);
    out_rows limits the rows (a screen band of the frame)."""
    dev = consts.camera_pos.device
    qw = -(-width // 4)
    qh = -(-(height if out_rows is None else out_rows) // 4)
    px = raster.div_true(
        4.0 * torch.arange(qw, dtype=torch.float32, device=dev) + 2.0,
        width) * 2.0 - 1.0
    rows = 4.0 * torch.arange(qh, dtype=torch.float32, device=dev)
    if y_offset:
        rows = rows + y_offset
    py = 1.0 - raster.div_true(rows + 2.0, height) * 2.0
    return _sky_dirs(consts, px, py)


def _axis_up4(a: torch.Tensor, axis: int, n_out: int,
              prev: torch.Tensor | None = None,
              nxt: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear 4x upsample along one axis of a quarter grid (centers at
    4i + 1.5): +-1 shifts (edge-clamped) blended with the four static
    phase weights, interleaved by reshape. Output index y reads quarter
    coord (y + 0.5)/4 - 0.5. prev/nxt replace the shifted copies (a
    screen band passes its neighbours' rows, so that its seams blend as
    the whole frame does)."""
    n = a.shape[axis]
    if prev is None:
        prev = torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)],
                         dim=axis)
    if nxt is None:
        nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                        dim=axis)
    # phases r = 0..3: p = i + (2r - 3)/8
    phases = [0.375 * prev + 0.625 * a,
              0.125 * prev + 0.875 * a,
              0.875 * a + 0.125 * nxt,
              0.625 * a + 0.375 * nxt]
    out = torch.stack(phases, dim=axis + 1)
    shape = list(a.shape)
    shape[axis] = shape[axis] * 4
    return out.reshape(shape).narrow(axis, 0, n_out)


def _upsample4_phase(q: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return _axis_up4(_axis_up4(q, 0, height), 1, width)


def sky_background(consts: FrameConstants, env: EnvironmentMaps,
                   width: int, height: int) -> torch.Tensor:
    """Skydome radiance for the frame: bilinear equirect taps on the
    quarter-resolution grid, upsampled 4x by the phase blend."""
    sky_q = ibl.sky_radiance(_sky_quarter_dirs(consts, width, height),
                             env.equirect, consts.hdri_yaw, bilinear=True)
    return _upsample4_phase(sky_q, height, width)


def shade_transparent_layer(scene_t: DeviceScene, consts: FrameConstants,
                            depth, tri_id, gbuf, width: int, height: int,
                            env: EnvironmentMaps | None = None,
                            textures=None,
                            slots_used: tuple | None = None,
                            full_height: int | None = None,
                            y_offset: int = 0) -> dict:
    """One peeled layer's G-buffer -> dict(depth, tri_id, mask, color
    [H, W, 3], alpha in [0, 1]): the material (with textures sampled as the
    reference samples a layer: trilinear, no mip jitter, no anisotropy),
    shaded by the environment and the direct lights without casters or
    screen-space effects. full_height and y_offset place a screen band."""
    attrs, lmask = _attrs_from_gbuf(scene_t, consts, depth, tri_id, gbuf,
                                    width, height, full_height, y_offset)
    mat = material_pass(unit3(attrs["wnrm"]), attrs["mrow"], attrs["ids"],
                        uv=attrs["uv"], wtan=attrs["wtan"], textures=textures,
                        slots_used=slots_used)
    color = shading.shade_forward(
        world_pos=attrs["wpos"], normal=mat["normal"], albedo=mat["albedo"],
        roughness=mat["roughness"], metalness=mat["metalness"],
        emissive=mat["emissive"], ao=consts.ambient_factor * mat["local_ao"],
        camera_pos=consts.camera_pos, point_lights=consts.point_lights,
        spot_lights=consts.spot_lights, spot_extra=consts.spot_extra,
        directional=consts.directional,
        env_illumination=environment_term(consts, env, attrs["wpos"],
                                          mat["normal"], mat))
    return {"depth": depth, "tri_id": tri_id, "mask": lmask, "color": color,
            "alpha": torch.clamp(mat["alpha"], 0.0, 1.0)}


def transparent_layers(scene_t: DeviceScene, consts: FrameConstants,
                       opaque_depth: torch.Tensor, width: int, height: int,
                       num_layers: int = 2,
                       env: EnvironmentMaps | None = None, textures=None,
                       slots_used: tuple | None = None,
                       full_height: int | None = None,
                       y_offset: int = 0) -> list[dict]:
    """Depth-peel num_layers layers of the transparent scene in front of
    the opaque depth and shade each (shade_transparent_layer): layer k's
    fragments are the nearest with depth(k - 1) < z < opaque depth (layer
    0's from -1), one bounded K1 launch each on one binning at the default
    capacity (whose overflow the frame does not report, as in the
    reference). full_height and y_offset peel a screen band of the frame:
    the frame's rows up to the band's end are set up, binned and rastered
    as the frame's, and cut to the band's (raster.rasterize_gbuf_band;
    the reference shifts the band's vertices instead, which rounds the
    planes otherwise). -> the layers, nearest first."""
    fh = height if full_height is None else full_height
    end = raster.band_end(y_offset, height, fh)
    setup, extra = geometry_setup_gbuf(scene_t, consts, width, fh)
    binned = raster.bin_triangles(raster.rows_of_setup(setup, end), width,
                                  end, extra=extra)
    zlo = torch.full_like(opaque_depth, -1.0)
    layers = []
    for _ in range(num_layers):
        d, idb, g = raster.rasterize_gbuf_band(binned, width, height, y_offset,
                                               fh, zbound=(zlo, opaque_depth))
        layers.append(shade_transparent_layer(scene_t, consts, d, idb, g,
                                              width, height, env=env,
                                              textures=textures,
                                              slots_used=slots_used,
                                              full_height=full_height,
                                              y_offset=y_offset))
        zlo = d       # the next layer starts behind this one
    return layers


def blend_layers(hdr: torch.Tensor, layers: list[dict]) -> torch.Tensor:
    """Composite peeled layers (nearest first) back to front onto hdr: the
    deepest blends onto the opaque result first, each pixel by its
    alpha where the layer has a fragment."""
    for layer in reversed(layers):
        a = torch.where(layer["mask"], layer["alpha"],
                        torch.zeros_like(layer["alpha"]))[..., None]
        hdr = hdr * (1.0 - a) + layer["color"] * a
    return hdr


def transparent_pass(scene_t: DeviceScene, consts: FrameConstants,
                     hdr: torch.Tensor, opaque_depth: torch.Tensor,
                     width: int, height: int, env=None, textures=None,
                     num_layers: int = 2, slots_used: tuple | None = None,
                     full_height: int | None = None,
                     y_offset: int = 0) -> torch.Tensor:
    """Blended transparents (the reference's Model.h:45-65 transparent mesh
    split, rendered after the opaques): transparent_layers, composited
    back to front onto hdr (blend_layers). Order-independent up to
    num_layers-deep overlap; coplanar transparent fragments drop (each
    layer is a strict peel). A screen band (parallel/multichip.py) passes
    full_height and y_offset (transparent_layers)."""
    return blend_layers(hdr, transparent_layers(scene_t, consts, opaque_depth,
                                                width, height, num_layers,
                                                env=env, textures=textures,
                                                slots_used=slots_used,
                                                full_height=full_height,
                                                y_offset=y_offset))


# the material outputs the alpha-mask peel takes from the surface behind
MATERIAL_PEEL_KEYS = ("albedo", "emissive", "roughness", "metalness",
                      "local_ao", "object_id", "item_id", "alpha")


def _alpha_mask_peel(scene: DeviceScene, consts: FrameConstants,
                     binned: raster.BinnedTriangles, width: int, height: int,
                     depth, tri_id, mask, wpos, n, mat: dict, coverage,
                     textures=None, aniso_taps: int = 0,
                     slots_used: tuple | None = None,
                     mip_jit: torch.Tensor | None = None,
                     full_height: int | None = None, y_offset: int = 0):
    """Alpha-mask discard (ForwardLighting.hlsl:237-240): peel past the
    fragments whose alpha fails the cutout test (< 0.01) and re-resolve
    those pixels on the next surface behind them (one bounded K1 launch,
    window (depth, 2) where the fragment failed, empty elsewhere; a second
    failing fragment leaves background); the next surface's material is
    sampled as the frame's (textures, aniso_taps, slots_used, the mip
    jitter; no telemetry). -> the merged (depth, tri_id, mask, wpos, n,
    mat, coverage); a failed pixel's per-sample coverage becomes whether
    the next surface passed. full_height and y_offset place a screen
    band's rows; binned is then the frame's binning of its rows up to the
    band's end (raster.rasterize_gbuf_band)."""
    fail = mask & (mat["alpha"] < 0.01)
    two = torch.full_like(depth, 2.0)
    zlo = torch.where(fail, depth, two)     # an empty window where passing
    d2, id2, g2 = raster.rasterize_gbuf_band(
        binned, width, height, y_offset,
        height if full_height is None else full_height, zbound=(zlo, two))
    attrs2, mask2 = _attrs_from_gbuf(scene, consts, d2, id2, g2, width, height,
                                     full_height, y_offset)
    mat2 = material_pass(unit3(attrs2["wnrm"]), attrs2["mrow"], attrs2["ids"],
                         uv=attrs2["uv"], wtan=attrs2["wtan"], textures=textures,
                         aniso_taps=aniso_taps, slots_used=slots_used,
                         mip_jitter=mip_jit)
    ok2 = mask2 & (mat2["alpha"] >= 0.01)

    def mrg(x1, x2):
        f = fail if x1.ndim == fail.ndim else fail[..., None]
        return torch.where(f, x2, x1)

    depth = mrg(depth, torch.where(ok2, d2, torch.ones_like(d2)))
    tri_id = mrg(tri_id, torch.where(ok2, id2, torch.full_like(id2, raster.BG_ID)))
    mask = torch.where(fail, ok2, mask)
    wpos = mrg(wpos, attrs2["wpos"])
    n = mrg(n, mat2["normal"])
    mat = {k: mrg(v, mat2[k]) if k in MATERIAL_PEEL_KEYS else v
           for k, v in mat.items()}
    if coverage is not None:
        f = fail[None] if coverage.ndim == 3 else fail
        coverage = torch.where(f, ok2.to(coverage.dtype), coverage)
    return depth, tri_id, mask, wpos, n, mat, coverage


def ssao_pass(consts: FrameConstants, depth: torch.Tensor, n: torch.Tensor,
              quality: str = "medium", d_h: torch.Tensor | None = None,
              telemetry: dict | None = None,
              tan_half_fov: float | None = None) -> torch.Tensor:
    """render_forward's SSAO: CACAO-style AO [H, W] from the depth and the
    unit normals at half resolution ("lowest" and "low" generate at quarter
    resolution with their tap budget), upsampled by depth (CACAO's
    edge-aware Apply). d_h: pool2(depth) when the caller has it."""
    height, width = depth.shape
    info = {"near": consts.proj_params[0], "far": consts.proj_params[1],
            "fov_y": consts.proj_params[2], "view": consts.view_matrix}
    d_h = pool2(depth) if d_h is None else d_h
    n_h = pool2(n)
    if quality in ("lowest", "low"):
        d_q = pool2(d_h)
        ao = ssao_ops.ssao(d_q, pool2(n_h), info,
                           num_taps=ssao_ops.PRESETS[quality][0],
                           tan_half_fov=tan_half_fov)
        ao = ssao_ops.upsample_bilateral(ao, d_q, d_h)
    else:
        taps, extra, deint = ssao_ops.PRESETS.get(quality,
                                                  ssao_ops.PRESETS["medium"])
        ao = ssao_ops.ssao(d_h, n_h, info, num_taps=taps, adaptive_taps=extra,
                           deinterleave=deint, telemetry=telemetry,
                           tan_half_fov=tan_half_fov)
    return ssao_ops.upsample_bilateral(ao, d_h, depth)[:height, :width]


def ssr_pass(consts: FrameConstants, hdr: torch.Tensor, depth: torch.Tensor,
             n: torch.Tensor, mat: dict, wpos: torch.Tensor, mask: torch.Tensor,
             motion: torch.Tensor | None, history: torch.Tensor | None,
             d_h: torch.Tensor | None = None, telemetry: dict | None = None,
             tan_half_fov: float | None = None):
    """render_forward's SSR (SSSR + DNSR + ApplyReflections): the hi-Z
    march on the quarter-resolution frame, the denoiser and its history at
    half resolution (reprojected by motion where given), the composite at
    full resolution on the covered pixels -> (hdr, new history [H/2, W/2,
    7])."""
    height, width = depth.shape
    d_h = pool2(depth) if d_h is None else d_h
    refl_q, conf_q = ssr_ops.trace_reflections(
        pool2(pool2(hdr)), pool2(d_h), pool2(pool2(n)), consts.view_matrix,
        consts.proj_params, telemetry=telemetry, tan_half_fov=tan_half_fov)
    hh, hw = d_h.shape
    conf_h = up2_fit(conf_q, hh, hw)
    refl_dn_h, new_history = ssr_ops.denoise_reflections(
        up2_fit(refl_q, hh, hw), conf_h, pool2(mat["roughness"]),
        history=history, motion=None if motion is None else pool2(motion),
        depth=d_h)
    hdr_refl = ssr_ops.apply_reflections(
        hdr, up2_fit(refl_dn_h, height, width), up2_fit(conf_h, height, width),
        mat["roughness"], mat["metalness"], mat["albedo"], n,
        unit3(consts.camera_pos - wpos))
    return torch.where(mask[..., None], hdr_refl, hdr), new_history


def render_forward(scene: DeviceScene, consts: FrameConstants,
                   width: int, height: int,
                   output_display_curve: int = cs.DISPLAY_CURVE_SRGB,
                   apply_gamma: bool = True,
                   enable_shadows: bool = True,
                   shadow_dims: tuple[int, int, int] = SHADOW_DIMS,
                   env=None,
                   enable_ssao: bool = False,
                   enable_motion_vectors: bool = False,
                   textures=None,
                   msaa: bool = False,
                   enable_ssr: bool = False,
                   ssr_history: torch.Tensor | None = None,
                   out_width: int | None = None,
                   out_height: int | None = None,
                   cas_sharpness: float | None = None,
                   shadow_filter: str = "esm",
                   shadow_maps: dict | None = None,
                   enable_alpha_mask: bool = False,
                   scene_transparent: DeviceScene | None = None,
                   aniso_taps: int = 0,
                   slots_used: tuple | None = None,
                   ssao_quality: str = "medium",
                   msaa_edge_resolve: bool | str = True,
                   dynamic_item_ids: tuple | None = None,
                   pair_capacity: int | None = None) -> dict:
    """Forward frame: geometry -> SSAO -> motion vectors -> shadows ->
    shade (lights and, with env, the environment term) -> MSAA edge
    resolve -> background (the skydome with env, else the clear color) ->
    SSR -> transparents -> tonemap. Returns ldr [H, W, 3], hdr, depth,
    tri_id, object_id, overflow [3], pair_demand and saturation, as the
    reference does, and ao [H, W], motion [H, W, 2] and ssr_history [H/2,
    W/2, 7] where their passes ran. With enable_shadows, caster lights are
    shadowed by maps from `shadow_maps` (render_shadow_maps, cached) or
    rendered in the frame; without, they drop out, as in the reference.
    With msaa the G-buffer comes from the MSAA raster and the pixel blends
    with the background by its covered-sample share; msaa_edge_resolve
    True or "neighbor" (the default) also splits an edge pixel's covered
    samples with the secondary surface colored from a neighbor pixel,
    "shade" shades the secondary surface itself, False keeps the winner
    alone. enable_ssao multiplies the ambient term by CACAO-style AO at
    half resolution (ssao_quality: "lowest" and "low" generate at quarter
    resolution), upsampled by depth. enable_motion_vectors adds the NDC
    motion against prev_world / prev_view_proj (dynamic_item_ids: see
    motion_vectors). enable_ssr composites hi-Z reflections traced at
    quarter resolution and denoised at half resolution against
    ssr_history (the previous frame's out["ssr_history"], reprojected by
    the motion vectors when they are on; None starts afresh).
    scene_transparent (the transparent part of split_transparent) is
    depth-peeled in two layers in front of the opaque depth and blended
    over the frame before tonemap (transparent_pass). textures (a
    PackedTextures, or the f32 mip list) are sampled by every material
    pass: the frame's with the R2 mip jitter (stochastic trilinear) and,
    with aniso_taps > 1, the adaptive anisotropic walk on the diffuse slot
    (its saturation as tex_aniso and tex_aniso_demand); slots_used
    (slots_used_of of the scene's materials) skips the slots no material
    references. enable_alpha_mask discards fragments whose sampled alpha
    fails the cutout test (one bounded K1 peel); without textures there is
    no sampled alpha, and the frame is the one without it, as in the
    reference. output_display_curve (colorspace.DISPLAY_CURVE_*) picks the
    tonemapper's curve, apply_gamma its sRGB encode. The post chain's tail
    runs on ldr: cas_sharpness (0..1, None = off) sharpens it with CAS;
    out_width/out_height, when they differ from width/height, upscale it
    with FSR1 (EASU + RCAS) to [out_height, out_width], except on the
    ST.2084 curve; every other output stays at width x height."""
    # the reference's gate: the peel needs a sampled alpha, so it runs only
    # with textures
    alpha_test = enable_alpha_mask and textures is not None
    tel: dict = {}
    dev = consts.view_proj.device
    with trace.span("vq.pass.geometry", dev):
        geo = geometry_pass(scene, consts, width, height, msaa=msaa,
                            return_binned=alpha_test,
                            pair_capacity=pair_capacity, tel=tel)
        depth, tri_id, attrs, mask, coverage = geo[:5]
    with trace.span("vq.pass.material", dev):
        # stochastic trilinear: a per-pixel R2-dithered mip pick
        mip_jit = (tex_ops.mip_jitter(height, width, device=depth.device)
                   if textures is not None else None)
        mat = material_pass(unit3(attrs["wnrm"]), attrs["mrow"], attrs["ids"],
                            uv=attrs["uv"], wtan=attrs["wtan"],
                            textures=textures, aniso_taps=aniso_taps,
                            slots_used=slots_used, mip_jitter=mip_jit,
                            telemetry=tel)
        n = mat["normal"]
    if alpha_test:
        with trace.span("vq.pass.alpha_peel", dev):
            depth, tri_id, mask, attrs["wpos"], n, mat, coverage = \
                _alpha_mask_peel(scene, consts, geo[5], width, height, depth,
                                 tri_id, mask, attrs["wpos"], n, mat,
                                 coverage, textures=textures,
                                 aniso_taps=aniso_taps, slots_used=slots_used,
                                 mip_jit=mip_jit)
    th = d_h = ao_map = None
    if enable_ssao or enable_ssr:
        with trace.span("vq.pass.ssao", dev):
            th = ssao_ops.tan_half(consts.proj_params[2])
            d_h = pool2(depth)
            if enable_ssao:
                ao_map = ssao_pass(consts, depth, n, ssao_quality, d_h=d_h,
                                   telemetry=tel, tan_half_fov=th)
    motion = None
    if enable_motion_vectors:
        with trace.span("vq.pass.motion", dev):
            # post-peel item ids: a pixel re-resolved past a discarded
            # cutout carries the revealed surface's item
            motion = motion_vectors(scene, consts, attrs["wpos"], tri_id,
                                    mask,
                                    item_id=mat["item_id"].to(torch.int32),
                                    dynamic_item_ids=dynamic_item_ids)
    spot_vis = point_vis = dir_vis = None
    if enable_shadows:
        with trace.span("vq.pass.shadows", dev):
            spot_vis, point_vis, dir_vis = shadow_pass(
                scene, consts, attrs["wpos"], n, shadow_dims, shadow_filter,
                shadow_maps=shadow_maps)
    with trace.span("vq.pass.environment", dev):
        env_illum = environment_term(consts, env, attrs["wpos"], n, mat)
    with trace.span("vq.pass.shade", dev):
        ao = consts.ambient_factor * mat["local_ao"]
        if ao_map is not None:
            ao = ao * ao_map          # SSAO multiplies the ambient term
        hdr = shading.shade_forward(
            world_pos=attrs["wpos"], normal=n, albedo=mat["albedo"],
            roughness=mat["roughness"], metalness=mat["metalness"],
            emissive=mat["emissive"], ao=ao, camera_pos=consts.camera_pos,
            point_lights=consts.point_lights, spot_lights=consts.spot_lights,
            spot_extra=consts.spot_extra, directional=consts.directional,
            point_casters=consts.point_casters if enable_shadows else None,
            point_shadow=point_vis,
            spot_casters=consts.spot_casters if enable_shadows else None,
            spot_caster_extra=(consts.spot_caster_extra if enable_shadows
                               else None),
            spot_shadow=spot_vis, dir_shadow=dir_vis,
            env_illumination=env_illum)
    secondary = None
    if coverage is not None and msaa_edge_resolve:
        # at edges between two surfaces the resolve splits the covered
        # samples with the secondary surface
        with trace.span("vq.pass.edge_resolve", dev):
            if msaa_edge_resolve == "shade":
                secondary = _msaa_edge_secondary(
                    scene, consts, attrs, tri_id, depth, mask, coverage,
                    spot_vis, point_vis, dir_vis, width, height,
                    enable_shadows, telemetry=tel, env=env, ao_map=ao_map,
                    textures=textures, aniso_taps=aniso_taps,
                    slots_used=slots_used, mip_jit=mip_jit)
            else:
                secondary = _msaa_edge_neighbor(
                    attrs, tri_id, depth, mask, coverage, hdr, width, height,
                    telemetry=tel)
    with trace.span("vq.pass.sky", dev):
        if env is not None:
            background = sky_background(consts, env, width, height)
        else:
            background = consts.clear_color.expand(hdr.shape)
        if coverage is not None:
            # covered-sample share: silhouettes blend with the background
            covm = coverage.mean(dim=0)
            if secondary is not None:
                w_sec, sec_rgb = secondary
                w_pri = torch.clamp(covm - w_sec, min=0.0)
                hdr = (hdr * w_pri[..., None] + sec_rgb
                       + background * (1.0 - covm)[..., None])
            else:
                hdr = (hdr * covm[..., None]
                       + background * (1.0 - covm[..., None]))
            hdr = torch.where((mask | (covm > 0))[..., None], hdr, background)
        else:
            hdr = torch.where(mask[..., None], hdr, background)
    new_ssr_history = None
    if enable_ssr:
        with trace.span("vq.pass.ssr", dev):
            hdr, new_ssr_history = ssr_pass(consts, hdr, depth, n, mat,
                                            attrs["wpos"], mask, motion,
                                            ssr_history, d_h=d_h,
                                            telemetry=tel, tan_half_fov=th)
    if scene_transparent is not None and scene_transparent.num_tris_live > 0:
        with trace.span("vq.pass.transparent", dev):
            hdr = transparent_pass(scene_transparent, consts, hdr, depth,
                                   width, height, env=env, textures=textures,
                                   slots_used=slots_used)
    with trace.span("vq.pass.tonemap", dev):
        ldr = pp.tonemap(hdr, output_display_curve, apply_gamma=apply_gamma)
    with trace.span("vq.pass.tail", dev):
        # the post chain's tail (SceneRendering.cpp:2507-2788): CAS, then
        # the FSR1 upscale when rendering below the display size (the HDR
        # path skips FSR, as in the reference)
        if cas_sharpness is not None:
            ldr = ffx.cas(ldr, cas_sharpness)
        if (out_width is not None and out_height is not None
                and (out_width != width or out_height != height)
                and output_display_curve != cs.DISPLAY_CURVE_ST2084):
            ldr = ffx.fsr1(ldr, out_height, out_width)
        object_id = torch.where(mask, mat["object_id"],
                                torch.full_like(mat["object_id"], -1))
    out = {"ldr": ldr, "hdr": hdr, "depth": depth, "tri_id": tri_id,
           "object_id": object_id,
           "overflow": attrs["overflow"], "pair_demand": attrs["pair_demand"],
           "saturation": tel}
    if ao_map is not None:
        out["ao"] = ao_map
    if motion is not None:
        out["motion"] = motion
    if new_ssr_history is not None:
        out["ssr_history"] = new_ssr_history
    return out
