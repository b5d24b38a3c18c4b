"""Multi-GPU rendering — counterpart of ``vqengine_tpu/parallel/multichip.py``
on ``torch.distributed``.

Process model: one process (rank) per (dp, sp) position, world size dp x
sp; rank r renders band r % sp of the frames of dp index r // sp.
- axis "sp" (screen bands): the framebuffer splits into horizontal bands
  of height / sp rows; geometry is replicated, and each rank shades only
  its band (its rasters cover the frame's rows up to the band's end:
  below).
- axis "dp": independent frames (views) split across the dp rows; a rank
  renders its frames one after the other, as the reference's vmap does.
Shadow maps, the environment, the textures and the transparent scene are
replicated: each rank builds them from the same inputs (nothing is
broadcast).

Every collective of a frame is a tiled all_gather over the rank's sp
group (the ranks of one dp row, in band order, so that a gather is the
frame's row order):
- the halo exchange (_halo_exchange): each rank contributes its first
  and last `pad` rows and keeps its previous neighbour's last rows and its
  next neighbour's first rows; the frame's borders edge-clamp. It serves
  the SSAO slabs, the texture LOD's uv and material rows, the sky's
  quarter rows, and the MSAA edge resolve's tri_id, depth, object id, mask
  and hdr;
- the SSR quarter-resolution trace inputs, and the SSR history;
- the MSAA edge resolve's block counts per threshold rung (int64).
What crosses: float32 slabs, int32 ids, int64 counts, and the masks as
uint8 (cast back to bool).

Two departures from the reference's band renderer, so that the bands
render the single-device frame (chip_smoke.py's path (l) holds them to it
on Sponza at 1080p, opaque and translucent; tools/band_shift_parity.py
counts the winners the reference's band setup changes):
- every raster of a band (the G-buffer's, the alpha-mask peel's, the
  transparent layers') runs on the frame's rows up to the band's end,
  with the frame's triangle setup, and keeps the band's rows, which are
  then the frame's bit for bit (raster.rasterize_gbuf_band); the MSAA
  edge resolve evaluates the frame's records at frame rows. The reference
  shifts each vertex by y_offset * w (raster.setup_triangles' y_offset,
  ported as it is), which rounds the planes otherwise, so that far depths
  move by whole scene units and coplanar surfaces change winner. So a
  band's binning and raster cover the frame's rows above it too: the
  last band's cover the whole frame, and these stages do not shrink with
  sp (chip_smoke.py times them band by band);
- the MSAA edge resolve takes the whole frame's threshold rung and
  capacity (_frame_edge_threshold), where the reference's bands each pick
  their own rung for their own share of the capacity.

Backends, chosen by the caller:
- "nccl": one rank per card (cuda:rank), device tensors cross;
- "gloo": the host transport. On the CPU it gathers the ranks' CPU
  tensors; with several ranks sharing one card each exchange copies its
  slab to the host and back, explicitly. NCCL refuses two ranks on one
  device, and this design does not rely on gloo's CUDA support.
gather_frames (checks, outside the frame) is one all_gather over the
world.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops import colorspace as cs
from ..ops import postprocess as pp
from ..ops import ibl, raster, shading, sparse
from ..ops import msaa as msaa_ops
from ..ops import ssao as ssao_ops
from ..ops import ssr as ssr_ops
from ..ops import texture as tex_ops
from ..render import graph


@dataclass
class Mesh:
    """A rank's place in the dp x sp mesh: its band and dp index, its sp
    group (the ranks of its dp row, in band order), its device and the
    backend."""
    dp: int
    sp: int
    rank: int
    group: object
    device: torch.device
    backend: str

    @property
    def band(self) -> int:
        return self.rank % self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self.backend == "gloo" and x.is_cuda:
            x = x.cpu()
        return x.contiguous()

    def _from_wire(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return x.to(device=like.device, dtype=like.dtype)

    def all_gather(self, x: torch.Tensor, world: bool = False) -> torch.Tensor:
        """Tiled all_gather of x [R, ...] over the sp group (or, with world,
        over every rank) -> [n * R, ...], in rank order."""
        group = None if world else self.group       # None: the world group
        n = self.dp * self.sp if world else self.sp
        w = self._to_wire(x)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        return self._from_wire(torch.cat(parts, dim=0), x)


def make_mesh(dp: int, sp: int, backend: str, device) -> Mesh:
    """This rank's Mesh, inside an initialized process group of dp x sp
    ranks. Every rank creates every dp row's group, in the same order.
    device: "cpu", "cuda" (nccl: cuda:rank, one rank per card; gloo: the
    one card every rank shares) or a torch.device."""
    world = dist.get_world_size()
    if dp * sp != world:
        raise ValueError(f"mesh {dp}x{sp} != {world} ranks")
    rank = dist.get_rank()
    device = torch.device(device)
    if backend == "nccl":
        if dp * sp > torch.cuda.device_count():
            raise RuntimeError(f"nccl: {dp * sp} ranks need one card each, "
                               f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", rank)
    elif device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    groups = [dist.new_group(list(range(i * sp, (i + 1) * sp)))
              for i in range(dp)]
    return Mesh(dp=dp, sp=sp, rank=rank, group=groups[rank // sp],
                device=device, backend=backend)


def _halo_exchange(x: torch.Tensor, pad: int, mesh: Mesh) -> torch.Tensor:
    """Pad a band slab [H, W, ...] with `pad` rows of the neighbouring bands
    (one all_gather of every band's edge rows); the frame's borders
    replicate the edge row, the clamp of the single-device taps. ->
    [H + 2 pad, W, ...]."""
    if pad <= 0:
        return x
    if pad > x.shape[0]:
        raise ValueError(f"halo of {pad} rows on a {x.shape[0]}-row band")
    edge_top = x[:1].expand((pad,) + tuple(x.shape[1:]))
    edge_bot = x[-1:].expand((pad,) + tuple(x.shape[1:]))
    n, idx = mesh.sp, mesh.band
    if n == 1:
        return torch.cat([edge_top, x, edge_bot], dim=0)
    edges = mesh.all_gather(torch.cat([x[:pad], x[-pad:]], dim=0))
    edges = edges.reshape((n, 2 * pad) + tuple(x.shape[1:]))
    top = edge_top if idx == 0 else edges[idx - 1, pad:]
    bot = edge_bot if idx == n - 1 else edges[idx + 1, :pad]
    return torch.cat([top, x, bot], dim=0)


def _frame_edge_threshold(score: torch.Tensor, mesh: Mesh,
                          cap: int) -> torch.Tensor:
    """The MSAA edge threshold the whole frame would pick: each band's
    8-pixel block counts above every rung of msaa.EDGE_THRS, summed over
    the bands (one all_gather), and the lowest rung whose count fits the
    frame's capacity (sparse.adaptive_threshold's rule; the top rung if
    none does). A band's rows are whole blocks of the frame's when the
    width is a multiple of 8."""
    thrs = msaa_ops.EDGE_THRS
    counts = torch.stack([sparse.block_count(score > t, 8) for t in thrs])
    total = mesh.all_gather(counts[None].to(torch.int64)).sum(dim=0).tolist()
    thr = thrs[-1]
    for t, c in zip(reversed(thrs[:-1]), reversed(total[:-1])):
        if c <= cap // 8:
            thr = t
    return torch.full((), float(thr), dtype=torch.float32, device=score.device)


def _up2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """2x nearest upsample cut to [h, w] (the reference's repeat + slice)."""
    return x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:h, :w]


def _render_band(scene: graph.DeviceScene, consts: graph.FrameConstants,
                 width: int, height: int, band_height: int, mesh: Mesh,
                 env: graph.EnvironmentMaps | None = None,
                 shadow_maps: dict | None = None,
                 textures=None,
                 slots_used: tuple | None = None,
                 msaa: bool = False,
                 enable_ssao: bool = False,
                 enable_ssr: bool = False,
                 ssao_halo: int = 16,
                 aniso_taps: int = 0,
                 msaa_edge_resolve: bool | str = True,
                 enable_motion_vectors: bool = False,
                 ssr_history: torch.Tensor | None = None,
                 scene_transparent: graph.DeviceScene | None = None,
                 enable_alpha_mask: bool = False,
                 ssao_quality: str = "medium",
                 dynamic_item_ids: tuple | None = None) -> dict:
    """Render this rank's band of one frame, the reference's _render_band
    stage by stage (see the module docstring for the collectives that
    stitch the bands). ssr_history: the band's half-resolution history
    slab [bh/2, W/2, 7], gathered to the whole frame for the reprojection.
    -> dict(ldr [bh, W, 3], depth [bh, W], ssr_history (the band's new
    history, with SSR), overflow [3] (the band's binning at the default
    capacity), ao [bh, W] and motion [bh, W, 2] (where their passes
    ran, else None))."""
    y0 = mesh.band * band_height
    # the reference's band front end has no geomorph (corner_morph_mid)
    geo_scene = (scene if scene.corner_morph_mid is None
                 else dataclasses.replace(scene, corner_morph_mid=None))
    # The reference sets the band up by shifting the vertices by y_offset * w
    # (setup_triangles' y_offset), and the band's depth then rounds
    # otherwise than the frame's: far surfaces (Sponza's, at z ~ 0.999)
    # move by whole scene units and coplanar ones change winner. Here the
    # band's rasters run on the frame's rows [0, end) with the frame's
    # setup, and its rows come out bit for bit as the frame's.
    setup, extra = graph.geometry_setup_gbuf(geo_scene, consts, width, height)
    end = raster.band_end(y0, band_height, height)
    binned = raster.bin_triangles(raster.rows_of_setup(setup, end), width,
                                  end, extra=extra)
    coverage = records = None
    if msaa:
        depth, tri_id, gbuf, coverage = raster.rasterize_gbuf_band(
            binned, width, band_height, y0, height, msaa=True)
        if msaa_edge_resolve:
            records = raster.pack_records(setup, extra)
    else:
        depth, tri_id, gbuf = raster.rasterize_gbuf_band(
            binned, width, band_height, y0, height)
    attrs, mask = graph._attrs_from_gbuf(scene, consts, depth, tri_id, gbuf,
                                         width, band_height,
                                         full_height=height, y_offset=y0)
    wpos, mrow, ids, uv = attrs["wpos"], attrs["mrow"], attrs["ids"], attrs["uv"]
    wn = graph.unit3(attrs["wnrm"])

    lod = mip_jit = None
    if textures is not None:
        # the uv gradients wrap at the band's edges: the texture LOD runs on
        # a 1-row halo of uv and the material's uv scale rows
        uv_p = _halo_exchange(uv, 1, mesh) * 1.0
        mrow_p = _halo_exchange(mrow[..., 8:12].contiguous(), 1, mesh)
        uv_scaled = uv_p * mrow_p[..., 0:2] + mrow_p[..., 2:4]
        lod = tex_ops.uv_mip_level(
            uv_scaled, tex_ops.tex_base_size(textures),
            tex_ops.tex_num_levels(textures) - 1)[1:-1]
        # the R2 mip jitter at the frame's rows
        mip_jit = tex_ops.mip_jitter(band_height, width, y_offset=y0,
                                     device=depth.device)
    mat = graph.material_pass(wn, mrow, ids, uv=uv, wtan=attrs["wtan"],
                              textures=textures, aniso_taps=aniso_taps,
                              slots_used=slots_used, lod=lod,
                              mip_jitter=mip_jit)
    n = mat["normal"]

    if enable_alpha_mask and textures is not None:
        depth, tri_id, mask, wpos, n, mat, coverage = graph._alpha_mask_peel(
            scene, consts, binned, width, band_height, depth, tri_id, mask,
            wpos, n, mat, coverage, textures=textures, aniso_taps=aniso_taps,
            slots_used=slots_used, mip_jit=mip_jit, full_height=height,
            y_offset=y0)

    th = (ssao_ops.tan_half(consts.proj_params[2])
          if enable_ssao or enable_ssr else None)
    ao_map = None
    ao = consts.ambient_factor * mat["local_ao"]
    if enable_ssao:
        # half-resolution slabs with `ssao_halo` neighbour rows, so that
        # taps near a seam see the next band's geometry
        dh = graph.pool2(depth)
        nh = graph.pool2(n)
        pad = ssao_halo
        dh_p = _halo_exchange(dh, pad, mesh)
        nh_p = _halo_exchange(nh, pad, mesh)
        info = {"near": consts.proj_params[0], "far": consts.proj_params[1],
                "fov_y": consts.proj_params[2], "view": consts.view_matrix}
        if ssao_quality in ("lowest", "low"):
            qpad = pad // 2
            ao_q = ssao_ops.ssao(graph.pool2(dh_p), graph.pool2(nh_p), info,
                                 num_taps=ssao_ops.PRESETS[ssao_quality][0],
                                 tan_half_fov=th, y_offset=y0 // 4 - qpad,
                                 full_height=height // 4)
            ao_q = ao_q[qpad:qpad + dh.shape[0] // 2]
            ao_half = ssao_ops.upsample_bilateral(ao_q, graph.pool2(dh), dh)
        else:
            taps, extra_t, deint = ssao_ops.PRESETS.get(
                ssao_quality, ssao_ops.PRESETS["medium"])
            ao_half = ssao_ops.ssao(dh_p, nh_p, info, num_taps=taps,
                                    adaptive_taps=extra_t, deinterleave=deint,
                                    tan_half_fov=th, y_offset=y0 // 2 - pad,
                                    full_height=height // 2)
            ao_half = ao_half[pad:pad + dh.shape[0]]
        ao_map = ssao_ops.upsample_bilateral(ao_half, dh, depth)[
            :band_height, :width]
        ao = ao * ao_map

    spot_vis = point_vis = dir_vis = None
    enable_shadows = shadow_maps is not None
    if enable_shadows:
        spot_vis, point_vis, dir_vis = graph.shadow_pass(
            scene, consts, wpos, n, shadow_maps=shadow_maps)

    hdr = shading.shade_forward(
        world_pos=wpos, normal=n, albedo=mat["albedo"],
        roughness=mat["roughness"], metalness=mat["metalness"],
        emissive=mat["emissive"], ao=ao, camera_pos=consts.camera_pos,
        point_lights=consts.point_lights, spot_lights=consts.spot_lights,
        spot_extra=consts.spot_extra, directional=consts.directional,
        point_casters=consts.point_casters if enable_shadows else None,
        point_shadow=point_vis,
        spot_casters=consts.spot_casters if enable_shadows else None,
        spot_caster_extra=consts.spot_caster_extra if enable_shadows else None,
        spot_shadow=spot_vis, dir_shadow=dir_vis,
        env_illumination=graph.environment_term(consts, env, wpos, n, mat))

    if env is not None:
        # the quarter-resolution sky; the seams' y-blend takes its +-1
        # quarter rows from the neighbouring bands
        dirs_q = graph._sky_quarter_dirs(consts, width, height, y_offset=y0,
                                         out_rows=band_height)
        sky_q = ibl.sky_radiance(dirs_q, env.equirect, consts.hdri_yaw,
                                 bilinear=True)
        sky_qp = _halo_exchange(sky_q, 1, mesh)
        up_y = graph._axis_up4(sky_qp[1:-1], 0, band_height,
                               prev=sky_qp[:-2], nxt=sky_qp[2:])
        background = graph._axis_up4(up_y, 1, width)
    else:
        background = consts.clear_color.expand(hdr.shape)
    if coverage is not None:
        covm = coverage.mean(dim=0)
        if msaa_edge_resolve and records is not None:
            # the edge resolve with a 1-row halo: edge detection and the
            # neighbour candidates at a seam see the next band
            object_id = ids[..., 0].to(torch.int32)
            halo = (_halo_exchange(tri_id, 1, mesh),
                    _halo_exchange(depth, 1, mesh),
                    _halo_exchange(object_id, 1, mesh),
                    _halo_exchange(mask, 1, mesh))
            attrs_e = {"ids": ids, "records": records, "wpos": wpos}
            # the whole frame's edge set: its threshold rung and capacity
            # (the reference's bands each pick their own, which resolves
            # other edges than the frame wherever the frame's demand
            # exceeds its capacity, as Sponza's does at 1080p)
            edges = dict(cap=graph.msaa_edge_cap(width, height),
                         choose=lambda score: _frame_edge_threshold(
                             score, mesh, graph.msaa_edge_cap(width, height)))
            if msaa_edge_resolve == "shade":
                w_sec, sec_rgb = graph._msaa_edge_secondary(
                    scene, consts, attrs_e, tri_id, depth, mask, coverage,
                    spot_vis, point_vis, dir_vis, width, band_height,
                    enable_shadows, env=env, ao_map=ao_map,
                    textures=textures, aniso_taps=aniso_taps,
                    slots_used=slots_used, mip_jit=mip_jit, halo=halo,
                    full_height=height, y_offset=y0, **edges)
            else:
                # the secondary colour can be the next band's seam row
                w_sec, sec_rgb = graph._msaa_edge_neighbor(
                    attrs_e, tri_id, depth, mask, coverage, hdr, width,
                    band_height, halo=halo,
                    hdr_halo=_halo_exchange(hdr, 1, mesh), y_offset=y0,
                    **edges)
            w_pri = torch.clamp(covm - w_sec, min=0.0)
            hdr = (hdr * w_pri[..., None] + sec_rgb
                   + background * (1.0 - covm)[..., None])
        else:
            hdr = hdr * covm[..., None] + background * (1.0 - covm[..., None])
        hdr = torch.where((mask | (covm > 0))[..., None], hdr, background)
    else:
        hdr = torch.where(mask[..., None], hdr, background)

    motion = None
    if enable_motion_vectors:
        motion = graph.motion_vectors(scene, consts, wpos, tri_id, mask,
                                      item_id=mat["item_id"].to(torch.int32),
                                      dynamic_item_ids=dynamic_item_ids)

    new_hist = None
    if enable_ssr:
        # gather the quarter-resolution trace inputs, march the whole
        # frame's rays, keep this band's rows
        d_h = graph.pool2(depth)
        hdr_qf = mesh.all_gather(graph.pool2(graph.pool2(hdr)))
        d_qf = mesh.all_gather(graph.pool2(d_h))
        n_qf = mesh.all_gather(graph.pool2(graph.pool2(n)))
        refl_f, conf_f = ssr_ops.trace_reflections(
            hdr_qf, d_qf, n_qf, consts.view_matrix, consts.proj_params,
            tan_half_fov=th)
        qbh = d_qf.shape[0] // mesh.sp
        refl_q = refl_f.narrow(0, mesh.band * qbh, qbh)
        conf_q = conf_f.narrow(0, mesh.band * qbh, qbh)
        hh, hw = d_h.shape
        conf_h = _up2(conf_q, hh, hw)
        hist_full = (mesh.all_gather(ssr_history)
                     if ssr_history is not None else None)
        refl_dn_h, new_hist = ssr_ops.denoise_reflections(
            _up2(refl_q, hh, hw), conf_h, graph.pool2(mat["roughness"]),
            history=hist_full,
            motion=None if motion is None else graph.pool2(motion),
            depth=d_h, y_offset=y0 // 2, full_height=height // 2)
        hdr_refl = ssr_ops.apply_reflections(
            hdr, _up2(refl_dn_h, band_height, width),
            _up2(conf_h, band_height, width), mat["roughness"],
            mat["metalness"], mat["albedo"], n,
            graph.unit3(consts.camera_pos - wpos))
        hdr = torch.where(mask[..., None], hdr_refl, hdr)

    if scene_transparent is not None and scene_transparent.num_tris_live > 0:
        hdr = graph.transparent_pass(
            scene_transparent, consts, hdr, depth, width, band_height,
            env=env, textures=textures, slots_used=slots_used,
            full_height=height, y_offset=y0)

    ldr = pp.tonemap(hdr, cs.DISPLAY_CURVE_SRGB)
    return {"ldr": ldr, "depth": depth, "ssr_history": new_hist,
            "overflow": binned.overflow, "ao": ao_map, "motion": motion}


def frame_of(consts_batch: graph.FrameConstants, i: int) -> graph.FrameConstants:
    """Frame i of stacked FrameConstants."""
    return graph.FrameConstants(**{f.name: getattr(consts_batch, f.name)[i]
                                   for f in dataclasses.fields(graph.FrameConstants)})


def render_forward_sharded(mesh: Mesh, scene: graph.DeviceScene,
                           consts_batch: graph.FrameConstants,
                           width: int, height: int,
                           env: graph.EnvironmentMaps | None = None,
                           shadow_maps: dict | None = None,
                           textures=None,
                           slots_used: tuple | None = None,
                           msaa: bool = False,
                           enable_ssao: bool = False,
                           enable_ssr: bool = False,
                           ssao_halo: int = 16,
                           aniso_taps: int = 0,
                           msaa_edge_resolve: bool | str = True,
                           enable_motion_vectors: bool = False,
                           ssr_history: torch.Tensor | None = None,
                           scene_transparent: graph.DeviceScene | None = None,
                           enable_alpha_mask: bool = False,
                           ssao_quality: str = "medium",
                           dynamic_item_ids: tuple | None = None,
                           stats: dict | None = None):
    """Render this rank's share of a dp-batch of frames, each split into sp
    screen bands (called by every rank of the mesh).

    consts_batch: FrameConstants stacked over B frames (stack_frame_
    constants), B a multiple of dp; dp index d renders frames [d B/dp,
    (d+1) B/dp) one after the other. env, shadow_maps, textures and
    scene_transparent are the rank's replicated resources. ssr_history:
    this rank's band slabs [B/dp, bh/2, W/2, C] (shard_history; zeros for
    the first frame) enable the denoiser's temporal resolve.
    -> this rank's ldr [B/dp, bh, W, 3] and depth [B/dp, bh, W], and with
    ssr_history its new history [B/dp, bh/2, W/2, 7]; stats, when given,
    gets "overflow" [B/dp, 3], the band binning's overflow per frame, and
    the bands' "ao" [B/dp, bh, W] and "motion" [B/dp, bh, W, 2] where
    their passes ran."""
    dp, sp = mesh.dp, mesh.sp
    assert height % sp == 0, f"height {height} not divisible by sp={sp}"
    assert (height // sp) % 4 == 0, \
        f"band height {height // sp} must be a multiple of 4 (sky grid)"
    band_height = height // sp
    carry_hist = enable_ssr and ssr_history is not None
    n_frames = int(consts_batch.world.shape[0])
    assert n_frames % dp == 0, f"{n_frames} frames over dp={dp}"
    per = n_frames // dp
    kw = dict(env=env, shadow_maps=shadow_maps, textures=textures,
              slots_used=slots_used, msaa=msaa, enable_ssao=enable_ssao,
              enable_ssr=enable_ssr, ssao_halo=ssao_halo,
              aniso_taps=aniso_taps, msaa_edge_resolve=msaa_edge_resolve,
              enable_motion_vectors=enable_motion_vectors,
              scene_transparent=scene_transparent,
              enable_alpha_mask=enable_alpha_mask, ssao_quality=ssao_quality,
              dynamic_item_ids=dynamic_item_ids)
    outs = [_render_band(scene, frame_of(consts_batch, mesh.dp_index * per + i),
                         width, height, band_height, mesh,
                         ssr_history=ssr_history[i] if carry_hist else None,
                         **kw)
            for i in range(per)]
    if stats is not None:
        stats["overflow"] = torch.stack([o["overflow"] for o in outs])
        for k in ("ao", "motion"):
            if outs[0][k] is not None:
                stats[k] = torch.stack([o[k] for o in outs])
    ldr = torch.stack([o["ldr"] for o in outs])
    depth = torch.stack([o["depth"] for o in outs])
    if carry_hist:
        return ldr, depth, torch.stack([o["ssr_history"] for o in outs])
    return ldr, depth


def stack_frame_constants(consts_list) -> graph.FrameConstants:
    """Stack per-frame FrameConstants into one with a leading frame axis."""
    return graph.FrameConstants(**{
        f.name: torch.stack([getattr(c, f.name) for c in consts_list])
        for f in dataclasses.fields(graph.FrameConstants)})


def shard_history(history, mesh: Mesh) -> torch.Tensor:
    """The JAX package's history layout [B, H/2, W/2, C] (a tensor or a
    numpy array) -> this rank's band slabs [B/dp, bh/2, W/2, C] of its dp
    index's frames, on the rank's device."""
    history = torch.as_tensor(history)
    b, hh = int(history.shape[0]), int(history.shape[1])
    assert b % mesh.dp == 0 and hh % mesh.sp == 0, (tuple(history.shape), mesh)
    per, rows = b // mesh.dp, hh // mesh.sp
    return history[mesh.dp_index * per:(mesh.dp_index + 1) * per,
                   mesh.band * rows:(mesh.band + 1) * rows].to(mesh.device)


def gather_frames(mesh: Mesh, *bands: torch.Tensor) -> tuple:
    """Every rank's band stacks [B/dp, rows, ...] (ldr, depth, history)
    gathered into whole frames [B, sp rows, ...], on every rank, in frame
    order: one all_gather over the world each (a check, outside the
    frame)."""
    out = []
    for t in bands:
        g = mesh.all_gather(t, world=True)
        per, rows = t.shape[0], t.shape[1]
        g = g.reshape((mesh.dp, mesh.sp, per, rows) + tuple(t.shape[2:]))
        g = g.transpose(1, 2).reshape((mesh.dp * per, mesh.sp * rows)
                                      + tuple(t.shape[2:]))
        out.append(g)
    return tuple(out)
