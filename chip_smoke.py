"""Drive the PyTorch/CUDA port (vqengine_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; builds the kernels
    python3 chip_smoke.py --profile  # also stage breakdowns and a trace

Phases, each printing its own lines; any failure exits non-zero before
the final line:
  1. device: the card's name and power limit, torch/CUDA versions;
  2. build: nvcc build of vqengine_tpu_torch/csrc/*.cu (ptxas lines);
  3. K3 palette kernel vs its plain PyTorch version at the four main-path
     lookups (bitwise), both timed with CUDA events, and
     torch.index_select on the pre-padded table with pre-clamped ids as
     the library yardstick;
  4. K1 G-buffer raster kernel vs its plain version on the binned Sponza
     1920x1080 frame (tri_id/depth bitwise, gbuf within GBUF_TOL), timed;
     then its MSAA variant on the same frame (depth, tri_id and coverage
     bitwise, gbuf within GBUF_TOL), timed; Sponza's interior covers
     every sample, so the MSAA variant is also held against its plain
     version on HelloCube at 1920x1080 and 192x108 (silhouettes: partly
     covered pixels and sample-only winners, each count above 0) and on
     the crafted records of ops/raster_probes.py (thresholds decided by
     their rounding, key select, z = 1, records past the counts);
     Each K1 variant also prints its earlier time with the padded stream
     (PERF.md) beside the new one, and what its reject stream keeps by the plain
     mirror of the reject test: the streamed records that survive the
     tile test and the (record, warp footprint) pairs evaluated. Every
     raster bound counts what the inputs need: the flops per record per
     pixel over the (record, 8x4 block) pairs in which the record covers
     something (raster.covered_block_pairs), or for K2's center variant,
     whose occlusion reject skips covered but hidden pairs, over the
     distinct (tri_id, 8x4 block) pairs its output has won
     (raster.won_block_pairs), beside the padded stream's bound
     (stream_bound_ms);
  5. K1-bounded (both sample modes) vs its plain version, bitwise: (a) the
     translucent Sponza (SPONZA_TRANSLUCENT) at 1920x1080, the transparent
     pass's two peel windows of the first frame; (b) an alpha-peel window
     (zlo = depth where a seeded mask fails, else 2; zhi = 2) on the opaque
     Sponza's binning; (c) the MSAA variant on HelloCube at 1920x1080 and
     192x108 with a window through the cube; (d) the crafted records of
     ops/raster_probes.bounded_probe (fragments on zlo and zhi, empty
     windows, ties); pixel counts each check reaches; both variants timed;
     then all four K1 variants on ops/raster_probes.reject_probe (records
     on the reject test's margin, neighbour-bin records reaching through
     the edge bias, killed, near-plane and degenerate records), bitwise,
     and K2 in both sample modes on the same records cut to 16 rows and on
     ops/raster_probes.depth_reject_probe (records stacked on and around
     a footprint's depth: the occlusion reject's margin), bitwise;
  6. K2 visibility raster kernel vs its plain version on Sponza's 8 caster
     views at the full shadow budget (spot 1024^2, 6 point faces 1024^2,
     directional 2048^2): pair demand, capacity and overflow per view;
     depth and tri_id bitwise; timed; what its reject stream keeps and
     what the occlusion reject drops (the plain mirror, under the
     kernel's own carries); then its MSAA variant on the directional and
     the spot view (per-sample stacks bitwise), timed, with its reject
     stream's counts;
  7. the environment: Sponza's ProceduralSky (decoded on the host, a
     512x256 equirect) built on the card at the engine's default sizes
     (diffuse cube 64, specular mips from 128 in 6 levels, a 256^2 LUT of
     512 samples): build ms by CUDA events to a sync, cold (the LUT
     computed on the card) and warm (the LUT cached), the build's peak
     device memory, and the tables against the CPU's build of the same
     equirect (graph.environment_differences: bf16 tables within one bf16
     ulp on at most 1% of entries, SH9/LUT/fit within their normwise
     bars); then frames lit by it at 192x108 with the CPU's tables carried
     to the card, against the CPU: EnvironmentMapUnitTest without MSAA
     and with the "shade" edge resolve, and the translucent Sponza
     (engine default, transparent pass lit too), tri_id equal and ldr
     within ENTRY_TOL;
  8. HelloTriangle/HelloCube (and HelloCube with MSAA), and the Default
     scene's goldens (default_scene, default_pcf) and envmap_unit_test, each
     with its environment built at load, at 192x108 on the
     card against the goldens (the bars of
     vqengine_tpu_torch/engine/goldens.py), the entry() frame on the card
     against the same frame on the CPU, a shadowed Sponza frame (192x108,
     ESM, 64^2 maps rendered in the frame) on the card against the CPU,
     the MSAA Sponza frame (192x108, cached 64^2 ESM maps) on the card
     against the CPU in both edge-resolve modes, and the translucent Sponza
     frame (the same, with its transparent pass) on the card against the
     CPU;
  9. main paths, Sponza 1920x1080 lit by its environment (the maps built
     at load) with the skydome behind it, each with the kernel launch
     counts set to 0 just before it and read just after: (a) the shadowed path
     without MSAA: precompute_shadow_maps (ESM, full budget; timed), then
     16 frames of a yaw sweep with the cached maps; (b) 4 frames rendering
     the maps in the frame (dynamic casters); (c) 4 PCF frames with cached
     PCF maps; (d) 8 frames with shadows off (the first slice's path);
     (e) the engine's default frame: the precompute, then 16 frames with
     MSAA 4x and the neighbor edge resolve (edge saturation per frame),
     the same 16 frames without the environment (env=None: the clear
     color behind, no environment term), and 4 frames with the "shade"
     edge resolve; (f) the translucent Sponza
     on its own renderer: the precompute, 16 engine-default frames and 4
     without MSAA, each with the two-layer transparent pass (2 K1-bounded
     launches per frame), the layers' pixel counts of the first frame.
     Overflow 0 and finite output; ms/frame, peak memory, launches.
`--profile` adds stage rows (among them the environment term, the
skydome and the environment build) and traces the default frame.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

W, H = 1920, 1080
N_FRAMES = 16
N_SIDE_FRAMES = 4       # maps in the frame; PCF
N_UNSHADOWED = 8        # shadows off
PROFILE_FRAMES = 3
SMALL_W, SMALL_H = 192, 108
SMALL_DIMS = (64, 64, 64)
GBUF_TOL = 1e-6   # the kernel mirrors the plain version's rounding
ENTRY_TOL = 3e-4  # card vs CPU ldr: the multichip bar of the reference
# published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# fp32 operations per streamed record per pixel of the raster kernels: 4
# planes x (two products and two sums for the hi part, the same for lo, one
# add) = 36; K1-MSAA adds 12 threshold compares, 3 more for the depth key's
# sample-1 thresholds and the z + 1 (52), K2-msaa4 16 offset adds (52)
RASTER_FLOPS = 36
RASTER_FLOPS_MSAA = 52
RASTER_FLOPS_MSAA4 = 52
# K1-bounded: the two window compares on top of K1's and K1-MSAA's
RASTER_FLOPS_BOUNDED = 38
RASTER_FLOPS_MSAA_BOUNDED = 54
# The kernels' times before their redesign (NVIDIA H100 80GB HBM3, 700.00
# W; PERF.md's kernel table): K1's with the padded stream, K2's with the
# padded stream, K3's scalar gather. Printed beside the new ones; only
# times within one run compare exactly (tools/time_kernels_torch.py)
EARLIER_MS = {"raster_gbuf": 0.8552, "raster_gbuf_msaa": 1.7567,
              "raster_gbuf_bounded": 0.7800,
              "raster_gbuf_msaa_bounded": 1.5447, "raster_vis": 4.6404,
              "raster_vis_msaa4": 7.4914, "palette": 0.2967}
ROOT = Path(__file__).resolve().parent


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the fp32 rate and the bytes over the memory rate."""
    t_ops = ops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def raster_work(binned, width: int, height: int, out_bytes_px: int,
                flops: int, mode: str, tri_id=None) -> dict:
    """Operations and bytes of one raster kernel call on these inputs:
    "need", flops per record per pixel times the pixels of every (record,
    8x4-pixel block) pair in which the record covers a pixel centre or
    sample inside the frame in the mode's own test ("pairs",
    raster.covered_block_pairs, window ignored), or, given tri_id (K2's
    center output, whose occlusion reject skips covered but hidden pairs),
    of every distinct (tri_id, 8x4 block) pair it has won ("won",
    raster.won_block_pairs); "stream", the same flops for every record of
    every group a tile streams against each of the tile's pixels inside
    the frame (the padded stream, the earlier bound); "bytes", the binned
    arrays read once and the outputs written once."""
    from vqengine_tpu_torch.ops import raster
    seq, _ = raster._group_sequences(binned)
    groups = (seq >= 0).sum(dim=1).double()
    tiles = torch.arange(binned.tiles_x * binned.tiles_y, device=seq.device)
    px_w = (width - (tiles % binned.tiles_x) * raster.TILE_W).clamp(max=raster.TILE_W)
    px_h = (height - (tiles // binned.tiles_x) * raster.TILE_H).clamp(max=raster.TILE_H)
    pairs = raster.covered_block_pairs(binned, width, height, mode)
    won = 0 if tri_id is None else raster.won_block_pairs(tri_id)
    inputs = (binned.pairs, binned.gpairs, binned.starts, binned.rstarts,
              binned.gmeta)
    return {
        "need": (flops * raster.BLOCK_W * raster.BLOCK_H
                 * float(pairs if tri_id is None else won)),
        "stream": flops * raster.GROUP * float((groups * (px_w * px_h)).sum()),
        "bytes": (sum(t.numel() * t.element_size() for t in inputs)
                  + width * height * out_bytes_px),
        "pairs": pairs, "won": won}


def add_work(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b[k] for k in b}


def raster_bound(work: dict) -> dict:
    """bound() of what the inputs need, with the padded stream's bound
    beside it as stream_bound_ms."""
    bd = bound(work["need"], work["bytes"])
    bd["stream_bound_ms"] = bound(work["stream"], work["bytes"])["bound_ms"]
    return bd


def bound_text(bd: dict, work: dict, t_k: float) -> str:
    """The bound's line; a kernel faster than its bound means the count
    of pairs is wrong, and fails the run."""
    if bd["bound_ms"] > t_k:
        fail(f"a raster kernel ran in {t_k} ms, below its bound "
             f"{bd['bound_ms']} ms: the pair count is wrong")
    basis = (f"{work['won']} won (tri_id, 8x4 block) pairs; "
             f"{work['pairs']} covered (record, 8x4 block) pairs"
             if work["won"] else
             f"{work['pairs']} covered (record, 8x4 block) pairs")
    return (f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; {basis}), "
            f"{bd['bound_ms'] / t_k:.3f} of it; padded-stream bound "
            f"{bd['stream_bound_ms']:.4f} ms")


def reject_text(c: dict) -> str:
    """What the reject stream evaluates, by the plain mirror of its tests
    (raster.reject_stream_counts' counts c)."""
    from vqengine_tpu_torch.ops import raster
    feet = len(raster.footprints())
    text = (f"reject stream (plain mirror): {c['tile_survivors']} of "
            f"{c['streamed']} streamed records survive the tile test (a) "
            f"({c['tile_survivors'] / max(c['streamed'], 1):.4f}); "
            f"{c['footprint_pairs']} (record, warp footprint) pairs kept by "
            f"the footprint test (b), against {feet * c['streamed']} in the "
            f"padded stream "
            f"({c['footprint_pairs'] / max(feet * c['streamed'], 1):.5f})")
    if "occluded" in c:
        text += (f"; the occlusion reject drops {c['occluded']} of them "
                 f"({c['occluded'] / max(c['footprint_pairs'], 1):.4f}), "
                 f"{c['footprint_pairs'] - c['occluded']} evaluated")
    return text


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs "
              "a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from vqengine_tpu_torch.ops import _backend
    t0 = time.perf_counter()
    _backend.library()
    info = _backend.last_build
    say(f"[build] {info.path.name}: nvcc {info.seconds:.1f} s (one nvcc per "
        f"source, in parallel, then the link), load "
        f"{time.perf_counter() - t0:.1f} s")
    for line in info.ptxas:
        say(f"[build] {line}")
    lib = _backend.library()
    say(f"[build] dynamic shared memory per CTA (the reject stream): K1 "
        f"center {lib.vq_raster_gbuf_smem_bytes(0)} bytes, MSAA "
        f"{lib.vq_raster_gbuf_smem_bytes(1)} bytes (bounded or not); K2 "
        f"center {lib.vq_raster_vis_smem_bytes(0)} bytes, MSAA 4x "
        f"{lib.vq_raster_vis_smem_bytes(1)} bytes")


def load_sponza(dev, translucent: bool = False):
    """Sponza at W x H on its own renderer; translucent: SPONZA_TRANSLUCENT's
    materials made translucent (a transparent part)."""
    from vqengine_tpu_torch.engine.scene_load import (SPONZA_TRANSLUCENT,
                                                      load_scene)
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    scene = load_scene("Sponza", W, H,
                       material_alpha=SPONZA_TRANSLUCENT if translucent else None)
    r = VQRendererTorch(dev)
    r.load_scene(scene.buffers, equirect=scene.equirect)
    if r.env is None:
        fail("Sponza's environment was not built at load")
    if (r.scene_t is not None) != translucent:
        fail(f"Sponza (translucent {translucent}) has transparent part "
             f"{r.scene_t is not None}")
    return scene, r


def phase_palette(dev, sponza, renderer) -> dict:
    from vqengine_tpu_torch.ops import palette, raster
    scene = renderer.scene
    consts = renderer.build_frame_constants(sponza.buffers, sponza.cameras[0],
                                            sponza.lights)
    m = scene.materials.shape[0]
    mp = palette.padded_rows(m)
    g = torch.Generator().manual_seed(1)
    # material ids over a 1080p frame, with negative ids, ids in [M, mp)
    # and ids past mp
    mat_ids = torch.randint(-3, mp + 5, (H, W), generator=g,
                            dtype=torch.int32).to(dev)
    tl = scene.num_tris_live
    item3 = scene.tri_item[:tl].repeat_interleave(3).contiguous()
    n = consts.world.shape[0]
    wvp = raster.world_view_proj(consts.view_proj, consts.world)
    cull = torch.rand((n, 2), generator=g).to(dev)
    shapes = {  # the four lookups of one main-path frame
        "materials[M,32] x 1080p": (mat_ids, scene.materials),
        "mvp[N,16] x 3T": (item3, wvp.reshape(n, 16).contiguous()),
        "normal_mats[N,9] x 3T": (item3, consts.normal_mats.reshape(n, 9).contiguous()),
        "cull[N,2] x T": (scene.tri_item.contiguous(), cull),
    }
    ms = plain_ms = lib_ms = err = nbytes = 0.0
    for name, (idx, table) in shapes.items():
        k = palette.palette_lookup(idx, table)
        p = palette.palette_lookup_plain(idx, table)
        torch.cuda.synchronize()
        if not bitwise_equal(k, p):
            fail(f"palette {name}: kernel != plain")
        err = max(err, float((k - p).abs().max()))
        # the yardstick: one library gather on the pre-padded table with
        # pre-clamped ids (the padding and the clamp are not timed)
        padded = torch.zeros((palette.padded_rows(table.shape[0]), table.shape[1]),
                             dtype=torch.float32, device=dev)
        padded[:table.shape[0]] = table
        ids = idx.reshape(-1).long().clamp(0, padded.shape[0] - 1)
        if not bitwise_equal(torch.index_select(padded, 0, ids).reshape(k.shape), k):
            fail(f"palette {name}: index_select != kernel")
        t_k = time_ms(lambda: palette.palette_lookup(idx, table), 50)
        t_p = time_ms(lambda: palette.palette_lookup_plain(idx, table), 50)
        t_l = time_ms(lambda: torch.index_select(padded, 0, ids), 50)
        b = idx.numel() * 4 + table.numel() * 4 + k.numel() * 4
        ms += t_k
        plain_ms += t_p
        lib_ms += t_l
        nbytes += b
        say(f"[K3] {name} ({idx.numel()} ids): bitwise equal; kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, index_select {t_l:.4f} ms, "
            f"bound {bound(0, b)['bound_ms']:.4f} ms (bytes)")
    bd = bound(0, nbytes)
    say(f"[K3] per frame (4 lookups): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": lib_ms}


def sweep_camera(cam, i: int, base_yaw: float) -> None:
    """bench.py's yaw sweep around the scene camera."""
    cam.yaw = base_yaw + 4.0 * math.sin(i * 0.15)


def phase_raster(dev, sponza, renderer) -> dict:
    from vqengine_tpu_torch.ops import raster
    from vqengine_tpu_torch.render import graph
    consts = renderer.build_frame_constants(sponza.buffers, sponza.cameras[0],
                                            sponza.lights)
    setup, extra = graph.geometry_setup_gbuf(renderer.scene, consts, W, H)
    binned = raster.bin_triangles(setup, W, H, extra=extra)
    if int(binned.overflow.sum()):
        fail(f"K1 input overflowed: {binned.overflow.tolist()}")
    d, i, g = raster.rasterize_gbuf(binned, W, H)
    d2, i2, g2 = raster.rasterize_gbuf_plain(binned, W, H)
    torch.cuda.synchronize()
    if not bitwise_equal(i, i2):
        fail(f"K1 tri_id differs on {int((i != i2).sum())} pixels")
    if not bitwise_equal(d, d2):
        fail(f"K1 depth differs: max {float((d - d2).abs().max())}")
    gerr = float((g - g2).abs().max())
    if not gerr <= GBUF_TOL:
        fail(f"K1 gbuf max |kernel - plain| {gerr} > {GBUF_TOL}")
    t_k = time_ms(lambda: raster.rasterize_gbuf(binned, W, H), 20)
    t_p = time_ms(lambda: raster.rasterize_gbuf_plain(binned, W, H),
                  3, warmup=1)
    # outputs: depth, tri_id and 16 G-buffer channels, 4 bytes each
    work = raster_work(binned, W, H, 4 * (2 + raster.GBUF_OUT), RASTER_FLOPS,
                       raster.CENTER)
    bd = raster_bound(work)
    say(f"[K1] Sponza {W}x{H}: {int(binned.demand)} pairs, "
        f"{binned.pairs.shape[0] // raster.GROUP} groups; tri_id and depth "
        f"bitwise equal, gbuf bitwise {bitwise_equal(g, g2)} "
        f"(max |diff| {gerr}); kernel {t_k:.4f} ms (padded stream, PERF.md: "
        f"{EARLIER_MS['raster_gbuf']} ms), plain {t_p:.4f} ms, "
        f"{bound_text(bd, work, t_k)}")
    say(f"[K1] Sponza {W}x{H}: "
        f"{reject_text(raster.reject_stream_counts(binned, raster.CENTER))}")
    k1 = {"max_abs_err": max(gerr, float((d - d2).abs().max())),
          "ms": t_k, "plain_ms": t_p, **bd, "library_ms": None}
    return k1, phase_raster_msaa(dev, binned)


def check_msaa_kernel(binned, width: int, height: int, label: str):
    """K1-MSAA against its plain version on one binned input: depth,
    tri_id and coverage bitwise, gbuf within GBUF_TOL -> (outputs, max
    |gbuf diff|, partly covered pixels, sample-only winners: pixels that
    K1-MSAA gives a winner and the center-sampled K1 none)."""
    from vqengine_tpu_torch.ops import raster
    out = raster.rasterize_gbuf(binned, width, height, msaa=True)
    plain = raster.rasterize_gbuf_plain(binned, width, height, msaa=True)
    _, center, _ = raster.rasterize_gbuf(binned, width, height)
    torch.cuda.synchronize()
    for name, a, b in zip(("depth", "tri_id", "gbuf", "coverage"), out, plain):
        if name != "gbuf" and not bitwise_equal(a, b):
            fail(f"K1-MSAA {label}: {name} differs on {int((a != b).sum())} "
                 f"values")
    gerr = float((out[2] - plain[2]).abs().max())
    if not gerr <= GBUF_TOL:
        fail(f"K1-MSAA {label}: gbuf max |kernel - plain| {gerr} > {GBUF_TOL}")
    n = out[3].sum(0)
    part = int(((n > 0) & (n < 4)).sum())
    sample_only = int(((out[1] >= 0) & (center < 0)).sum())
    return out, gerr, part, sample_only


def phase_raster_msaa(dev, binned) -> dict:
    """K1-MSAA against its plain version on the binned Sponza frame
    (timed), on HelloCube's silhouettes and on the crafted records."""
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.ops import raster, raster_probes
    from vqengine_tpu_torch.render import graph
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    _, gerr, part, sample_only = check_msaa_kernel(binned, W, H, "Sponza")
    say(f"[K1-MSAA] Sponza {W}x{H}: tri_id, depth and coverage bitwise "
        f"equal, gbuf max |diff| {gerr}; partly covered pixels {part}, "
        f"sample-only winners {sample_only} (a closed interior)")
    for w, h in ((W, H), (SMALL_W, SMALL_H)):
        s = load_scene("HelloCube", w, h)
        r = VQRendererTorch(dev)
        r.load_scene(s.buffers)
        c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        setup, extra = graph.geometry_setup_gbuf(r.scene, c, w, h)
        cube = raster.bin_triangles(setup, w, h, extra=extra)
        _, err, cube_part, cube_only = check_msaa_kernel(cube, w, h, "HelloCube")
        gerr = max(gerr, err)
        say(f"[K1-MSAA] HelloCube {w}x{h}: tri_id, depth and coverage "
            f"bitwise equal, gbuf max |diff| {err}; partly covered pixels "
            f"{cube_part}, sample-only winners {cube_only}")
        if not (cube_part and cube_only):
            fail(f"K1-MSAA HelloCube {w}x{h}: no silhouette to check "
                 f"({cube_part} partly covered, {cube_only} sample-only)")
    probe, counts = raster_probes.msaa_probe(device=dev)
    (depth, tri_id, _, cov), err, p_part, p_only = check_msaa_kernel(
        probe, raster_probes.WIDTH, raster_probes.HEIGHT, "crafted records")
    gerr = max(gerr, err)
    one = int(((cov.sum(0) == 1) & (tri_id >= 0)).sum())
    z1 = int(((depth == 0) & (tri_id >= 0)).sum())
    say(f"[K1-MSAA] crafted records (ops/raster_probes.py, {counts}): "
        f"bitwise equal, gbuf max |diff| {err}; one-sample winners {one}, "
        f"sample-only winners {p_only}, z = 1 winners {z1}")
    if one < counts["thresholds"] // 4 or not p_only or z1 != counts["z1"]:
        fail(f"K1-MSAA crafted records did not reach their cases: {one} "
             f"one-sample, {p_only} sample-only, {z1} z = 1")
    t_k = time_ms(lambda: raster.rasterize_gbuf(binned, W, H, msaa=True), 20)
    t_p = time_ms(lambda: raster.rasterize_gbuf_plain(binned, W, H, msaa=True),
                  3, warmup=1)
    # outputs: depth, tri_id, 16 G-buffer channels and 4 coverage planes
    work = raster_work(binned, W, H, 4 * (2 + raster.GBUF_OUT + 4),
                       RASTER_FLOPS_MSAA, raster.COVERAGE)
    bd = raster_bound(work)
    say(f"[K1-MSAA] Sponza {W}x{H}: kernel {t_k:.4f} ms (padded stream, "
        f"PERF.md: {EARLIER_MS['raster_gbuf_msaa']} ms), plain {t_p:.4f} "
        f"ms, {bound_text(bd, work, t_k)} ({RASTER_FLOPS_MSAA} operations "
        f"per record per pixel)")
    say(f"[K1-MSAA] Sponza {W}x{H}: "
        f"{reject_text(raster.reject_stream_counts(binned, raster.COVERAGE))}")
    return {"max_abs_err": gerr, "ms": t_k, "plain_ms": t_p, **bd,
            "library_ms": None}


def check_bounded_kernel(binned, width: int, height: int, msaa: bool,
                         zbound, label: str):
    """K1-bounded against its plain version on one input: depth, tri_id,
    gbuf (and coverage) bitwise -> (outputs, max |kernel - plain| over the
    float outputs, pixels whose winner the window changed against the
    unbounded kernel, partly covered pixels or None)."""
    from vqengine_tpu_torch.ops import raster
    out = raster.rasterize_gbuf(binned, width, height, msaa=msaa, zbound=zbound)
    plain = raster.rasterize_gbuf_plain(binned, width, height, msaa=msaa,
                                        zbound=zbound)
    free = raster.rasterize_gbuf(binned, width, height, msaa=msaa)
    torch.cuda.synchronize()
    kind = "K1-MSAA-bounded" if msaa else "K1-bounded"
    for name, a, b in zip(("depth", "tri_id", "gbuf", "coverage"), out, plain):
        if not bitwise_equal(a, b):
            fail(f"{kind} {label}: {name} differs on {int((a != b).sum())} values")
    err = max(float((a - b).abs().max()) for a, b in zip(out, plain)
              if a.dtype == torch.float32)
    changed = int((out[1] != free[1]).sum())
    part = None
    if msaa:
        n = out[3].sum(0)
        part = int(((n > 0) & (n < 4)).sum())
    return out, err, changed, part


def phase_raster_bounded(dev, sponza, renderer, st, rt) -> tuple:
    """K1-bounded in both sample modes against its plain version on (a)-(d)
    of the module docstring; both variants timed on the translucent
    Sponza's first peel window at 1080p (the transparent pass's first
    launch)."""
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.ops import raster, raster_probes
    from vqengine_tpu_torch.render import graph
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    # (a) the transparent pass's two windows on the translucent Sponza
    c = rt.build_frame_constants(st.buffers, st.cameras[0], st.lights)
    opaque = graph.geometry_pass(rt.scene, c, W, H, msaa=True)[0]
    setup, extra = graph.geometry_setup_gbuf(rt.scene_t, c, W, H)
    tb = raster.bin_triangles(setup, W, H, extra=extra)
    if int(tb.overflow.sum()):
        fail(f"translucent Sponza's transparent binning overflowed: "
             f"{tb.overflow.tolist()}")
    errs = {False: 0.0, True: 0.0}      # per sample mode
    zlo = torch.full_like(opaque, -1.0)
    first = (zlo, opaque)
    for k in (1, 2):
        out, err, changed, _ = check_bounded_kernel(
            tb, W, H, False, (zlo, opaque), f"translucent Sponza layer {k}")
        errs[False] = max(errs[False], err)
        px = int((out[1] >= 0).sum())
        say(f"[K1-bounded] (a) translucent Sponza {W}x{H}, layer {k} window: "
            f"depth, tri_id and gbuf bitwise equal; {int(tb.demand)} pairs; "
            f"layer pixels {px}, pixels whose winner the window changed "
            f"{changed}")
        if not (px and changed):
            fail(f"K1-bounded translucent Sponza layer {k}: {px} pixels, "
                 f"{changed} changed")
        zlo = out[0]
    # (b) an alpha-peel window on the opaque Sponza's binning
    c = renderer.build_frame_constants(sponza.buffers, sponza.cameras[0],
                                       sponza.lights)
    setup, extra = graph.geometry_setup_gbuf(renderer.scene, c, W, H)
    ob = raster.bin_triangles(setup, W, H, extra=extra)
    depth, tri_id, _ = raster.rasterize_gbuf(ob, W, H)
    failed = (torch.rand((H, W), generator=torch.Generator().manual_seed(7))
              < 0.25).to(dev) & (tri_id >= 0)
    two = torch.full_like(depth, 2.0)
    out, err, changed, _ = check_bounded_kernel(
        ob, W, H, False, (torch.where(failed, depth, two), two),
        "alpha-peel window")
    errs[False] = max(errs[False], err)
    behind = int((failed & (out[1] >= 0)).sum())
    say(f"[K1-bounded] (b) alpha-peel window on Sponza {W}x{H}: bitwise "
        f"equal; failed pixels {int(failed.sum())}, a surface behind "
        f"{behind}, pixels whose winner the window changed {changed}")
    if not behind:
        fail("K1-bounded alpha-peel window: no surface behind a failed pixel")
    # (c) the MSAA variant through HelloCube's silhouettes
    for w, h in ((W, H), (SMALL_W, SMALL_H)):
        s = load_scene("HelloCube", w, h)
        r = VQRendererTorch(dev)
        r.load_scene(s.buffers)
        cc = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        setup, extra = graph.geometry_setup_gbuf(r.scene, cc, w, h)
        cube = raster.bin_triangles(setup, w, h, extra=extra)
        d, t, _ = raster.rasterize_gbuf(cube, w, h)
        q = torch.quantile(d[t >= 0], torch.tensor([0.25, 0.75], device=dev))
        zb = (torch.full_like(d, float(q[0])), torch.full_like(d, float(q[1])))
        _, err, changed, part = check_bounded_kernel(cube, w, h, True, zb,
                                                     f"HelloCube {w}x{h}")
        errs[True] = max(errs[True], err)
        say(f"[K1-bounded] (c) HelloCube {w}x{h}, MSAA, window "
            f"({float(q[0]):.6f}, {float(q[1]):.6f}): depth, tri_id, gbuf and "
            f"coverage bitwise equal; partly covered pixels {part}, pixels "
            f"whose winner the window changed {changed}")
        if not (part and changed):
            fail(f"K1-MSAA-bounded HelloCube {w}x{h}: {part} partly covered, "
                 f"{changed} changed")
    # (d) crafted records and windows
    pb, zb, cls = raster_probes.bounded_probe(device=dev)
    pw, ph = raster_probes.BOUNDED_W, raster_probes.BOUNDED_H
    for msaa in (False, True):
        out, err, changed, part = check_bounded_kernel(pb, pw, ph, msaa, zb,
                                                       "crafted records")
        errs[msaa] = max(errs[msaa], err)
        empty = (cls == 3) | (cls == 7) | (cls == 10)
        center = raster.rasterize_gbuf(pb, pw, ph, zbound=zb)[1]
        sample_only = int(((out[1] >= 0) & (center < 0)).sum())
        say(f"[K1-bounded] (d) crafted records {pw}x{ph} "
            f"(ops/raster_probes.bounded_probe), {'MSAA' if msaa else 'center'}"
            f": bitwise equal; pixels whose winner the window changed "
            f"{changed}, empty-window pixels {int(empty.sum())} all background"
            f"{'' if part is None else f', partly covered {part}, sample-only winners {sample_only}'}")
        if bool((out[1][empty] >= 0).any()) or not changed:
            fail(f"crafted records: an empty window has a winner or nothing "
                 f"changed ({changed})")
        if msaa and not (part and sample_only):
            fail(f"crafted records, MSAA: {part} partly covered, {sample_only} "
                 f"sample-only")
    timed = {}
    for msaa, flops in ((False, RASTER_FLOPS_BOUNDED),
                        (True, RASTER_FLOPS_MSAA_BOUNDED)):
        t_k = time_ms(lambda: raster.rasterize_gbuf(tb, W, H, msaa=msaa,
                                                    zbound=first), 20)
        t_p = time_ms(lambda: raster.rasterize_gbuf_plain(
            tb, W, H, msaa=msaa, zbound=first), 3, warmup=1)
        # outputs: depth, tri_id, 16 G-buffer channels (and 4 coverage
        # planes); the window's two planes read once
        out_px = 4 * (2 + raster.GBUF_OUT + (4 if msaa else 0)) + 8
        mode = raster.COVERAGE if msaa else raster.CENTER
        work = raster_work(tb, W, H, out_px, flops, mode)
        bd = raster_bound(work)
        name = raster.gbuf_kernel_name(msaa, True)
        say(f"[K1-bounded] {name}, translucent Sponza {W}x{H} layer 1: kernel "
            f"{t_k:.4f} ms (padded stream, PERF.md: {EARLIER_MS[name]} ms), "
            f"plain {t_p:.4f} ms, {bound_text(bd, work, t_k)} ({flops} "
            f"operations per record per pixel)")
        say(f"[K1-bounded] {name}, translucent Sponza {W}x{H} layer 1: "
            f"{reject_text(raster.reject_stream_counts(tb, mode))}")
        timed[name] = {"max_abs_err": errs[msaa], "ms": t_k, "plain_ms": t_p,
                       **bd, "library_ms": None}
    return timed["raster_gbuf_bounded"], timed["raster_gbuf_msaa_bounded"]


def phase_reject_probe(dev) -> None:
    """Every K1 variant against its plain version on
    ops/raster_probes.reject_probe (records on the reject test's margin,
    neighbour-bin records reaching through the edge bias, killed,
    near-plane and degenerate records; the bounded variants with the
    probe's seeded window): depth, tri_id, gbuf (and coverage) bitwise;
    then K2 in both sample modes on the same records cut to 16 rows and on
    ops/raster_probes.depth_reject_probe (records stacked on a footprint's
    depth, on and around the occlusion reject's margin), bitwise, each
    depth_reject_probe record winning its pixels in the center mode."""
    from vqengine_tpu_torch.ops import raster, raster_probes
    pb, zb, info = raster_probes.reject_probe(device=dev)
    w, h = raster_probes.REJECT_W, raster_probes.REJECT_H
    tile = ((torch.arange(h, device=dev)[:, None] // raster.TILE_H)
            * raster_probes.REJECT_TILES_X
            + torch.arange(w, device=dev)[None, :] // raster.TILE_W)
    for msaa in (False, True):
        for bounded in (False, True):
            name = raster.gbuf_kernel_name(msaa, bounded)
            zbound = zb if bounded else None
            out = raster.rasterize_gbuf(pb, w, h, msaa=msaa, zbound=zbound)
            plain = raster.rasterize_gbuf_plain(pb, w, h, msaa=msaa,
                                                zbound=zbound)
            torch.cuda.synchronize()
            for label, a, b in zip(("depth", "tri_id", "gbuf", "coverage"),
                                   out, plain):
                if not bitwise_equal(a, b):
                    fail(f"{name} reject_probe: {label} differs on "
                         f"{int((a != b).sum())} values")
            tri = out[1].cpu()
            margin = sum(int(tri[y, x]) == row
                         for row, _, _, (x, y) in info["margin"]
                         if x < w and y < h)
            reach = sum(int(((out[1] == row) & (tile == t)).sum())
                        for row, _, t in info["reach"])
            say(f"[reject] {name} on ops/raster_probes.reject_probe ({w}x{h}; "
                f"{len(info['margin'])} margin, {len(info['reach'])} reach, "
                f"{info['killed']} killed, {info['near_plane']} near-plane, "
                f"{info['degenerate']} degenerate records): bitwise equal; "
                f"margin corners won by their record {margin}, pixels won "
                f"through the edge bias in a neighbour tile {reach}")
            if not (margin and (bounded or reach)):
                fail(f"{name} reject_probe reached nothing: {margin} margin "
                     f"corners, {reach} reach pixels")
    # K2 in both sample modes: reject_probe's records cut to 16 rows, and
    # depth_reject_probe's records stacked on a footprint's depth
    vb = raster_probes.vis_records(pb)
    db, dinfo = raster_probes.depth_reject_probe(device=dev)
    dw, dh = raster_probes.DEPTH_W, raster_probes.DEPTH_H
    for msaa in (False, True):
        name = "raster_vis_msaa4" if msaa else "raster_vis"
        for label, b, bw, bh in (("reject_probe", vb, w, h),
                                 ("depth_reject_probe", db, dw, dh)):
            out = raster.rasterize(b, bw, bh, msaa=msaa)
            plain = raster.rasterize_plain(b, bw, bh, msaa=msaa)
            torch.cuda.synchronize()
            if not all(bitwise_equal(a, p) for a, p in zip(out, plain)):
                fail(f"{name} {label}: kernel != plain")
            line = (f"[reject] {name} on ops/raster_probes.{label} "
                    f"({bw}x{bh}): bitwise equal; covered "
                    f"{int((out[1] >= 0).sum())} {'samples' if msaa else 'pixels'}")
            if label == "depth_reject_probe" and not msaa:
                won = {k: int((out[1] == row).sum())
                       for k, row in dinfo["rows"].items()}
                if any(won[k] != dinfo["winners"].get(k, 0) for k in won):
                    fail(f"{name} {label}: winners {won}, expected "
                         f"{dinfo['winners']}")
                occ = raster.reject_stream_counts(b, raster.CENTER,
                                                  occlusion=True)["occluded"]
                line += (f"; pixels won per record {won}; (record, footprint) "
                         f"pairs the occlusion reject drops {occ} (by the "
                         f"probe's construction "
                         f"{sum(len(v) for v in dinfo['occluded'].values())})")
            say(line)


def caster_views(consts) -> list:
    """(name, light view-projection, size) of every caster view, in the
    order render_shadow_maps renders them, at the full shadow budget."""
    from vqengine_tpu_torch.ops import shadow
    faces = ("+X", "-X", "+Y", "-Y", "+Z", "-Z")
    views = [(f"spot{i}", consts.spot_caster_vps[i], shadow.SPOT_SHADOW_DIM)
             for i in range(consts.spot_caster_vps.shape[0])]
    views += [(f"point{i}{faces[f]}", consts.point_caster_vps[i, f],
               shadow.POINT_SHADOW_DIM)
              for i in range(consts.point_caster_vps.shape[0]) for f in range(6)]
    views += [("dir", consts.dir_vp[0], shadow.DIRECTIONAL_SHADOW_DIM)
              for _ in range(consts.dir_vp.shape[0])]
    return views


def phase_vis(dev, sponza, renderer) -> dict:
    from vqengine_tpu_torch.ops import raster, shadow
    consts = renderer.build_frame_constants(sponza.buffers, sponza.cameras[0],
                                            sponza.lights)
    scene = renderer.scene
    views = caster_views(consts)
    if len(views) != 8:
        fail(f"Sponza has {len(views)} caster views, expected 8")
    ms = err = 0.0
    total, counts = {}, {}
    plain_ms = plain_view = None
    for name, vp, size in views:
        binned = shadow.bin_shadow_view(scene.positions, scene.item_of_vertex,
                                        consts.world, vp, scene.indices, size)
        d, i = raster.rasterize(binned, size, size)
        d2, i2 = raster.rasterize_plain(binned, size, size)
        torch.cuda.synchronize()
        if not bitwise_equal(i, i2):
            fail(f"K2 {name}: tri_id differs on {int((i != i2).sum())} texels")
        if not bitwise_equal(d, d2):
            fail(f"K2 {name}: depth differs: max {float((d - d2).abs().max())}")
        err = max(err, float((d - d2).abs().max()))
        t_k = time_ms(lambda: raster.rasterize(binned, size, size), 10)
        if plain_ms is None:
            plain_ms = time_ms(lambda: raster.rasterize_plain(binned, size, size),
                               1, warmup=1)
            plain_view = name
        # depth + tri_id; the bound counts the pairs the plain output won
        work = raster_work(binned, size, size, 8, RASTER_FLOPS, raster.CENTER,
                           tri_id=i2)
        total = add_work(total, work)
        c = raster.reject_stream_counts(binned, raster.CENTER, occlusion=True)
        counts = add_work(counts, c)
        ms += t_k
        say(f"[K2] {name} {size}^2: pair demand {int(binned.demand)}, capacity "
            f"{binned.pair_cap}, overflow {binned.overflow.tolist()}; "
            f"covered {float((i >= 0).float().mean()):.4f}; depth and tri_id "
            f"bitwise equal; kernel {t_k:.4f} ms, "
            f"{bound_text(raster_bound(work), work, t_k)}; {c['footprint_pairs']} "
            f"footprint pairs, {c['occluded']} occluded")
    bd = raster_bound(total)
    say(f"[K2] per frame (8 views): kernel {ms:.4f} ms (padded stream, "
        f"PERF.md: {EARLIER_MS['raster_vis']} ms), "
        f"{bound_text(bd, total, ms)}; plain {plain_ms:.4f} ms on the "
        f"{plain_view} view alone")
    say(f"[K2] per frame (8 views): {reject_text(counts)}")
    k2 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
          "library_ms": None}
    return k2, phase_vis_msaa4(renderer, consts, views)


def phase_vis_msaa4(renderer, consts, views) -> dict:
    """K2-msaa4 against its plain version on the directional 2048^2 view
    and the first 1024^2 spot view; its times and bound are their sums."""
    from vqengine_tpu_torch.ops import raster, shadow
    scene = renderer.scene
    ms = plain_ms = err = 0.0
    total, counts = {}, {}
    for name, vp, size in [v for v in views if v[0] in ("dir", "spot0")]:
        binned = shadow.bin_shadow_view(scene.positions, scene.item_of_vertex,
                                        consts.world, vp, scene.indices, size)
        d, i = raster.rasterize(binned, size, size, msaa=True)
        d2, i2 = raster.rasterize_plain(binned, size, size, msaa=True)
        torch.cuda.synchronize()
        if not (bitwise_equal(i, i2) and bitwise_equal(d, d2)):
            fail(f"K2-msaa4 {name}: kernel != plain on "
                 f"{int((i != i2).sum())} ids, {int((d != d2).sum())} depths")
        err = max(err, float((d - d2).abs().max()))
        t_k = time_ms(lambda: raster.rasterize(binned, size, size, msaa=True), 10)
        t_p = time_ms(lambda: raster.rasterize_plain(binned, size, size, msaa=True),
                      1, warmup=1)
        # depth and tri_id per sample
        work = raster_work(binned, size, size, 4 * 8, RASTER_FLOPS_MSAA4,
                           raster.SAMPLES4)
        total = add_work(total, work)
        counts = add_work(counts, raster.reject_stream_counts(binned,
                                                              raster.SAMPLES4))
        ms += t_k
        plain_ms += t_p
        split = float((i != i[:1]).any(0).float().mean())
        say(f"[K2-msaa4] {name} {size}^2: depth and tri_id stacks bitwise "
            f"equal; texels whose samples differ {split:.4f}; kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"{bound_text(raster_bound(work), work, t_k)} "
            f"({RASTER_FLOPS_MSAA4} operations per record per pixel)")
    bd = raster_bound(total)
    say(f"[K2-msaa4] both views: kernel {ms:.4f} ms (padded stream, PERF.md: "
        f"{EARLIER_MS['raster_vis_msaa4']} ms), plain {plain_ms:.4f} ms, "
        f"{bound_text(bd, total, ms)}")
    say(f"[K2-msaa4] both views: {reject_text(counts)}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None}


def phase_environment(dev, card: str, sponza):
    """Sponza's ProceduralSky built on the card at the engine's default
    sizes: ms by CUDA events to a sync (cold: the BRDF LUT computed on the
    card; warm: the LUT cached, as at every later scene load), the peak
    device memory above what was allocated before the build, and the
    tables against the CPU's build of the same equirect; fails above the
    bars. -> the CPU's build (the tables the card-vs-CPU frames carry)."""
    from vqengine_tpu_torch.ops import ibl
    from vqengine_tpu_torch.render import graph
    eq = sponza.equirect
    builds = []
    for label in ("cold, the LUT computed on the card", "warm, the LUT cached"):
        if label.startswith("cold"):
            ibl._BRDF_LUT_CACHE.clear()
            ibl._BRDF_POLY_CACHE.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        env = graph.build_environment(eq, dev)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        builds.append((label, start.elapsed_time(end), host_ms, peak))
    for label, ms, host_ms, peak in builds:
        say(f"[env] build_environment, Sponza's sky {eq.shape[1]}x{eq.shape[0]} "
            f"(diffuse 64, specular 128 x 6 mips, LUT 256^2 x 512 samples), "
            f"{label}: {ms:.3f} ms by CUDA events ({host_ms:.3f} ms host "
            f"clock to the sync), peak device memory {peak:.1f} MiB above the "
            f"scene's, on {card}")
    t0 = time.perf_counter()
    cpu = graph.build_environment(eq, torch.device("cpu"))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    d = graph.environment_differences(env, cpu)
    say(f"[env] the card's tables against the CPU's build ({cpu_ms:.0f} ms on "
        f"the host's {torch.get_num_threads()} threads): bf16 (entries "
        f"differing, largest bf16 ulps, entries) and f32 normwise relative "
        f"error: { {k: v for k, v in d.items() if k != 'ok'} }; bars: "
        f"{graph.ENV_BF16_MAX_ULPS} ulp on at most "
        f"{graph.ENV_BF16_MAX_SHARE:.0%} of entries, {graph.ENV_F32_MAX_REL}")
    if not d["ok"] or d["equirect"][0]:
        fail(f"the card's environment tables are outside the bars: {d}")
    return cpu


def phase_env_card_vs_cpu(dev, env_cpu) -> None:
    """Frames lit by the environment at 192x108, on the card and on the
    CPU with the same tables (the CPU's build carried to the card):
    EnvironmentMapUnitTest without MSAA and with the "shade" edge resolve,
    and the translucent Sponza (engine default, cached 64^2 ESM maps, its
    transparent pass lit too): tri_id equal, ldr within ENTRY_TOL."""
    from vqengine_tpu_torch.engine.scene_load import (SPONZA_TRANSLUCENT,
                                                      load_scene)
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    frames = [("EnvironmentMapUnitTest", None, {}),
              ("EnvironmentMapUnitTest", None,
               dict(msaa=True, msaa_edge_resolve="shade")),
              ("Sponza", SPONZA_TRANSLUCENT, dict(msaa=True))]
    for name, alpha, flags in frames:
        s = load_scene(name, SMALL_W, SMALL_H, material_alpha=alpha)
        outs = []
        for d in (dev, torch.device("cpu")):
            r = VQRendererTorch(d)
            r.load_scene(s.buffers)
            c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
            maps = r.precompute_shadow_maps(c, SMALL_DIMS)
            out = r.render(c, SMALL_W, SMALL_H, shadow_dims=SMALL_DIMS,
                           shadow_maps=maps, env=env_cpu.to(d), **flags)
            outs.append({k: out[k].cpu() for k in ("ldr", "tri_id")})
        same = int((outs[0]["tri_id"] == outs[1]["tri_id"]).sum())
        diff = float((outs[0]["ldr"] - outs[1]["ldr"]).abs().max())
        label = f"{name}{' (translucent)' if alpha else ''} {flags or 'no MSAA'}"
        say(f"[env] {label} {SMALL_W}x{SMALL_H}, lit by the environment (the "
            f"CPU's tables on both), card vs CPU: tri_id equal on "
            f"{same}/{SMALL_W * SMALL_H} pixels, max |ldr diff| {diff}")
        if same != SMALL_W * SMALL_H or not diff <= ENTRY_TOL:
            fail(f"{label} card vs CPU: {same} equal ids, ldr diff {diff}")


def phase_goldens(dev) -> None:
    from vqengine_tpu_torch.engine.goldens import (SCENES, golden_scores,
                                                    render_golden)
    from vqengine_tpu_torch.entry import entry
    for golden in SCENES:
        s = golden_scores(golden, render_golden(golden, dev))
        say(f"[golden] {golden}: SSIM {s['ssim']:.5f}, mean MAE "
            f"{s['mean_mae']:.5f}, worst block {s['block_mae']:.5f}")
        if not s["ok"]:
            fail(f"golden {golden} outside the bars")
    fn, args = entry(dev)
    ldr = fn(*args).cpu()
    fn_c, args_c = entry(torch.device("cpu"))
    diff = float((ldr - fn_c(*args_c)).abs().max())
    say(f"[golden] entry() 256x128 card vs CPU: max |ldr diff| {diff}")
    if not diff <= ENTRY_TOL:
        fail(f"entry() card vs CPU {diff} > {ENTRY_TOL}")


def phase_shadow_card_vs_cpu(dev) -> None:
    """Sponza at 192x108 with 64^2 ESM maps rendered in the frame, on the
    card and on the CPU: ldr within ENTRY_TOL where tri_id agrees."""
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    s = load_scene("Sponza", SMALL_W, SMALL_H)
    outs, maps = [], []
    for d in (dev, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        out = r.render(c, SMALL_W, SMALL_H, shadow_dims=SMALL_DIMS)
        outs.append({k: out[k].cpu() for k in ("ldr", "tri_id")})
        maps.append({k: v.float().cpu()
                     for k, v in r.precompute_shadow_maps(c, SMALL_DIMS).items()})
    same = outs[0]["tri_id"] == outs[1]["tri_id"]
    share = float(same.float().mean())
    diff = float((outs[0]["ldr"] - outs[1]["ldr"])[same].abs().max())
    texels = sum(m.numel() for m in maps[0].values())
    equal = sum(int((maps[0][k] == maps[1][k]).sum()) for k in maps[0])
    say(f"[shadow] Sponza {SMALL_W}x{SMALL_H}, ESM maps {SMALL_DIMS[0]}^2 "
        f"rendered in the frame, card vs CPU: tri_id agrees on {share:.6f} "
        f"of pixels, max |ldr diff| {diff} there; bf16 map texels equal "
        f"{equal}/{texels}")
    if share < 0.999 or not diff <= ENTRY_TOL:
        fail(f"shadowed Sponza card vs CPU: share {share}, ldr diff {diff}")


def phase_msaa_card_vs_cpu(dev) -> None:
    """Sponza at 192x108 with MSAA and cached 64^2 ESM maps, on the card
    and on the CPU, in both edge-resolve modes: ldr within ENTRY_TOL where
    tri_id agrees, the same edge saturation."""
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    s = load_scene("Sponza", SMALL_W, SMALL_H)
    sides = []
    for d in (dev, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        sides.append((r, c, r.precompute_shadow_maps(c, SMALL_DIMS)))
    for mode in ("neighbor", "shade"):
        outs = [r.render(c, SMALL_W, SMALL_H, shadow_dims=SMALL_DIMS,
                         shadow_maps=m, msaa=True, msaa_edge_resolve=mode)
                for r, c, m in sides]
        same = outs[0]["tri_id"].cpu() == outs[1]["tri_id"]
        share = float(same.float().mean())
        diff = float((outs[0]["ldr"].cpu() - outs[1]["ldr"])[same].abs().max())
        sat = [float(o["saturation"]["msaa_edges"]) for o in outs]
        say(f"[msaa] Sponza {SMALL_W}x{SMALL_H}, MSAA 4x, {mode} edge resolve, "
            f"cached ESM maps {SMALL_DIMS[0]}^2, card vs CPU: tri_id agrees on "
            f"{share:.6f} of pixels, max |ldr diff| {diff} there; msaa_edges "
            f"{sat[0]:.4f} (CPU {sat[1]:.4f})")
        if share < 0.999 or not diff <= ENTRY_TOL or sat[0] != sat[1]:
            fail(f"MSAA Sponza card vs CPU ({mode}): share {share}, ldr diff "
                 f"{diff}, saturation {sat}")


def phase_transparent_card_vs_cpu(dev) -> None:
    """The translucent Sponza at 192x108, engine default (MSAA, neighbor
    edge resolve, cached 64^2 ESM maps) with its transparent pass, on the
    card and on the CPU: tri_id equal, ldr within ENTRY_TOL."""
    from vqengine_tpu_torch.engine.scene_load import (SPONZA_TRANSLUCENT,
                                                      load_scene)
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    s = load_scene("Sponza", SMALL_W, SMALL_H, material_alpha=SPONZA_TRANSLUCENT)
    outs = []
    for d in (dev, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        c = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
        maps = r.precompute_shadow_maps(c, SMALL_DIMS)
        out = r.render(c, SMALL_W, SMALL_H, shadow_dims=SMALL_DIMS,
                       shadow_maps=maps, msaa=True)
        outs.append({k: out[k].cpu() for k in ("ldr", "tri_id")})
    same = int((outs[0]["tri_id"] == outs[1]["tri_id"]).sum())
    diff = float((outs[0]["ldr"] - outs[1]["ldr"]).abs().max())
    say(f"[transparent] translucent Sponza {SMALL_W}x{SMALL_H}, MSAA, cached "
        f"ESM maps {SMALL_DIMS[0]}^2, two transparent layers, card vs CPU: "
        f"tri_id equal on {same}/{SMALL_W * SMALL_H} pixels, max |ldr diff| "
        f"{diff}")
    if same != SMALL_W * SMALL_H or not diff <= ENTRY_TOL:
        fail(f"translucent Sponza card vs CPU: {same} equal ids, ldr diff {diff}")


def run_frames(renderer, consts: list, card: str, label: str, **flags) -> dict:
    """Render the frames (CUDA events around each) with the launch counts
    set to 0 first; fail on overflow, non-finite output or a plain version
    run on CUDA tensors. -> launches."""
    from vqengine_tpu_torch.ops import _backend
    torch.cuda.synchronize()
    _backend.reset_counts()
    times, cover, sat = [], [], []
    for i, c in enumerate(consts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = renderer.render(c, W, H, **flags)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        ldr = out["ldr"]
        if tuple(ldr.shape) != (H, W, 3) or not bool(torch.isfinite(ldr).all()):
            fail(f"{label} frame {i}: ldr {tuple(ldr.shape)} not finite/shaped")
        if int(out["overflow"].sum()):
            fail(f"{label} frame {i}: overflow {out['overflow'].tolist()}")
        cover.append(float((out["tri_id"] >= 0).float().mean()))
        if "msaa_edges" in out["saturation"]:
            sat.append((float(out["saturation"]["msaa_edges"]),
                        float(out["saturation"]["msaa_edges_demand"])))
    launches = dict(_backend.launches)
    plain = dict(_backend.plain_cuda_calls)
    ms = sorted(times)
    say(f"[main] {label}: {len(ms)} frames, overflow 0, finite; covered-pixel "
        f"share {min(cover):.4f}..{max(cover):.4f}; ms/frame (CUDA events, "
        f"host syncs included): mean {sum(ms) / len(ms):.3f}, median "
        f"{ms[len(ms) // 2]:.3f}, min {ms[0]:.3f}, max {ms[-1]:.3f} on {card}")
    if sat:
        say(f"[main] {label}: saturation msaa_edges "
            f"{min(v for v, _ in sat):.4f}..{max(v for v, _ in sat):.4f}, "
            f"msaa_edges_demand {min(v for _, v in sat):.4f}.."
            f"{max(v for _, v in sat):.4f}")
        if max(v for v, _ in sat) > 1.0:
            fail(f"{label}: the edge compaction overflowed: {sat}")
    say(f"[main] {label}: kernel launches {launches}; plain-version calls on "
        f"CUDA tensors {plain}")
    if max(plain.values()) != 0:
        fail(f"{label}: plain versions ran on CUDA tensors: {plain}")
    return launches


def precompute(renderer, consts, card: str, filter_mode: str):
    """precompute_shadow_maps at the full budget, host-timed to the sync,
    with the launch counts set to 0 first -> (maps, ms, launches)."""
    from vqengine_tpu_torch.ops import _backend
    torch.cuda.synchronize()
    _backend.reset_counts()
    t0 = time.perf_counter()
    maps = renderer.precompute_shadow_maps(consts, filter_mode=filter_mode)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_backend.launches)
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in maps.items()}
    say(f"[main] precompute_shadow_maps ({filter_mode}, 8 views): {ms:.3f} ms "
        f"(host clock to the sync) on {card}; maps {shapes}; launches "
        f"{launches}")
    if launches["raster_vis"] != 8:
        fail(f"precompute launched raster_vis {launches['raster_vis']} times, "
             f"expected 8")
    if max(_backend.plain_cuda_calls.values()) != 0:
        fail(f"precompute ran plain versions: {_backend.plain_cuda_calls}")
    return maps, ms, launches


def phase_main_path(dev, card: str, sponza, renderer) -> dict:
    cam = sponza.cameras[0]
    base_yaw = cam.yaw
    n_tris = sponza.buffers.indices.shape[0]
    say(f"[main] Sponza {W}x{H}: {n_tris} triangles, "
        f"{len(sponza.buffers.items)} items, "
        f"{int(sponza.buffers.item_num_lods.max())} LODs, camera "
        f"{cam.position.tolist()}; its environment (a "
        f"{sponza.equirect.shape[1]}x{sponza.equirect.shape[0]} sky, maps "
        f"built at load) lights every frame below and is the background, "
        f"unless a row says otherwise; shadow casters "
        f"({sponza.has_shadow_casters})")
    if sponza.wants_textures:
        fail("Sponza wants textures, which are not ported yet")
    consts = []
    for i in range(N_FRAMES):
        sweep_camera(cam, i, base_yaw)
        consts.append(renderer.build_frame_constants(sponza.buffers, cam,
                                                     sponza.lights))
    cam.yaw = base_yaw
    # warm-up: one precompute and two frames of each path
    maps = renderer.precompute_shadow_maps(consts[0])
    for c in consts[:2]:
        renderer.render(c, W, H, shadow_maps=maps)
        renderer.render(c, W, H)
        renderer.render(c, W, H, enable_shadows=False)
        renderer.render(c, W, H, shadow_maps=maps, msaa=True)
        renderer.render(c, W, H, shadow_maps=maps, msaa=True, env=None)
        renderer.render(c, W, H, shadow_maps=maps, msaa=True,
                        msaa_edge_resolve="shade")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) the engine's shadowed path: static casters, maps cached once
    maps, pre_ms, pre_launches = precompute(renderer, consts[0], card, "esm")
    frames = run_frames(renderer, consts, card, "shadowed, cached ESM maps",
                        shadow_maps=maps)
    launches = {k: pre_launches[k] + frames[k] for k in frames}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    say(f"[main] shadowed path (precompute + {N_FRAMES} frames): launches "
        f"{launches}; peak device memory {peak:.1f} MiB")
    if min(launches[k] for k in ("palette", "raster_gbuf", "raster_vis")) <= 0:
        fail(f"a kernel of the shadowed path never launched: {launches}")
    if frames["raster_vis"] != 0:
        fail(f"cached-map frames launched raster_vis {frames['raster_vis']} times")

    # (b) dynamic casters: the maps rendered in every frame
    side = consts[:N_SIDE_FRAMES]
    inframe = run_frames(renderer, side, card, "shadowed, maps in the frame")
    if inframe["raster_vis"] != 8 * len(side):
        fail(f"in-frame path launched raster_vis {inframe['raster_vis']} "
             f"times, expected {8 * len(side)}")

    # (c) PCF with cached PCF maps
    pcf_maps, _, _ = precompute(renderer, consts[0], card, "pcf")
    run_frames(renderer, side, card, "shadowed, cached PCF maps",
               shadow_filter="pcf", shadow_maps=pcf_maps)

    # (d) the first slice's path: shadows off
    off = run_frames(renderer, consts[:N_UNSHADOWED], card, "shadows off",
                     enable_shadows=False)
    if min(off["palette"], off["raster_gbuf"]) <= 0 or off["raster_vis"]:
        fail(f"shadows-off path launches {off}")

    # (e) the engine's default frame (bAntiAliasing on): static casters'
    # maps cached once, MSAA 4x with the neighbor edge resolve
    torch.cuda.reset_peak_memory_stats()
    maps_e, _, pre_e = precompute(renderer, consts[0], card, "esm")
    msaa = run_frames(renderer, consts, card,
                      "engine default: MSAA 4x, neighbor edge resolve, cached "
                      "ESM maps, environment and skydome", shadow_maps=maps_e,
                      msaa=True)
    peak_e = torch.cuda.max_memory_allocated() / 2 ** 20
    launches_e = {k: pre_e[k] + msaa[k] for k in msaa}
    say(f"[main] engine default path (precompute + {N_FRAMES} MSAA frames): "
        f"launches {launches_e}; peak device memory {peak_e:.1f} MiB")
    if (msaa["raster_gbuf_msaa"] != N_FRAMES or msaa["raster_gbuf"]
            or msaa["raster_vis"] or msaa["palette"] <= 0):
        fail(f"MSAA frames launched {msaa}")
    bare = run_frames(renderer, consts, card,
                      "engine default without the environment (env=None: "
                      "clear color, no environment term)", shadow_maps=maps_e,
                      msaa=True, env=None)
    if bare != msaa:
        fail(f"frames without the environment launched {bare}, with it {msaa}")
    shade = run_frames(renderer, side, card,
                       "MSAA 4x, shade edge resolve, cached ESM maps",
                       shadow_maps=maps_e, msaa=True, msaa_edge_resolve="shade")
    if shade["raster_gbuf_msaa"] != len(side):
        fail(f"shade-mode MSAA frames launched {shade}")
    say(f"[main] pair bucket {renderer.pair_bucket}")
    return {k: launches[k] + launches_e[k] for k in launches}


def phase_transparent_path(card: str, st, rt) -> dict:
    """(f) the translucent Sponza on its own renderer: the layers' pixel
    counts of the first frame, the precompute, N_FRAMES engine-default
    frames and N_SIDE_FRAMES without MSAA, each with the transparent pass
    (2 K1-bounded launches per frame) -> launches."""
    from vqengine_tpu_torch.engine.scene_load import SPONZA_TRANSLUCENT
    from vqengine_tpu_torch.render import graph
    cam = st.cameras[0]
    base_yaw = cam.yaw
    consts = []
    for i in range(N_FRAMES):
        sweep_camera(cam, i, base_yaw)
        consts.append(rt.build_frame_constants(st.buffers, cam, st.lights))
    cam.yaw = base_yaw
    opaque = graph.geometry_pass(rt.scene, consts[0], W, H, msaa=True)[0]
    layers = graph.transparent_layers(rt.scene_t, consts[0], opaque, W, H)
    pixels = [int(layer["mask"].sum()) for layer in layers]
    say(f"[main] (f) translucent Sponza {W}x{H} (material alpha "
        f"{SPONZA_TRANSLUCENT}): "
        f"{rt.scene_t.num_tris_live} transparent triangles (corner tables), "
        f"{rt.scene.num_tris_live} opaque; first frame's layer pixels "
        f"{pixels}")
    if min(pixels) == 0:
        fail(f"a transparent layer is empty: {pixels}")
    maps = rt.precompute_shadow_maps(consts[0])
    for c in consts[:2]:
        rt.render(c, W, H, shadow_maps=maps, msaa=True)
        rt.render(c, W, H, shadow_maps=maps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    maps, _, pre = precompute(rt, consts[0], card, "esm")
    msaa = run_frames(rt, consts, card, "(f) translucent Sponza, engine "
                      "default (MSAA, neighbor, cached ESM maps, environment) "
                      "+ 2-layer transparent pass", shadow_maps=maps, msaa=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    side = consts[:N_SIDE_FRAMES]
    plain = run_frames(rt, side, card, "(f) translucent Sponza, no MSAA, "
                       "cached ESM maps, environment + 2-layer transparent "
                       "pass", shadow_maps=maps)
    n, m = len(consts), len(side)
    say(f"[main] (f) launches per frame: engine default "
        f"{ {k: v / n for k, v in msaa.items()} }, no MSAA "
        f"{ {k: v / m for k, v in plain.items()} }; peak device memory "
        f"{peak:.1f} MiB")
    if (msaa["raster_gbuf_bounded"] != 2 * n or msaa["raster_gbuf_msaa_bounded"]
            or msaa["raster_gbuf_msaa"] != n or msaa["raster_gbuf"]):
        fail(f"translucent MSAA frames launched {msaa}")
    if plain["raster_gbuf_bounded"] != 2 * m or plain["raster_gbuf"] != m:
        fail(f"translucent frames without MSAA launched {plain}")
    return {k: pre[k] + msaa[k] + plain[k] for k in msaa}


def idle_share(trace: dict, window_name: str) -> tuple[float, float, dict]:
    """From a chrome trace of torch.profiler: -> (window ms, device busy
    ms, {kernel name: (ms, launches)}). The window is the host annotation
    `window_name`; busy is the union of the kernel, memcpy and memset
    intervals on the card, clipped to the window."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == window_name)
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    spans, rows = [], {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        spans.append((a, b))
        ms, n = rows.get(e["name"], (0.0, 0))
        rows[e["name"]] = (ms + (b - a) / 1e3, n + 1)
    busy, end = 0.0, w0
    for a, b in sorted(spans):
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return (w1 - w0) / 1e3, busy / 1e3, rows


def phase_profile(sponza, renderer) -> None:
    """Where a shadowed Sponza frame's time goes: CUDA-event time of each
    stage (host syncs included) of the cached-map frame without MSAA (the
    environment term and the skydome among them, and the environment
    build, a load-time cost) and of the MSAA stages of the engine's
    default frame, and the card's busy and
    idle time from a torch.profiler trace of PROFILE_FRAMES default frames
    (MSAA, neighbor edge resolve, cached maps), written to
    traces/sponza_trace.json."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vqengine_tpu_torch.ops import msaa, raster, shadow
    from vqengine_tpu_torch.render import graph
    c = renderer.build_frame_constants(sponza.buffers, sponza.cameras[0],
                                       sponza.lights)
    scene = renderer.scene
    maps = renderer.precompute_shadow_maps(c)
    setup, extra = graph.geometry_setup_gbuf(scene, c, W, H)
    binned = raster.bin_triangles(setup, W, H, extra=extra)
    _, _, attrs, _, _ = graph.geometry_pass(scene, c, W, H)
    wn = attrs["wnrm"]
    n = wn / torch.clamp(shadow.norm3(wn), min=1e-9)[..., None]
    mat = graph.material_pass(n, attrs["mrow"], attrs["ids"])
    env = renderer.env
    whole = "whole frame (cached maps, environment)"
    stages = {
        "front end (cull, LOD, transform, setup, attribute pack)":
            lambda: graph.geometry_setup_gbuf(scene, c, W, H),
        "binning (records, sort, segments)":
            lambda: raster.bin_triangles(setup, W, H, extra=extra),
        "K1 raster_gbuf": lambda: raster.rasterize_gbuf(binned, W, H),
        "shadow pass (ESM tests)":
            lambda: graph.shadow_pass(scene, c, attrs["wpos"], n,
                                      shadow_maps=maps),
        "environment term (ibl.environment_illumination: SH9, one specular "
        "pyramid gather, Chebyshev split-sum)":
            lambda: graph.environment_term(c, env, attrs["wpos"], n, mat),
        "skydome (sky_background: quarter-res bilinear taps, 4x upsample)":
            lambda: graph.sky_background(c, env, W, H),
        whole: lambda: renderer.render(c, W, H, shadow_maps=maps),
    }
    t = {name: time_ms(fn, 10) for name, fn in stages.items()}
    rest = t[whole] - sum(v for k, v in t.items() if k != whole)
    for name, v in t.items():
        say(f"[profile] stage {v:8.3f} ms  {name}")
    say(f"[profile] stage {rest:8.3f} ms  tail (G-buffer unpack, K3 material "
        f"fetch, direct-light shading, composite, tonemap)")
    bare = time_ms(lambda: renderer.render(c, W, H, shadow_maps=maps,
                                           env=None), 10)
    say(f"[profile] stage {bare:8.3f} ms  whole frame (cached maps) without "
        f"the environment")
    build = time_ms(lambda: graph.build_environment(sponza.equirect,
                                                    c.world.device), 3, warmup=1)
    say(f"[profile] stage {build:8.3f} ms  environment build "
        f"(build_environment, LUT and fit cached; load time)")
    phase_profile_shadow(scene, c)

    # the MSAA stages of the engine's default frame
    depth, tri_id, attrs_m, mask, cov = graph.geometry_pass(scene, c, W, H,
                                                           msaa=True)
    obj = attrs_m["ids"][..., 0].to(torch.int32)
    cap = graph.msaa_edge_cap(W, H)
    wn = attrs_m["wnrm"]
    vis = graph.shadow_pass(scene, c, attrs_m["wpos"],
                            wn / torch.clamp(shadow.norm3(wn), min=1e-9)[..., None],
                            shadow_maps=maps)
    hdr = torch.rand((H, W, 3), device=depth.device)
    w_sec, sec_rgb = graph._msaa_edge_neighbor(attrs_m, tri_id, depth, mask,
                                               cov, hdr, W, H)
    bg = c.clear_color.expand(hdr.shape)

    def composite():
        covm = cov.mean(dim=0)
        w_pri = torch.clamp(covm - w_sec, min=0.0)
        out = hdr * w_pri[..., None] + sec_rgb + bg * (1.0 - covm)[..., None]
        return torch.where((mask | (covm > 0))[..., None], out, bg)
    whole_m = "whole frame (engine default: MSAA, neighbor, cached maps)"
    mstages = {
        "K1-MSAA raster_gbuf_msaa":
            lambda: raster.rasterize_gbuf(binned, W, H, msaa=True),
        "MSAA edge resolve (detect, ladder, compaction, per-sample re-test)":
            lambda: msaa.resolve_secondary(attrs_m["records"], tri_id, depth,
                                           obj, mask, cov, cap),
        "MSAA neighbor resolve (the above + neighbor color match, scatter)":
            lambda: graph._msaa_edge_neighbor(attrs_m, tri_id, depth, mask,
                                              cov, hdr, W, H),
        "MSAA composite (coverage blend)": composite,
        "MSAA shade resolve (the edge resolve + secondary shade, scatter)":
            lambda: graph._msaa_edge_secondary(scene, c, attrs_m, tri_id, depth,
                                               mask, cov, *vis, W, H, True),
        whole_m: lambda: renderer.render(c, W, H, shadow_maps=maps, msaa=True),
    }
    for name, fn in mstages.items():
        say(f"[profile] stage {time_ms(fn, 10):8.3f} ms  {name}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        renderer.render(c, W, H, shadow_maps=maps, msaa=True)  # warm-up
        torch.cuda.synchronize()
        with record_function("frames"):
            for _ in range(PROFILE_FRAMES):
                renderer.render(c, W, H, shadow_maps=maps, msaa=True)
            torch.cuda.synchronize()
    path = ROOT / "traces" / "sponza_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    window, busy, rows = idle_share(json.loads(path.read_text()), "frames")
    if busy <= 0:
        fail("the profiled frames ran nothing on the card")
    k = sum(n for _, n in rows.values())
    say(f"[profile] trace {path.relative_to(ROOT)}: {PROFILE_FRAMES} default "
        f"(MSAA, cached-map) frames in {window:.3f} ms wall ({window / PROFILE_FRAMES:.3f} "
        f"ms/frame, profiler on); card busy {busy / PROFILE_FRAMES:.3f} "
        f"ms/frame in {k // PROFILE_FRAMES} device ops; idle share "
        f"{1 - busy / window:.4f}")
    ranked = sorted(rows.items(), key=lambda r: -r[1][0])
    hand = [r for r in ranked if any(
        f"::{k}<" in r[0]
        for k in ("palette_kernel", "raster_gbuf_kernel", "raster_vis_kernel"))]
    for name, (ms, n) in ranked[:15] + [r for r in hand if r not in ranked[:15]]:
        say(f"[profile] {ms / PROFILE_FRAMES:8.4f} ms/frame "
            f"x{n // PROFILE_FRAMES:<4} {name[:100]}")


def phase_profile_shadow(scene, c) -> None:
    """CUDA-event time of render_shadow_maps' stages (ESM, the full
    budget; 10 runs each, host syncs included), each summed over the 8
    caster views: front end and binning (shadow.bin_shadow_view: the
    instanced transform, triangle setup, binning with its host sync), K2,
    the point faces' radial depth, the ESM prefilter of the spot maps, the
    point cube and the directional map; then the whole call (10 runs)."""
    from vqengine_tpu_torch.ops import raster, shadow
    from vqengine_tpu_torch.render import graph
    views = caster_views(c)

    def front(vp, size):
        return shadow.bin_shadow_view(scene.positions, scene.item_of_vertex,
                                      c.world, vp, scene.indices, size)
    binned = [(front(vp, size), size) for _, vp, size in views]
    depth = [raster.rasterize(b, size, size)[0] for b, size in binned]
    pc = int(c.point_casters.shape[0])
    sc = int(c.spot_casters.shape[0])
    nf6 = c.point_caster_range.repeat_interleave(6, dim=0)
    faces = depth[sc:sc + 6 * pc]

    def radial():
        return torch.stack([shadow.ndc_depth_to_radial(f, nf6[k, 0], nf6[k, 1])
                            for k, f in enumerate(faces)])
    cubes = radial().reshape(pc, 6, *faces[0].shape)
    spot, dirm = torch.stack(depth[:sc]), depth[-1]

    def prefilter():
        return (shadow.prefilter_esm(spot, pool=1).to(torch.bfloat16),
                shadow.prefilter_esm(cubes, pool=2).to(torch.bfloat16),
                shadow.prefilter_esm(dirm, pool=1).to(torch.bfloat16))
    stages = {
        "shadow front end + binning (bin_shadow_view), 8 views":
            sum(time_ms(lambda: front(vp, size), 10) for _, vp, size in views),
        "shadow K2 raster_vis, 8 views":
            sum(time_ms(lambda: raster.rasterize(b, size, size), 10)
                for b, size in binned),
        "shadow radial depth of the 6 point faces": time_ms(radial, 10),
        "shadow ESM prefilter (spot, point cube, directional) + bf16":
            time_ms(prefilter, 10),
    }
    whole = time_ms(lambda: graph.render_shadow_maps(scene, c), 10)
    for name, v in stages.items():
        say(f"[profile] stage {v:8.3f} ms  {name}")
    say(f"[profile] stage {whole:8.3f} ms  shadow maps (render_shadow_maps, 8 "
        f"views; once per scene with cached maps, in every frame with "
        f"dynamic casters); its stages above, each timed alone with its own "
        f"host syncs, sum to {sum(stages.values()):.3f} ms: in one call the "
        f"host's work on a view overlaps the card's on the one before")


def phase_profile_transparent(st, rt) -> None:
    """CUDA-event time of the transparent pass's stages on the translucent
    Sponza's engine-default frame (10 runs each, host syncs included)."""
    from vqengine_tpu_torch.ops import raster
    from vqengine_tpu_torch.render import graph
    c = rt.build_frame_constants(st.buffers, st.cameras[0], st.lights)
    maps = rt.precompute_shadow_maps(c)
    opaque = graph.geometry_pass(rt.scene, c, W, H, msaa=True)[0]
    setup, extra = graph.geometry_setup_gbuf(rt.scene_t, c, W, H)
    tb = raster.bin_triangles(setup, W, H, extra=extra)
    w1 = (torch.full_like(opaque, -1.0), opaque)
    l1 = raster.rasterize_gbuf(tb, W, H, zbound=w1)
    w2 = (l1[0], opaque)
    l2 = raster.rasterize_gbuf(tb, W, H, zbound=w2)
    layers = [graph.shade_transparent_layer(rt.scene_t, c, *g, W, H, env=rt.env)
              for g in (l1, l2)]
    hdr = torch.rand((H, W, 3), device=opaque.device)
    stages = {
        "transparent front end (cull, LOD, transform, setup, attribute pack)":
            lambda: graph.geometry_setup_gbuf(rt.scene_t, c, W, H),
        "transparent binning (default capacity)":
            lambda: raster.bin_triangles(setup, W, H, extra=extra),
        "K1-bounded raster_gbuf_bounded, layer 1":
            lambda: raster.rasterize_gbuf(tb, W, H, zbound=w1),
        "K1-bounded raster_gbuf_bounded, layer 2":
            lambda: raster.rasterize_gbuf(tb, W, H, zbound=w2),
        "shading, layer 1 (G-buffer unpack, K3 material fetch, environment, "
        "lights)": lambda: graph.shade_transparent_layer(
            rt.scene_t, c, *l1, W, H, env=rt.env),
        "shading, layer 2": lambda: graph.shade_transparent_layer(
            rt.scene_t, c, *l2, W, H, env=rt.env),
        "blend (2 layers, back to front)":
            lambda: graph.blend_layers(hdr, layers),
        "whole transparent pass":
            lambda: graph.transparent_pass(rt.scene_t, c, hdr, opaque, W, H,
                                           env=rt.env),
        "whole frame (translucent Sponza, engine default + transparent pass)":
            lambda: rt.render(c, W, H, shadow_maps=maps, msaa=True),
    }
    for name, fn in stages.items():
        say(f"[profile] stage {time_ms(fn, 10):8.3f} ms  {name}")


def check_imports() -> None:
    bad = sorted(m for m in sys.modules if m in ("jax", "vqengine_tpu")
                 or m.startswith(("jax.", "vqengine_tpu.")))
    if bad:
        fail(f"the port imported {bad}")


def main() -> None:
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    sponza, renderer = load_sponza(dev)
    st, rt = load_sponza(dev, translucent=True)
    k3 = phase_palette(dev, sponza, renderer)
    k1, k1_msaa = phase_raster(dev, sponza, renderer)
    k1_bounded, k1_msaa_bounded = phase_raster_bounded(dev, sponza, renderer,
                                                       st, rt)
    phase_reject_probe(dev)
    k2, k2_msaa4 = phase_vis(dev, sponza, renderer)
    env_cpu = phase_environment(dev, card, sponza)
    phase_env_card_vs_cpu(dev, env_cpu)
    phase_goldens(dev)
    phase_shadow_card_vs_cpu(dev)
    phase_msaa_card_vs_cpu(dev)
    phase_transparent_card_vs_cpu(dev)
    launches = phase_main_path(dev, card, sponza, renderer)
    lt = phase_transparent_path(card, st, rt)
    launches = {k: launches[k] + lt[k] for k in launches}
    if "--profile" in sys.argv[1:]:
        # timed before the traced frames, as phase_profile times its stages
        phase_profile_transparent(st, rt)
        phase_profile(sponza, renderer)
    check_imports()
    kernels = [
        dict(name="palette", route="cuda",
             source="vqengine_tpu_torch/csrc/palette.cu",
             replaces="vqengine_tpu/ops/palette.py:24",
             launches=launches["palette"], **k3),
        dict(name="raster_gbuf", route="cuda",
             source="vqengine_tpu_torch/csrc/raster_gbuf.cu",
             replaces="vqengine_tpu/ops/raster.py:914",
             launches=launches["raster_gbuf"], **k1),
        dict(name="raster_vis", route="cuda",
             source="vqengine_tpu_torch/csrc/raster_vis.cu",
             replaces="vqengine_tpu/ops/raster.py:693",
             launches=launches["raster_vis"], **k2),
        dict(name="raster_gbuf_msaa", route="cuda",
             source="vqengine_tpu_torch/csrc/raster_gbuf.cu",
             replaces="vqengine_tpu/ops/raster.py:1134",
             launches=launches["raster_gbuf_msaa"], **k1_msaa),
        dict(name="raster_vis_msaa4", route="cuda",
             source="vqengine_tpu_torch/csrc/raster_vis.cu",
             replaces="vqengine_tpu/ops/raster.py:811",
             launches=launches["raster_vis_msaa4"], **k2_msaa4),
        dict(name="raster_gbuf_bounded", route="cuda",
             source="vqengine_tpu_torch/csrc/raster_gbuf.cu",
             replaces="vqengine_tpu/ops/raster.py:1033",
             launches=launches["raster_gbuf_bounded"], **k1_bounded),
        dict(name="raster_gbuf_msaa_bounded", route="cuda",
             source="vqengine_tpu_torch/csrc/raster_gbuf.cu",
             replaces="vqengine_tpu/ops/raster.py:1004",
             launches=launches["raster_gbuf_msaa_bounded"], **k1_msaa_bounded),
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
