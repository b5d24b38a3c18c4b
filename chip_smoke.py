"""Drive the PyTorch/CUDA port (vqengine_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; builds the kernels
    python3 chip_smoke.py --profile  # also stage breakdowns and a trace

Phases, each printing its own lines; any failure exits non-zero before
the final line:
  1. device: the card's name and power limit, torch/CUDA versions;
  2. build: nvcc build of vqengine_tpu_torch/csrc/*.cu (ptxas lines);
  2b. the host library (`[native]` lines; utils/native.py, built with the
     host's g++ from csrc/vq_native.cpp): its build seconds; seeded 512^2
     RGBA PNGs of each filter 0-4 and a paletted one, read_png against
     read_png_plain (bitwise); read_png of a 4096^2 RGBA Paeth PNG;
     generate_mips of a 2048^2 x 4 f32 image against the plain mip_box's
     chain (bitwise); 8 2048^2 PNGs through TextureManager's 4 workers
     against one thread. Host times, each line with the card's name and
     power limit and the host CPU;
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
     CPU; the goldens include default_ssao and default_ssr;
  8b. the engine's default passes on the Default scene at 192x108, card
     against CPU (`[post]` lines): each SSAO preset, and the engine's
     default flags over two frames whose camera turns and whose SSR
     history carries, motion on the static and on the palette path (one
     more K3 launch a frame); ldr, ao, motion and ssr_history within their
     bars, every SSAO tap fetch, SSR march cell and SSR hit texel equal;
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
     launches per frame), the layers' pixel counts of the first frame;
     (g) the engine's full default frame (settings.render_flags of
     FGraphicsSettings: MSAA, SSAO "medium", motion vectors, SSR): the
     precompute, then the 16-frame sweep with each frame's prev_view_proj
     the one before's and the SSR history carried, then the same frames
     without SSR and without SSAO; (h) bench.py's textured Sponza stress
     frame (scene_load.sponza_stress: the .glb colonnade, 220 clutter
     items, ~278k triangles, five 512^2 maps as quad and pair rows with
     combined aux maps; 5 spot, 5 point and 1 directional casters; a
     512x256 procedural sky) at 1920x1080 on its own renderer: the host
     time of building the scene and its textures, the precompute of its 36
     caster views (timed), the pair capacity from probe_pair_demand over
     the bench camera's sweep; before the timed runs, each K2 launch of
     the precompute and each K1 and K3 launch of one frame with the walk
     held against its plain version on those same inputs (checked_launches:
     ids, depths, coverage and rows bitwise, the G-buffer within GBUF_TOL;
     `[stress]` lines, one per launch); then 16 frames of the engine's default
     flags with the textures and the aniso-8 walk (tex_aniso and
     tex_aniso_demand per frame) and the same 16 frames with aniso_taps=0
     (the engine's own setting).
     Overflow 0 and finite output; ms/frame, peak memory, launches,
     saturation; `[time]` lines give each phase's finish time.
  8c. the texture slice at 192x108 and 96x54, card against CPU
     (`[texture]` lines): the textured_quad golden's scene (dense aniso 2),
     the gltf_roundtrip golden's .glb still life (stochastic trilinear) and
     goldens.atrium_scene (pair rows, combined aux maps, the aniso-8 walk
     on a grazing floor; its slot-3 alpha mask peeled through K1-bounded,
     its textured glass layers, without MSAA, with MSAA, and the "shade"
     resolve): tri_id equal, ldr within ENTRY_TOL, the texture telemetry
     equal and every tap's mip level and row equal; each K1-bounded launch
     held bitwise against its plain version. The goldens (8) include
     textured_quad, gltf_roundtrip and sponza.
  8d. tessellation (`[tess]` lines): the amplifiers of the full Terrain
     (576 displaced quad patches, from both its cameras) and of StressTest's
     TessRock (12 tri patches) on the card and the CPU, every output, the
     snapped parameters, the collapsed set and each displacement texel
     equal; the geomorph front end of four build_terrain_patch tiles at
     1920x1080, its K3 launches (the [N, 17] morph rows among them) held
     against the plain version and its setup against the CPU's; the
     reduced StressTest (24 animated objects, the TessRock) over two
     engine ticks and the terrain golden's frame, card vs CPU (the terrain
     PNG predates the quad-patch Terrain, goldens.STALE_PNG: its scores are
     printed, the card is held against the CPU);
  9b. main paths (i) and (j) through engine/frame_loop.FrameLoop with the
     engine's default flags, the environment and skydome: (i) StressTest
     (649,412 triangles, 469 items) as the engine runs it: the hook
     advances at 1/60, the shadow maps render in every frame (8 K2 views),
     the 384 moved objects take motion's palette path, the TessRock
     amplifies; (j) Terrain: the directional map precomputed in the first
     tick, a 16-frame yaw sweep around camera 0 and one frame from camera 1
     (top-down). Each holds every K1-MSAA, K2 and K3 launch of one tick
     against its plain version first (`[tess] (i)`, `[tess] (j)` lines),
     then 16 timed ticks: ms/frame, launches per frame, amplified and live
     triangles, peak memory, and the tick's constants step alone on the
     host clock (outside the window); (j) also times its sweep with the
     constants built before the window, as (g) is timed.
  9c. the post tail card vs CPU (`[post]` lines after 8b's): CAS, FSR1
     (96x54 -> 192x108, EASU's taps and direction mask recorded on both
     sides), the ST.2084 tonemap in both color spaces, every draw mode,
     the magnifier (its taps recorded) and the outline (its rim) on a
     Default frame, each within POST_TOL; then FSR1 from 1440x810 to
     1920x1080 and CAS at 1920x1080 timed (stage rows); the goldens (8)
     include default_hdr10.
  9d. main path (k), the engine shell: `python -m vqengine_tpu_torch -Test
     -TestFrames=16` in-process (__main__.main) on Sponza at 1920x1080
     with the engine's defaults (HDR on: the HDR10 dump), then the
     Default level with RenderScale 0.75 (FSR1 on every tick) and a
     960x540 render context (engine.run); before each run an engine set up
     the same way holds every launch of its first tick against the plain
     version and its second tick against FrameLoop's frame. Exit code 0,
     the files written, the engine's logged ms/frame, launches and peak
     memory (`[engine] (k)`, `[main] (k)` lines).
  9e. multi-GPU (`[multigpu]` lines; parallel/multichip.py, launched by
     parallel/launch.py): (l) the engine's default frame (g), sharded:
     Sponza 1920x1080 on dp 1 x sp 3 gloo ranks sharing cuda:0 (spawned
     processes; each exchange copies its slab to the host and back), each
     rank building its scene, environment and ESM maps (bitwise equal across
     the ranks and to the single-card renderer's; each rank's 8 K2
     precompute launches and every launch of its first frame held against
     the plain version), two frames with the SSR history carried, ML_FRAMES
     timed frames (each rank's ms/frame by CUDA events and peak memory; the
     ranks time-slice one card, no scaling figure), two frames with SSAO and
     SSR off; the gathered frames against the single-card frames of the
     same cameras at the reference's bars (tests/test_multichip.py: mean
     3e-3 and 99th percentile 0.05 with SSAO and SSR; 0.1% of the pixels
     more than 1e-3 apart and a maximum below 0.26 without), overflow 0 in
     every band; the translucent Sponza of (f) the same way, two frames
     with SSAO and SSR off (each band's two K1-bounded layers held against
     the plain version, the frames at the bars without SSAO and SSR); a
     band's binning, MSAA raster and edge resolve timed alone on the card,
     band by band; then entry.dryrun_multigpu's scene at 128x64 on dp 2 x
     sp 2, gloo ranks on the card against gloo ranks on the CPU (ldr, AO,
     motion and the SSR history within ENTRY_TOL, AO_TOL, MOTION_TOL,
     HIST_TOL); NCCL with one rank on cuda:0; and with four cards Sponza on
     dp 2 x sp 2 over NCCL, one rank per card, each dp row its own views
     (else a line says it was not run). The ranks' launches join the kernel counts; the phase ends with
     its `[time] multi-GPU (l)` line.
`--profile` adds stage rows (among them the environment term, the
skydome, the environment build, SSAO, motion vectors, the SSR trace,
denoise and composite, and the stress frame's material pass with and
without textures, each amplifier alone, (i)'s maps in the frame and
whole ticks of (i) and (j)) and traces the default frame of path (e) (no
SSAO, SSR or motion), the full default frame of (g), the stress frame of
(h), ticks of (i) and (j) and (k)'s engine ticks on Sponza (device ops
and idle share of each).
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import platform
import subprocess
import sys
import time
import zlib
from pathlib import Path

import torch

# every launch held against its plain version (K1's G-buffer within
# GBUF_TOL, all else bitwise); a difference raises
from vqengine_tpu_torch.ops.launch_check import (GBUF_TOL, bitwise_equal,
                                                 checked_launches)

W, H = 1920, 1080
N_FRAMES = 16
N_SIDE_FRAMES = 4       # maps in the frame; PCF
N_UNSHADOWED = 8        # shadows off
PROFILE_FRAMES = 3
SMALL_W, SMALL_H = 192, 108
SMALL_DIMS = (64, 64, 64)
ENTRY_TOL = 3e-4  # card vs CPU ldr: the multichip bar of the reference
# card vs CPU, the engine's default passes: the AO's blur and upsample
# weights go through exp, which the card rounds otherwise; the motion
# vectors' palette path inverts each item's 4x4 world matrix (cuSOLVER and
# LAPACK round otherwise); the SSR history carries both into radiance
AO_TOL = 1e-5
MOTION_TOL = 2e-5
HIST_TOL = 1e-4
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
NATIVE_LOADS = 8        # 2048^2 PNGs through TextureManager's workers


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


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (model name, vendor, family
    and model of its first processor) and the cores this process sees."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            if not key.strip() and info:
                break
            info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name', platform.machine())} "
            f"({info.get('vendor_id', '?')} family {info.get('cpu family', '?')} "
            f"model {info.get('model', '?')}), {os.cpu_count()} cores")


def host_ms(fn, iters: int) -> float:
    """Mean host ms per call of iters calls after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def same_bytes(a, b) -> bool:
    """Two numpy arrays of one dtype and shape, bit for bit."""
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def seeded_rgba(side: int, seed: int):
    """A side x side RGBA uint8 texture from a seed: two gradients that
    wrap, plus 3 bits of noise per byte."""
    import numpy as np
    ramp = np.arange(side, dtype=np.int32)
    base = (ramp[None, :, None] * np.int32([1, 2, 3, 0])
            + ramp[:, None, None] * np.int32([3, 1, 0, 2])) >> 3
    noise = np.random.default_rng(seed).integers(0, 8, base.shape, np.uint8)
    return base.astype(np.uint8) + noise


def phase_native(card: str) -> None:
    """The host library (utils/native.py, csrc/vq_native.cpp), host times
    beside the card and the host CPU: its build; seeded 512^2 RGBA PNGs of
    each filter (0-4) and a paletted one (filters mixed row by row), read_png
    against read_png_plain, bitwise; read_png of a 4096^2 RGBA Paeth PNG;
    generate_mips of a 2048^2 x 4 f32 image against the plain mip_box's
    chain, bitwise; NATIVE_LOADS seeded 2048^2 PNGs (crops of the 4096^2
    image at seeded offsets) through TextureManager.create_from_file +
    wait_all on its 4 workers against the same work one after another on
    one thread. The files deflate with zlib.Z_RLE on a thread pool while
    the plain decodes run; every native time is taken after the pool has
    finished."""
    import concurrent.futures as futures
    import tempfile

    import numpy as np

    from vqengine_tpu_torch.scene import texture_manager as tm
    from vqengine_tpu_torch.utils import image_io, native
    where = f"host ms; {card}; host {host_cpu()}"
    t0 = time.perf_counter()
    native.library()
    say(f"[native] {native.SOURCE.name}: build {native.build_seconds:.3f} s "
        f"({native.compiler()} {' '.join(native.CXX_FLAGS)}), load "
        f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (256, 3), np.uint8)
    jobs = {f"filter {f}": (seeded_rgba(512, f), (f,), None) for f in range(5)}
    jobs["paletted, filters 0-4 by row"] = (
        rng.integers(0, 256, (512, 512), np.uint8), (0, 1, 2, 3, 4), palette)
    small = list(jobs)
    big = "4096^2 Paeth"
    jobs[big] = (seeded_rgba(4096, 5), (4,), None)
    for i, (y, x) in enumerate(rng.integers(0, 2048, (NATIVE_LOADS, 2))):
        jobs[f"load {i}"] = (jobs[big][0][y:y + 2048, x:x + 2048],
                             (0, 1, 2, 3, 4), None)
    with tempfile.TemporaryDirectory() as tmp, \
            futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        def encode(i, k):
            img, f, pal = jobs[k]
            path = Path(tmp, f"{i}.png")
            path.write_bytes(image_io.encode_png(img, f, palette=pal,
                                                 strategy=zlib.Z_RLE))
            return path
        # zlib.compress releases the GIL: the files encode in parallel
        paths = {k: pool.submit(encode, i, k) for i, k in enumerate(jobs)}
        plain_ms = {}
        for k in small:
            img, _, pal = jobs[k]
            paths[k] = paths[k].result()
            t1 = time.perf_counter()
            plain = image_io.read_png_plain(paths[k])
            plain_ms[k] = (time.perf_counter() - t1) * 1e3
            if not same_bytes(plain, img if pal is None else pal[img]):
                fail(f"[native] 512^2 {k}: read_png_plain differs from the "
                     f"image encoded")
            jobs[k] = plain
        paths = {k: p if isinstance(p, Path) else p.result()
                 for k, p in paths.items()}
        for k in small:
            if not same_bytes(image_io.read_png(paths[k]), jobs[k]):
                fail(f"[native] 512^2 {k}: read_png differs from read_png_plain")
            ms = host_ms(lambda: image_io.read_png(paths[k]), 5)
            inflate = host_ms(lambda: image_io.parse_png(paths[k].read_bytes()), 5)
            say(f"[native] 512^2 {k}: read_png {ms:.3f} ms (of which read and "
                f"inflate {inflate:.3f}), read_png_plain {plain_ms[k]:.1f} ms, "
                f"bitwise equal ({where})")
        t1 = time.perf_counter()
        got = image_io.read_png(paths[big])
        ms = (time.perf_counter() - t1) * 1e3
        if not same_bytes(got, jobs[big][0]):
            fail(f"[native] {big}: read_png differs from the image encoded")
        inflate = host_ms(lambda: image_io.parse_png(paths[big].read_bytes()), 1)
        say(f"[native] {big} RGBA ({paths[big].stat().st_size} bytes): "
            f"read_png {ms:.3f} ms (of which read and inflate {inflate:.3f}), "
            f"{got.nbytes / ms / 1e3:.1f} MB/s decoded, equal to the image "
            f"encoded ({where})")

        img = np.random.default_rng(3).random((2048, 2048, 4)).astype(np.float32)

        def plain_mips():
            mips = [img]
            while min(mips[-1].shape[:2]) > 1:
                mips.append(tm.mip_box(mips[-1]))
            return mips
        got, plain = tm.generate_mips(img), plain_mips()
        if len(got) != len(plain) or not all(map(same_bytes, got, plain)):
            fail("[native] generate_mips differs from the plain mip_box's chain")
        say(f"[native] generate_mips 2048^2 x 4 f32 ({len(got)} levels): "
            f"native {host_ms(lambda: tm.generate_mips(img), 3):.3f} ms, numpy "
            f"{host_ms(plain_mips, 3):.3f} ms, bitwise equal level by level "
            f"({where})")

        loads = [paths[f"load {i}"] for i in range(NATIVE_LOADS)]
        m = tm.TextureManager(size=512, num_workers=4)
        t1 = time.perf_counter()
        ids = [m.create_from_file(q) for q in loads]
        m.wait_all()
        t_workers = (time.perf_counter() - t1) * 1e3
        m._pool.shutdown()
        t1 = time.perf_counter()
        want = [tm._resize_box(tm._to_rgba_f32(image_io.read_png(q)), 512)
                for q in loads]
        t_serial = (time.perf_counter() - t1) * 1e3
        if not all(map(same_bytes, [m._images[i] for i in ids], want)):
            fail("[native] TextureManager's loads differ from the serial loads")
        say(f"[native] {NATIVE_LOADS} 2048^2 RGBA PNGs (filters 0-4 by row) to "
            f"512^2 textures: TextureManager.create_from_file + wait_all on 4 "
            f"workers {t_workers:.1f} ms, the same on one thread "
            f"{t_serial:.1f} ms ({t_serial / t_workers:.2f}x), equal ({where})")


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
    # the plain version ran just above: that call is its warm-up
    t_p = time_ms(lambda: raster.rasterize_gbuf_plain(binned, W, H), 1,
                  warmup=0)
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
                  1, warmup=0)
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
            tb, W, H, msaa=msaa, zbound=first), 1, warmup=0)
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
                               1, warmup=0)
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
                      1, warmup=0)
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
    from vqengine_tpu_torch.engine.goldens import (SCENES, STALE_PNG, TEXTURED,
                                                    golden_scores, render_golden)
    from vqengine_tpu_torch.entry import entry
    for golden in (*(g for g in SCENES if g not in STALE_PNG), *TEXTURED):
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


@contextlib.contextmanager
def recorded_selections(rec: dict):
    """While the context lasts, record every pyramid fetch's flat index (the
    SSAO taps' level and texel, the SSR march's level and cell per step:
    rec["fetch"]) and every SSR trace's final texels (rec["texel"], from a
    second trace of a colour whose red channel is each pixel's index)."""
    from vqengine_tpu_torch.ops import ssao, ssr
    saved = (ssao._gather, ssr._gather, ssr.trace_reflections)
    gather, trace = ssao._gather, ssr.trace_reflections

    def rec_gather(flat, idx):
        rec["fetch"].append(idx.cpu())
        return gather(flat, idx)

    def rec_trace(color, *a, **k):
        h, w = color.shape[:2]
        enc = torch.zeros_like(color)
        enc[..., 0] = torch.arange(h * w, dtype=torch.float32,
                                   device=color.device).reshape(h, w)
        rec["texel"].append(trace(enc, *a, **k)[0][..., 0].cpu())
        return trace(color, *a, **k)
    ssao._gather = ssr._gather = rec_gather
    ssr.trace_reflections = rec_trace
    try:
        yield rec
    finally:
        ssao._gather, ssr._gather, ssr.trace_reflections = saved


def selection_mismatches(a: dict, b: dict) -> dict:
    """{"fetch": mismatched indices, "texel": mismatched texels} between two
    recordings of the same frames."""
    out = {}
    for k in ("fetch", "texel"):
        if len(a[k]) != len(b[k]):
            fail(f"{k}: {len(a[k])} recordings on the card, {len(b[k])} on the CPU")
        out[k] = sum(int((x != y).sum()) for x, y in zip(a[k], b[k]))
    return out


def post_differences(outs: list) -> dict:
    """max |card - CPU| of ldr, ao, motion and ssr_history where present."""
    return {k: float((outs[0][k].cpu() - outs[1][k].cpu()).abs().max())
            for k in ("ldr", "ao", "motion", "ssr_history") if k in outs[0]}


def check_post(label: str, diff: dict, sel: dict) -> None:
    bars = {"ldr": ENTRY_TOL, "ao": AO_TOL, "motion": MOTION_TOL,
            "ssr_history": HIST_TOL}
    say(f"[post] {label}, card vs CPU: max |diff| "
        f"{ {k: f'{v:.3g}' for k, v in diff.items()} } (bars "
        f"{ {k: bars[k] for k in diff} }); mismatched pyramid fetches "
        f"{sel['fetch']}, mismatched SSR hit texels {sel['texel']}")
    if any(not v <= bars[k] for k, v in diff.items()) or sel["fetch"] or sel["texel"]:
        fail(f"{label} card vs CPU: {diff}, {sel}")


def phase_post_card_vs_cpu(dev, env_cpu) -> None:
    """The engine's default passes on the Default scene at 192x108, on the
    card and on the CPU with the same environment tables (the CPU's build of
    Sponza's sky) and cached 64^2 ESM maps: each SSAO preset (no MSAA, no
    environment);
    then the engine's default flags (render_flags of FGraphicsSettings:
    MSAA, SSAO "medium", motion vectors, SSR) over two frames whose camera
    turns and whose SSR history carries, with motion on the static path
    and on the palette path (K3's [N, 12] rows: one more launch a frame).
    ldr, ao, motion and ssr_history within their bars; every SSAO tap's and
    SSR step's pyramid fetch and every SSR hit texel equal."""
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    from vqengine_tpu_torch.ops import _backend, ssao
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    s = load_scene("Default", SMALL_W, SMALL_H)
    cam = s.cameras[0]
    sides = []
    for d in (dev, torch.device("cpu")):
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        r.env = env_cpu.to(d)
        c = r.build_frame_constants(s.buffers, cam, s.lights)
        sides.append((r, r.precompute_shadow_maps(c, SMALL_DIMS)))
    common = dict(shadow_dims=SMALL_DIMS)

    def render_both(consts_kw: dict, flags: dict, hist=(None, None)):
        outs, recs, k3 = [], [], 0
        for (r, maps), h in zip(sides, hist):
            c = r.build_frame_constants(s.buffers, cam, s.lights, **consts_kw)
            rec = {"fetch": [], "texel": []}
            before = _backend.launches["palette"]
            with recorded_selections(rec):
                outs.append(r.render(c, SMALL_W, SMALL_H, shadow_maps=maps,
                                     ssr_history=h, **common, **flags))
            k3 = k3 or _backend.launches["palette"] - before
            recs.append(rec)
        return outs, selection_mismatches(*recs), k3, recs[0]

    for q in ssao.PRESETS:       # the AO needs no environment
        outs, sel, _, rec = render_both({}, dict(enable_ssao=True, ssao_quality=q,
                                                 env=None))
        check_post(f"Default {SMALL_W}x{SMALL_H}, SSAO {q!r} ({len(rec['fetch'])} "
                   f"tap fetches)", post_differences(outs), sel)
    flags = render_flags(FGraphicsSettings())
    base_yaw = cam.yaw
    for ids in ((), None):
        hist, prev = (None, None), None
        for f, yaw in enumerate((0.0, 3.0)):
            cam.yaw = base_yaw + yaw
            outs, sel, k3, rec = render_both(dict(prev_view_proj=prev),
                                             dict(flags, dynamic_item_ids=ids), hist)
            path = "static" if ids == () else "palette (K3)"
            check_post(f"Default {SMALL_W}x{SMALL_H}, engine default (MSAA, SSAO, "
                       f"SSR, motion on the {path} path), frame {f}; K3 launches "
                       f"{k3}; {len(rec['texel'])} traces", post_differences(outs), sel)
            if k3 != (4 if ids == () else 5):
                fail(f"{path} motion: K3 launched {k3} times in a frame")
            # the first frame's camera stands still: exactly 0 on the
            # static path, the inverse's ulps on the palette path
            moving = float(outs[0]["motion"].abs().max())
            if not (moving > 1e-3 if f else moving <= (0.0 if ids == () else MOTION_TOL)):
                fail(f"{path} motion, frame {f}: max |motion| {moving}")
            hist = tuple(o["ssr_history"] for o in outs)
            prev = sides[1][0].build_frame_constants(
                s.buffers, cam, s.lights).view_proj.numpy()
    cam.yaw = base_yaw


POST_TOL = 1e-6   # card vs CPU, the post tail on the same inputs


def phase_post_tail_card_vs_cpu(dev) -> None:
    """The post tail card vs CPU (`[post]` lines) on the same inputs: a
    Default frame rendered on the CPU at 192x108 (SSAO, motion against a
    turned camera, 64^2 ESM maps) and at 96x54. CAS on its ldr, FSR1 from
    the 96x54 ldr to 192x108 (EASU's integer taps and direction mask
    recorded on both sides), the ST.2084 tonemap of its hdr (Rec709 at
    1000 nits, Rec2020 at 200), every draw mode (the engine's depth, AO,
    motion and object ids; stand-ins from the frame for the channels the
    engine does not pass), the magnifier at the center and off a corner
    (its source texels recorded) and the outline of the object at the
    center (its rim recorded): each within POST_TOL of the CPU, every
    recorded selection equal. Then FSR1 from 1440x810 to 1920x1080 and CAS
    at 1920x1080 on the card, timed (stage rows)."""
    import numpy as np
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.ops import colorspace as cs
    from vqengine_tpu_torch.ops import ffx, postprocess as pp
    from vqengine_tpu_torch.ops import visualization as viz
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    cpu = torch.device("cpu")
    frames = {}
    for w, h in ((SMALL_W, SMALL_H), (SMALL_W // 2, SMALL_H // 2)):
        s = load_scene("Default", w, h)
        r = VQRendererTorch(cpu)
        r.load_scene(s.buffers)
        cam = s.cameras[0]
        cam.yaw -= 3.0
        prev = cam.view_projection()
        cam.yaw += 3.0
        c = r.build_frame_constants(s.buffers, cam, s.lights,
                                    prev_view_proj=np.asarray(prev))
        frames[w] = r.render(c, w, h, shadow_dims=SMALL_DIMS, enable_ssao=True,
                             enable_motion_vectors=True)
    f = frames[SMALL_W]
    ldr, hdr = f["ldr"], f["hdr"]
    oid = f["object_id"]
    gbuf = dict(depth=f["depth"], ao=f["ao"], motion=f["motion"], object_id=oid,
                normals=ldr * 2.0 - 1.0, roughness=ldr[..., 0],
                metalness=ldr[..., 1], albedo=ldr)
    selected = int(oid[SMALL_H // 2, SMALL_W // 2])
    checks = {
        "CAS 0.5": lambda d, rec: ffx.cas(ldr.to(d), 0.5),
        f"FSR1 {SMALL_W // 2}x{SMALL_H // 2} -> {SMALL_W}x{SMALL_H}":
            lambda d, rec: ffx.fsr1(frames[SMALL_W // 2]["ldr"].to(d), SMALL_H,
                                    SMALL_W, record=rec),
        "ST.2084, Rec709 content, 1000 nits":
            lambda d, rec: pp.tonemap(hdr.to(d), cs.DISPLAY_CURVE_ST2084,
                                      display_reference_brightness=1000.0),
        "ST.2084, Rec2020 content, 200 nits":
            lambda d, rec: pp.tonemap(hdr.to(d), cs.DISPLAY_CURVE_ST2084,
                                      cs.COLOR_SPACE_REC2020, 200.0),
        "magnifier": lambda d, rec: viz.magnifier(ldr.to(d), record=rec),
        "magnifier off a corner":
            lambda d, rec: viz.magnifier(ldr.to(d), (0.08, 0.85), 0.4, 2.5,
                                         border_px=3, record=rec),
        f"outline of object {selected}":
            lambda d, rec: viz.outline(ldr.to(d), oid.to(d), selected, record=rec),
    }
    for mode in range(9):
        checks[f"draw mode {mode}"] = (
            lambda d, rec, m=mode: viz.visualize(
                m, ldr.to(d), **{k: v.to(d) for k, v in gbuf.items()}))
    for label, fn in checks.items():
        outs, recs = [], []
        for d in (dev, cpu):
            rec = {}
            outs.append(fn(d, rec).cpu())
            recs.append({k: v.cpu() for k, v in rec.items()})
        diff = float((outs[0] - outs[1]).abs().max())
        same = int((outs[0] != outs[1]).sum())
        sel = {k: int((recs[0][k] != recs[1][k]).sum()) for k in recs[0]
               if recs[0][k].dtype in (torch.bool, torch.int32, torch.int64)}
        say(f"[post] {label}, card vs CPU: max |diff| {diff} ({same} of "
            f"{outs[0].numel()} values differ; bar {POST_TOL}); mismatched "
            f"selections {sel}")
        if not diff <= POST_TOL or any(sel.values()):
            fail(f"[post] {label}: card vs CPU {diff}, selections {sel}")
    # 1080p on the card: FSR1 from RenderScale 0.75, CAS at the display size
    src = torch.nn.functional.interpolate(
        ldr.to(dev).permute(2, 0, 1)[None], size=(810, 1440), mode="bilinear",
        align_corners=False)[0].permute(1, 2, 0).contiguous()
    full = ffx.fsr1(src, H, W)
    tag = "[profile] stage" if "--profile" in sys.argv[1:] else "[post] stage"
    for name, fn in (("FSR1 (EASU + RCAS) 1440x810 -> 1920x1080",
                      lambda: ffx.fsr1(src, H, W)),
                     ("CAS 1920x1080", lambda: ffx.cas(full, 0.5))):
        say(f"{tag} {time_ms(fn, 10):8.3f} ms  {name}")


@contextlib.contextmanager
def recorded_taps(rec: list):
    """While the context lasts, every packed texture tap's level and row
    index (ops/texture._tap_rows) is appended to rec, in call order."""
    from vqengine_tpu_torch.ops import texture
    rows = texture._tap_rows

    def rec_rows(pt, tex_id, uv, lodi, pair):
        out = rows(pt, tex_id, uv, lodi, pair)
        rec.append((lodi.long().cpu(), out[0].cpu()))
        return out
    texture._tap_rows = rec_rows
    try:
        yield rec
    finally:
        texture._tap_rows = rows


@contextlib.contextmanager
def recorded_bounded(calls: list):
    """While the context lasts, the inputs of every K1-bounded launch on a
    CUDA tensor (binned, width, height, msaa, zbound) are appended to
    calls."""
    from vqengine_tpu_torch.ops import raster
    k1 = raster.rasterize_gbuf

    def rec(binned, width, height, msaa=False, zbound=None):
        if zbound is not None and zbound[0].is_cuda:
            calls.append((binned, width, height, msaa, zbound))
        return k1(binned, width, height, msaa=msaa, zbound=zbound)
    raster.rasterize_gbuf = rec
    try:
        yield calls
    finally:
        raster.rasterize_gbuf = k1


def report_checked(label: str, found: dict, want: dict,
                   tag: str = "[stress] (h)") -> None:
    """Print the launches checked_launches held against their plain
    versions, each line starting with tag and the label; fail unless each
    kernel of want was checked exactly that many times."""
    for name, n in want.items():
        if found.get(name, (0,))[0] != n:
            fail(f"{tag} {label}: {found.get(name, (0,))[0]} {name} launches "
                 f"checked, expected {n}")
    for name, (n, err, whats) in sorted(found.items()):
        say(f"{tag} {label}: {name}, {n} launches, each held against "
            f"its plain version on the same inputs (ids, depths, coverage and "
            f"rows bitwise; G-buffer max |diff| {err}):")
        for what in whats:
            say(f"{tag.split()[0]}     {name} {what}")


def texture_frames(d, width: int, height: int) -> dict:
    """The texture slice's frames at width x height on device d, without
    shadows or environment: the textured_quad golden's scene (quad-packed
    maps, dense aniso 2), the gltf_roundtrip golden's .glb still life
    (stochastic trilinear), and goldens.atrium_scene (pair rows with the
    combined aux maps and the aniso-8 walk on a grazing floor; then with
    its slot-3 alpha mask (the peel, K1-bounded) and its textured glass
    layer, without MSAA, with MSAA, and with the "shade" resolve) ->
    {label: (outputs on the host, taps, K1-bounded inputs)}."""
    import numpy as np

    from vqengine_tpu_torch.engine import goldens
    from vqengine_tpu_torch.ops import texture
    from vqengine_tpu_torch.render import graph
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    from vqengine_tpu_torch.render.scene_buffers import split_transparent
    from vqengine_tpu_torch.scene.camera import Camera, FCameraParameters
    from vqengine_tpu_torch.scene.light import ELightType, Light
    from vqengine_tpu_torch.utils import math3d as m3
    r = VQRendererTorch(d)
    p = FCameraParameters()
    p.position = np.array([0, 2.0, -5.0], np.float32)
    p.pitch_deg = 12.0
    view = (Camera(p, aspect=width / height),
            [Light(type=ELightType.DIRECTIONAL, brightness=1.5,
                   rotation=m3.quat_from_euler_xyz_degrees(50, 0, 20))])
    buffers, levels = goldens.textured_quad_scene()
    quad = (buffers, None, texture.pack_texture_quads(levels, d), *view)
    gb, gt = goldens.gltf_roundtrip_scene(d)
    gltf = (gb, None, gt, *view)
    ab, at, cam, lights = goldens.atrium_scene(d, aspect=width / height)
    opaque, transp = split_transparent(ab)
    atrium = (opaque, transp, at, cam, lights)
    runs = [("textured_quad, dense aniso 2", quad, dict(aniso_taps=2)),
            ("gltf_roundtrip, stochastic trilinear", gltf, dict(aniso_taps=0)),
            ("atrium, pair rows + aniso 8", atrium,
             dict(aniso_taps=8, transparent=False)),
            ("atrium, alpha peel + textured glass", atrium,
             dict(aniso_taps=8, enable_alpha_mask=True)),
            ("atrium, alpha peel + glass, MSAA", atrium,
             dict(aniso_taps=8, enable_alpha_mask=True, msaa=True)),
            ("atrium, alpha peel + glass, MSAA shade resolve", atrium,
             dict(aniso_taps=8, enable_alpha_mask=True, msaa=True,
                  msaa_edge_resolve="shade"))]
    out = {}
    for label, (b, bt, tex, cam, lights), flags in runs:
        flags = dict(flags)
        with_glass = flags.pop("transparent", True)
        c = r.build_frame_constants(b, cam, lights)
        taps, bounded = [], []
        with recorded_taps(taps), recorded_bounded(bounded):
            o = graph.render_forward(
                graph.upload_scene(b, d), c, width, height, enable_shadows=False,
                textures=tex, slots_used=graph.slots_used_of(b.materials),
                scene_transparent=(graph.upload_scene(bt, d)
                                   if bt is not None and with_glass else None),
                **flags)
        out[label] = ({k: (v.cpu() if isinstance(v, torch.Tensor) else
                           {s: t.cpu() for s, t in v.items()})
                       for k, v in o.items() if k in ("ldr", "tri_id", "saturation")},
                      taps, bounded)
    return out


def phase_texture_card_vs_cpu(dev) -> None:
    """The texture slice's frames (texture_frames) at 192x108 and 96x54 on
    the card and on the CPU: tri_id equal, ldr within ENTRY_TOL, the
    texture telemetry equal, every tap's mip level and row equal; each
    K1-bounded launch of the alpha peel and the glass layers held bitwise
    against its plain version. At 96x54 the atrium's anisotropic pixels
    exceed the walk's 512 lanes and the ladder walks a rung above 1.3; at
    192x108 (648 lanes) even its top rung overflows and the walk sheds
    every pixel, on both sides as in the reference: the frame's edge column
    and the silhouettes, where an edge-clamped gradient vanishes, have
    ratios near 1e10."""
    n_bounded = 0
    for width, height in ((SMALL_W, SMALL_H), (SMALL_W // 2, SMALL_H // 2)):
        card = texture_frames(dev, width, height)
        cpu = texture_frames(torch.device("cpu"), width, height)
        for label, (o, taps, bounded) in card.items():
            oc, taps_c, _ = cpu[label]
            if len(taps) != len(taps_c):
                fail(f"[texture] {label}: {len(taps)} taps on the card, "
                     f"{len(taps_c)} on the CPU")
            lanes = sum(int(a[0].numel()) for a in taps)
            levels = sum(int((a[0] != b[0]).sum()) for a, b in zip(taps, taps_c))
            rows = sum(int((a[1] != b[1]).sum()) for a, b in zip(taps, taps_c))
            same = int((o["tri_id"] == oc["tri_id"]).sum())
            diff = float((o["ldr"] - oc["ldr"]).abs().max())
            tel = {k: float(v) for k, v in o["saturation"].items()
                   if k.startswith("tex_")}
            tel_c = {k: float(v) for k, v in oc["saturation"].items()
                     if k.startswith("tex_")}
            for binned, w, h, msaa, zbound in bounded:
                check_bounded_kernel(binned, w, h, msaa, zbound, f"{label} window")
            n_bounded += len(bounded)
            say(f"[texture] {label} {width}x{height}, card vs CPU: tri_id equal "
                f"on {same}/{width * height}, max |ldr diff| {diff}; {len(taps)} "
                f"taps over {lanes} lanes: mismatched levels {levels}, rows "
                f"{rows}; telemetry {tel} (CPU {tel_c}); K1-bounded launches "
                f"{len(bounded)}, each bitwise against its plain version")
            if (same != width * height or not diff <= ENTRY_TOL or levels or rows
                    or tel != tel_c):
                fail(f"[texture] {label} {width}x{height} card vs CPU")
            if "aniso 8" in label and width == SMALL_W // 2 and not (
                    0.0 < tel["tex_aniso"] <= 1.0 < tel["tex_aniso_demand"]):
                fail(f"[texture] {label} {width}x{height}: the walk's ladder "
                     f"picked no rung between 1.3 and inf: {tel}")
    if n_bounded == 0:
        fail("[texture] the alpha peel launched no K1-bounded kernel")


def stress_consts(renderer, buffers, lights, n: int) -> list:
    """bench.py's camera sweep of the stress frame (the Sponza.xml camera,
    pitch 15, yaw -90 + 4 sin(0.15 i), fov 60, near 0.5, far 4000), each
    frame's prev_view_proj the frame before's."""
    import numpy as np

    from vqengine_tpu_torch.scene.camera import Camera, FCameraParameters
    p = FCameraParameters()
    p.position = np.array([700, 170, -50], np.float32)
    p.pitch_deg = 15.0
    p.yaw_deg = -90.0
    p.fov_v_deg = 60.0
    p.near_z, p.far_z = 0.5, 4000.0
    cam = Camera(p, aspect=W / H)
    out, prev = [], None
    for i in range(n):
        cam.yaw = -90.0 + 4.0 * math.sin(i * 0.15)
        c = renderer.build_frame_constants(buffers, cam, lights, prev_view_proj=prev)
        out.append(c)
        prev = c.view_proj.cpu().numpy()
    return out


def phase_stress_path(dev, card: str) -> tuple[dict, tuple]:
    """(h) bench.py's textured Sponza stress frame at 1920x1080
    (scene_load.sponza_stress: the .glb colonnade, 220 clutter items,
    five 512^2 maps with combined aux maps and pair rows, 5 spot, 5 point
    and 1 directional casters) with a 512x256 procedural sky built at the
    default sizes: the precompute of the 36 caster views (timed), the pair
    capacity from probe_pair_demand over the sweep (the precompute's K2
    launches and one frame's K1 and K3 launches held against their plain
    versions first, uncounted), then 16 frames of the
    engine's default flags with textures and the aniso-8 walk (the SSR
    history and prev_view_proj carried), and the same 16 frames with
    aniso_taps=0 (the engine's own setting: the stochastic single pair
    tap) -> (launches of the precompute and both sweeps, the objects
    phase_profile_stress needs)."""
    from vqengine_tpu_torch.engine.scene_load import sponza_stress
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    from vqengine_tpu_torch.ops import _backend, raster
    from vqengine_tpu_torch.ops.ibl import procedural_sky_equirect
    from vqengine_tpu_torch.render import graph
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    t0 = time.perf_counter()
    buffers, lights, tex = sponza_stress(dev)
    torch.cuda.synchronize()
    t_scene = (time.perf_counter() - t0) * 1e3
    r = VQRendererTorch(dev)
    t0 = time.perf_counter()
    r.load_scene(buffers, equirect=procedural_sky_equirect(512, 256), textures=tex)
    torch.cuda.synchronize()
    t_load = (time.perf_counter() - t0) * 1e3
    n_tris = buffers.indices.shape[0]
    tex_mib = (tex.flat.numel() * 4 + tex.pair_flat.numel() * 4) / 2 ** 20
    say(f"[stress] (h) the stress scene: {n_tris} triangles, {len(buffers.items)} "
        f"items, {len(lights)} lights; textures {len(tex.sizes)} levels from "
        f"{tex.sizes[0]}^2, {tex.flat.shape[0]} quad rows and "
        f"{tex.pair_flat.shape[0]} pair rows ({tex_mib:.1f} MiB); slots used "
        f"{r._slots_used}; host time: the scene and its textures "
        f"(sponza_stress, the packed tables on the card) {t_scene:.1f} ms, the "
        f"upload and the environment build {t_load:.1f} ms")
    consts = stress_consts(r, buffers, lights, N_FRAMES)
    flags = dict(render_flags(FGraphicsSettings()), dynamic_item_ids=())
    # warm-up with every K2 launch held against its plain version on
    # (h)'s own caster views, then the timed precompute
    with checked_launches({}) as found:
        maps = r.precompute_shadow_maps(consts[0])
    report_checked("precompute (36 caster views)", found, {"raster_vis": 36})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_counts()
    t0 = time.perf_counter()
    maps = r.precompute_shadow_maps(consts[0])
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    pre = dict(_backend.launches)
    views = len(caster_views(consts[0]))
    say(f"[stress] (h) precompute_shadow_maps (ESM, {views} views: 5 spot, 5 x 6 "
        f"point faces, 1 directional): {pre_ms:.3f} ms (host clock to the "
        f"sync) on {card}; launches {pre}")
    if pre["raster_vis"] != views or views != 36:
        fail(f"(h) precompute launched raster_vis {pre['raster_vis']} times for "
             f"{views} views")
    dem = max(int(graph.probe_pair_demand(r.scene, c, W, H)) for c in consts)
    r.pair_bucket = raster.pair_cap_bucket(dem, r.scene.num_tris_live)
    say(f"[stress] (h) pair demand over the sweep {dem}, capacity "
        f"{r.pair_bucket} (raster.pair_cap_bucket)")
    # one frame with the walk whose K1 and K3 launches are held against
    # their plain versions on (h)'s own inputs (not counted: the counts
    # are set to 0 before the timed frames)
    with checked_launches({}) as found:
        r.render(consts[0], W, H, shadow_maps=maps, aniso_taps=8, **flags)
    report_checked("frame 0 with the walk", found,
                   {"raster_gbuf_msaa": 1, "palette": 4})
    hist = None
    for c in consts[:2]:                          # warm-up
        for taps in (8, 0):
            hist = r.render(c, W, H, shadow_maps=maps, ssr_history=hist,
                            aniso_taps=taps, **flags)["ssr_history"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walk = run_frames(r, consts, card, "(h) textured stress frame: engine default "
                      "(MSAA, SSAO, motion, SSR) + textures, aniso 8 (the pair "
                      "tap and the adaptive walk)", carry_ssr=True,
                      shadow_maps=maps, aniso_taps=8, **flags)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    single = run_frames(r, consts, card, "(h) textured stress frame, aniso_taps=0 "
                        "(the engine's setting: one stochastic pair tap)",
                        carry_ssr=True, shadow_maps=maps, aniso_taps=0, **flags)
    n = len(consts)
    for lab, got in (("aniso 8", walk), ("aniso 0", single)):
        if (got["raster_gbuf_msaa"] != n or got["palette"] != 4 * n
                or got["raster_gbuf"] or got["raster_vis"]):
            fail(f"(h) {lab} frames launched {got}")
    say(f"[main] (h) launches per frame {({k: v / n for k, v in walk.items()})}; "
        f"peak device memory {peak:.1f} MiB (16 frames with the walk); pair "
        f"bucket {r.pair_bucket}")
    launches = {k: pre[k] + walk[k] + single[k] for k in walk}
    return launches, (r, consts, maps, flags)


def phase_profile_stress(stress) -> None:
    """(h)'s texture stages (CUDA events, 10 runs each, host syncs
    included) and a torch.profiler trace of PROFILE_FRAMES stress frames
    with the walk (traces/stress_trace.json)."""
    from vqengine_tpu_torch.ops import texture
    from vqengine_tpu_torch.render import graph
    r, consts, maps, flags = stress
    c = consts[1]
    _, _, attrs, _, _ = graph.geometry_pass(r.scene, c, W, H, msaa=True)
    n = graph.unit3(attrs["wnrm"])
    jit = texture.mip_jitter(H, W, device=n.device)

    def mat(taps, textures=r.textures):
        return graph.material_pass(n, attrs["mrow"], attrs["ids"], uv=attrs["uv"],
                                   wtan=attrs["wtan"], textures=textures,
                                   aniso_taps=taps, slots_used=r._slots_used,
                                   mip_jitter=jit, telemetry={})
    hist = r.render(consts[0], W, H, shadow_maps=maps, aniso_taps=8,
                    **flags)["ssr_history"]
    stages = {
        "material pass with textures, aniso 8 (lod, pair tap, adaptive walk, "
        "decode, aux normal)": lambda: mat(8),
        "material pass with textures, aniso_taps=0 (one stochastic pair tap)":
            lambda: mat(0),
        "material pass without textures": lambda: mat(0, None),
        "whole stress frame, aniso 8": lambda: r.render(
            c, W, H, shadow_maps=maps, ssr_history=hist, aniso_taps=8, **flags),
        "whole stress frame, aniso_taps=0": lambda: r.render(
            c, W, H, shadow_maps=maps, ssr_history=hist, aniso_taps=0, **flags),
    }
    for name, fn in stages.items():
        say(f"[profile] stage {time_ms(fn, 10):8.3f} ms  (h) {name}")
    trace_frames("stress frames", "stress_trace.json", "(h) textured stress "
                 "(engine default + textures, aniso 8)",
                 lambda: r.render(c, W, H, shadow_maps=maps, ssr_history=hist,
                                  aniso_taps=8, **flags))


def phase_default_path(dev, card: str, sponza, renderer) -> dict:
    """(g) the engine's full default frame (render_flags of
    FGraphicsSettings: MSAA 4x with the neighbor edge resolve, SSAO
    "medium", motion vectors on the static path, SSR) on cached ESM maps,
    lit by the environment: the precompute, then the 16-frame yaw sweep,
    each frame's prev_view_proj the frame before's and the SSR history
    carried; then the same frames without SSR and without SSAO (the cost
    of each) -> launches of the precompute and the full frames."""
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    flags = dict(render_flags(FGraphicsSettings()), dynamic_item_ids=())
    cam = sponza.cameras[0]
    base_yaw = cam.yaw
    consts, prev = [], None
    for i in range(N_FRAMES):
        sweep_camera(cam, i, base_yaw)
        c = renderer.build_frame_constants(sponza.buffers, cam, sponza.lights,
                                           prev_view_proj=prev)
        consts.append(c)
        prev = c.view_proj.cpu().numpy()
    cam.yaw = base_yaw
    maps = renderer.precompute_shadow_maps(consts[0])
    hist = None
    for c in consts[:2]:                          # warm-up
        hist = renderer.render(c, W, H, shadow_maps=maps, ssr_history=hist,
                               **flags)["ssr_history"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    maps, _, pre = precompute(renderer, consts[0], card, "esm")
    full = run_frames(renderer, consts, card,
                      "(g) the engine's full default frame: MSAA 4x, neighbor "
                      "edge resolve, cached ESM maps, environment and skydome, "
                      "SSAO medium, motion vectors (static path), SSR with its "
                      "history carried", carry_ssr=True, shadow_maps=maps, **flags)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    n = len(consts)
    if (full["raster_gbuf_msaa"] != n or full["palette"] != 4 * n
            or full["raster_gbuf"] or full["raster_vis"]):
        fail(f"(g) frames launched {full}")
    no_ssr = run_frames(renderer, consts, card, "(g) without SSR",
                        shadow_maps=maps, **dict(flags, enable_ssr=False))
    no_ssao = run_frames(renderer, consts, card, "(g) without SSAO",
                         carry_ssr=True, shadow_maps=maps,
                         **dict(flags, enable_ssao=False))
    if no_ssr != full or no_ssao != full:
        fail(f"(g) launches without SSR {no_ssr} / SSAO {no_ssao}, with {full}")
    say(f"[main] (g) launches per frame {({k: v / n for k, v in full.items()})}; "
        f"peak device memory {peak:.1f} MiB (precompute + {n} full frames)")
    return {k: pre[k] + full[k] for k in full}


def run_frames(renderer, consts: list, card: str, label: str,
               carry_ssr: bool = False, **flags) -> dict:
    """Render the frames (CUDA events around each) with the launch counts
    set to 0 first; fail on overflow, non-finite output or a plain version
    run on CUDA tensors. carry_ssr passes each frame's out["ssr_history"]
    to the next, as the engine does (the first frame starts afresh), and
    checks that its sample count grows; where the frames carry motion
    vectors, every frame after the first (whose camera turned) must have
    some. -> launches."""
    from vqengine_tpu_torch.ops import _backend
    torch.cuda.synchronize()
    _backend.reset_counts()
    times, cover, sat, extra = [], [], [], {}
    history = None
    for i, c in enumerate(consts):
        if carry_ssr:
            flags["ssr_history"] = history
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
        for k in ("ssao_refine", "ssr_rays", "tex_aniso", "tex_aniso_demand"):
            if k in out["saturation"]:
                extra.setdefault(k, []).append(float(out["saturation"][k]))
        for k in ("ao", "motion", "ssr_history"):
            if k in out and not bool(torch.isfinite(out[k]).all()):
                fail(f"{label} frame {i}: {k} not finite")
        if "motion" in out and i > 0 and not float(out["motion"].abs().max()) > 0:
            fail(f"{label} frame {i}: the camera turned but motion is 0")
        if carry_ssr:
            history = out["ssr_history"]
            if float(history[..., 6].max()) != min(i + 1, 32):
                fail(f"{label} frame {i}: SSR history sample count "
                     f"{float(history[..., 6].max())}, expected {i + 1}")
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
    if flags.get("enable_ssao") or flags.get("enable_ssr"):
        say(f"[main] {label}: saturation "
            + (", ".join(f"{k} {min(v):.4f}..{max(v):.4f}" for k, v in extra.items()
                         if not k.startswith("tex_"))
               or "ssao_refine and ssr_rays absent (the SSAO preset has no "
               "refinement, the rays march dense)"))
    if "tex_aniso" in extra:
        say(f"[main] {label}: tex_aniso per frame "
            f"{[round(v, 4) for v in extra['tex_aniso']]}; tex_aniso_demand per "
            f"frame {[round(v, 4) for v in extra['tex_aniso_demand']]}")
        if max(extra["tex_aniso"]) > 1.0:
            say(f"[main] {label}: the aniso walk overflowed its capacity "
                f"(tex_aniso {max(extra['tex_aniso']):.4f}): the ladder's top "
                f"rung overflowed, the walk truncates")
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
    if sponza.textures is not None:
        fail("Sponza samples textures: its level names no texture file")
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
    # the engine's default passes (SSAO, motion vectors, SSR) on the MSAA
    # frame's G-buffer, and the engine's full default frame
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    from vqengine_tpu_torch.ops import ssao as ssao_ops
    from vqengine_tpu_torch.ops import ssr as ssr_ops
    flags = dict(render_flags(FGraphicsSettings()), dynamic_item_ids=())
    cam = sponza.cameras[0]
    cam.yaw += 2.0
    c1 = renderer.build_frame_constants(sponza.buffers, cam, sponza.lights,
                                        prev_view_proj=c.view_proj.cpu().numpy())
    cam.yaw -= 2.0
    n_m = graph.unit3(attrs_m["wnrm"])
    mat_m = graph.material_pass(n_m, attrs_m["mrow"], attrs_m["ids"])
    d_h = graph.pool2(depth)
    th = ssao_ops.tan_half(c.proj_params[2])
    hist = renderer.render(c, W, H, shadow_maps=maps, **flags)["ssr_history"]
    motion = graph.motion_vectors(scene, c1, attrs_m["wpos"], tri_id, mask,
                                  item_id=mat_m["item_id"], dynamic_item_ids=())
    refl_q, conf_q = ssr_ops.trace_reflections(
        graph.pool2(graph.pool2(hdr)), graph.pool2(d_h),
        graph.pool2(graph.pool2(n_m)), c1.view_matrix, c1.proj_params,
        tan_half_fov=th)
    hh, hw = d_h.shape
    refl_h, conf_h = graph.up2_fit(refl_q, hh, hw), graph.up2_fit(conf_q, hh, hw)
    refl_dn, _ = ssr_ops.denoise_reflections(refl_h, conf_h,
                                             graph.pool2(mat_m["roughness"]),
                                             history=hist, motion=graph.pool2(motion),
                                             depth=d_h)
    v = graph.unit3(c1.camera_pos - attrs_m["wpos"])
    whole_g = "whole frame (engine default, full: + SSAO, motion, SSR)"
    gstages = {
        "SSAO medium (ssao_pass: half-res 12-tap spiral, blur, bilateral "
        "upsample)": lambda: graph.ssao_pass(c1, depth, n_m, "medium", d_h=d_h,
                                             tan_half_fov=th),
        "motion vectors (static path)":
            lambda: graph.motion_vectors(scene, c1, attrs_m["wpos"], tri_id, mask,
                                         item_id=mat_m["item_id"],
                                         dynamic_item_ids=()),
        "motion vectors (palette path, K3 [N, 12] rows)":
            lambda: graph.motion_vectors(scene, c1, attrs_m["wpos"], tri_id, mask,
                                         item_id=mat_m["item_id"],
                                         dynamic_item_ids=None),
        "SSR trace (quarter-res hi-Z march, 14 steps, with the pools)":
            lambda: ssr_ops.trace_reflections(
                graph.pool2(graph.pool2(hdr)), graph.pool2(d_h),
                graph.pool2(graph.pool2(n_m)), c1.view_matrix, c1.proj_params,
                tan_half_fov=th),
        "SSR denoise (half-res prefilter, reprojected temporal resolve)":
            lambda: ssr_ops.denoise_reflections(
                refl_h, conf_h, graph.pool2(mat_m["roughness"]), history=hist,
                motion=graph.pool2(motion), depth=d_h),
        "SSR apply (full-res upsample and Fresnel composite)":
            lambda: ssr_ops.apply_reflections(
                hdr, graph.up2_fit(refl_dn, H, W), graph.up2_fit(conf_h, H, W),
                mat_m["roughness"], mat_m["metalness"], mat_m["albedo"], n_m, v),
        "SSR whole (ssr_pass)":
            lambda: graph.ssr_pass(c1, hdr, depth, n_m, mat_m, attrs_m["wpos"],
                                   mask, motion, hist, d_h=d_h, tan_half_fov=th),
        whole_g: lambda: renderer.render(c1, W, H, shadow_maps=maps,
                                         ssr_history=hist, **flags),
    }
    for name, fn in gstages.items():
        say(f"[profile] stage {time_ms(fn, 10):8.3f} ms  {name}")
    trace_frames("frames", "sponza_trace.json", "default (MSAA, cached-map, "
                 "environment; no SSAO, SSR or motion)",
                 lambda: renderer.render(c, W, H, shadow_maps=maps, msaa=True))
    trace_frames("full frames", "sponza_full_trace.json", "full engine default "
                 "(+ SSAO, motion vectors, SSR)",
                 lambda: renderer.render(c1, W, H, shadow_maps=maps,
                                         ssr_history=hist, **flags))


def trace_frames(window_name: str, file_name: str, label: str, frame) -> None:
    """A torch.profiler trace of PROFILE_FRAMES frames after a warm-up,
    written to traces/<file_name>: the card's busy time, device ops and
    idle share per frame, and the largest device rows (the hand kernels'
    rows always)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame()                                   # warm-up
        torch.cuda.synchronize()
        with record_function(window_name):
            for _ in range(PROFILE_FRAMES):
                frame()
            torch.cuda.synchronize()
    path = ROOT / "traces" / file_name
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    window, busy, rows = idle_share(json.loads(path.read_text()), window_name)
    if busy <= 0:
        fail("the profiled frames ran nothing on the card")
    k = sum(n for _, n in rows.values())
    say(f"[profile] trace {path.relative_to(ROOT)}: {PROFILE_FRAMES} {label} "
        f"frames in {window:.3f} ms wall ({window / PROFILE_FRAMES:.3f} "
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


# ---------------------------------------------------------------------------
# tessellation: the amplifiers card vs CPU, (i) StressTest, (j) Terrain
# ---------------------------------------------------------------------------

STRESS_SMALL_DIMS = (2, 1, 5)   # the reduced StressTest: 24 animated objects
AMPLIFIED = ("pos", "nrm", "tan", "uv", "item", "live")


def reduced_stress_test(width: int, height: int):
    """StressTest cut for a CPU comparison: augment_stress_test with dims
    STRESS_SMALL_DIMS (24 animated objects and the TessRock), the 80
    gradient spheres left out; no environment -> LoadedScene."""
    from vqengine_tpu_torch.engine.scene_load import LoadedScene, find_data_dirs
    from vqengine_tpu_torch.render.scene_buffers import assemble_scene
    from vqengine_tpu_torch.scene.mesh import build_builtin_meshes
    from vqengine_tpu_torch.scene.scenes import augment_stress_test
    from vqengine_tpu_torch.scene.serialization import parse_scene_file
    rep = parse_scene_file(find_data_dirs()[0] / "Levels" / "StressTest.xml")
    lib, meshes = {}, build_builtin_meshes()
    hook = augment_stress_test(rep, lib, dims=STRESS_SMALL_DIMS)
    rep.objects = [o for o in rep.objects
                   if not o.model.name.startswith("GradSphere")]
    buffers, cams, lights = assemble_scene(rep, meshes, lib, draw_light_gizmos=True)
    for c in cams:
        c.aspect = width / height
    return LoadedScene("StressTest", buffers, cams, lights, False, None, True,
                       update_hook=hook)


def geomorph_tiles(dev):
    """Four scenes.build_terrain_patch tiles (3 LODs with geomorph
    targets) on a renderer of `dev`, and a camera at 700 whose frame puts
    the tiles inside their morph window -> (renderer, buffers, camera,
    lights)."""
    import numpy as np

    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    from vqengine_tpu_torch.render.scene_buffers import DrawItem, build_scene_buffers
    from vqengine_tpu_torch.scene.camera import Camera, FCameraParameters
    from vqengine_tpu_torch.scene.light import ELightType, Light
    from vqengine_tpu_torch.scene.material import Material
    from vqengine_tpu_torch.scene.scenes import build_terrain_patch
    from vqengine_tpu_torch.utils import math3d as m3
    items = [DrawItem(f"tile{i}", build_terrain_patch(i % 2, i // 2, patches=2,
                                                      res=64, num_lods=3),
                      m3.Transform(), 0, i) for i in range(4)]
    buffers = build_scene_buffers(items, [Material(name="m")])
    p = FCameraParameters()
    p.position = np.array([-210.0, 280.0, -700.0], np.float32)
    p.pitch_deg, p.yaw_deg, p.far_z = 20.0, 15.0, 8000.0
    r = VQRendererTorch(dev)
    r.load_scene(buffers)
    return r, buffers, Camera(p, aspect=W / H), [Light(type=ELightType.DIRECTIONAL)]


def amplified(scene, c) -> dict:
    """Both amplifiers of the scene on the frame c, each displacement
    texel (x0, y0) recorded, and the snapped parameters and collapsed set
    of each -> {name: CPU tensor}."""
    from vqengine_tpu_torch.ops import tessellation as tess
    out, texels, orig = {}, [], tess.displace_texels

    def rec(uv, hh, wh):
        sel = orig(uv, hh, wh)
        texels.append(torch.stack([sel[0], sel[1]]).reshape(-1))
        return sel
    tess.displace_texels = rec
    try:
        for kind in ("patch", "tpatch"):
            corners = getattr(scene, f"{kind}_corners")
            if corners is None:
                continue
            quad = kind == "patch"
            tpl = ((scene.patch_params, scene.patch_tri_idx) if quad
                   else (scene.tpatch_bary, scene.tpatch_tri_idx))
            item, scale = getattr(scene, f"{kind}_item"), getattr(scene, f"{kind}_tess_scale")
            res = (tess.amplify if quad else tess.amplify_tri)(
                corners, getattr(scene, f"{kind}_normals"), getattr(scene, f"{kind}_uvs"),
                item, c.world, c.camera_pos, c.frustum_planes, *tpl, scale,
                heightmap=getattr(scene, f"{kind}_heightmap"),
                disp_scale=getattr(scene, f"{kind}_disp_scale"))
            for name, t in zip(AMPLIFIED, res):
                out[f"{kind} {name}"] = t.cpu()
            out[f"{kind} texels"] = torch.cat(texels).cpu()
            texels.clear()
            cw = tess._world_corners(corners, item, c.world)
            snapped = (tess.snap_params(tpl[0], *tess.edge_factors(cw, c.camera_pos, scale))
                       if quad else
                       tess.snap_bary(tpl[0], *tess.tri_edge_factors(cw, c.camera_pos, scale)))
            out[f"{kind} snapped"] = snapped.cpu()
            out[f"{kind} collapsed"] = tess._collapsed(snapped, tpl[1]).cpu()
    finally:
        tess.displace_texels = orig
    return out


def amplified_text(a: dict, kind: str) -> str:
    n = a[f"{kind} collapsed"].numel()
    return (f"{n} amplified triangles ({a[f'{kind} live'].numel()} with the "
            f"padding), {int(a[f'{kind} collapsed'].sum())} collapsed, "
            f"{int(a[f'{kind} live'].sum())} live after the cull and the "
            f"collapse; {a[f'{kind} texels'].numel() // 2} displacement taps")


def phase_tess_card_vs_cpu(dev) -> None:
    """`[tess]` lines: the amplifiers of the full Terrain (576 quad patches,
    from both its cameras) and of StressTest's TessRock on the card and
    the CPU, every output and the snapped parameters, the collapsed set
    and each displacement texel bitwise; the geomorph front end of four
    build_terrain_patch tiles at 1920x1080 with its K3 launches (the
    [N, 17] morph rows among them) held against the plain version and its
    setup against the CPU's; the reduced StressTest's two frames (the
    engine's default flags, the hook advanced once, the maps in the frame)
    and the terrain golden's frame, card vs CPU."""
    from vqengine_tpu_torch.engine.frame_loop import FrameLoop
    from vqengine_tpu_torch.engine.goldens import golden_scores, render_golden
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    from vqengine_tpu_torch.render import graph
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    cpu = torch.device("cpu")
    for name, kind, cams in (("Terrain", "patch", (0, 1)), ("StressTest", "tpatch", (0,))):
        s = load_scene(name, W, H)
        got = {}
        for d in (dev, cpu):
            r = VQRendererTorch(d)
            r.load_scene(s.buffers)
            got[d.type] = [amplified(r.scene, r.build_frame_constants(
                s.buffers, s.cameras[k], s.lights)) for k in cams]
        for k, a, b in zip(cams, got["cuda"], got["cpu"]):
            bad = {n: int((a[n] != b[n]).sum()) for n in a if not bitwise_equal(a[n], b[n])}
            say(f"[tess] {name} camera {k}: {amplified_text(a, kind)}; card vs "
                f"CPU: corner tables, items, tri_live, snapped parameters, the "
                f"collapsed set and every texel {'equal' if not bad else bad}")
            if bad:
                fail(f"{name} amplifier card vs CPU: {bad}")
    r, buffers, cam, lights = geomorph_tiles(dev)
    c = r.build_frame_constants(buffers, cam, lights)
    with checked_launches({}) as found:
        setup, _ = graph.geometry_setup_gbuf(r.scene, c, W, H)
    report_checked("geomorph tiles, front end", found, {"palette": 3}, tag="[tess] (j)")
    if not any(", 17]" in w for w in found["palette"][2]):
        fail("the geomorph front end launched no K3 on [N, 17] morph rows")
    rc, buffers_c, cam_c, lights_c = geomorph_tiles(cpu)
    setup_c, _ = graph.geometry_setup_gbuf(
        rc.scene, rc.build_frame_constants(buffers_c, cam_c, lights_c), W, H)
    bad = [f for f in ("edges9", "zc", "vert_scale", "valid", "tile_lo", "tile_hi")
           if not bitwise_equal(getattr(setup, f).cpu(), getattr(setup_c, f))]
    say(f"[tess] geomorph tiles at {W}x{H}: {int(setup.valid.sum())} live "
        f"triangles of {setup.valid.numel()}; setup card vs CPU "
        f"{'bitwise' if not bad else 'differs in ' + str(bad)}")
    if bad:
        fail(f"geomorph setup card vs CPU differs in {bad}")
    flags = dict(render_flags(FGraphicsSettings()), shadow_dims=SMALL_DIMS)
    frames = {}
    for d in (dev, cpu):
        s = reduced_stress_test(SMALL_W, SMALL_H)
        r = VQRendererTorch(d)
        r.load_scene(s.buffers)
        loop = FrameLoop(r, s, SMALL_W, SMALL_H, flags)
        frames[d.type] = [{k: v.cpu() for k, v in loop.tick().items()
                           if k in ("ldr", "tri_id", "motion", "ao")}
                          for _ in range(2)]
        moved = len(loop.dynamic_items)
    for i, (a, b) in enumerate(zip(frames["cuda"], frames["cpu"])):
        same = a["tri_id"] == b["tri_id"]
        diff = {k: float((a[k] - b[k])[same].abs().max()) for k in ("ldr", "motion", "ao")}
        say(f"[tess] reduced StressTest {SMALL_W}x{SMALL_H} frame {i} (engine "
            f"default flags, maps in the frame, {moved} moved items, the "
            f"TessRock amplified), card vs CPU: tri_id agrees on "
            f"{float(same.float().mean()):.6f}; max |diff| {diff}")
        if (float(same.float().mean()) < 0.999 or not diff["ldr"] <= ENTRY_TOL
                or not diff["motion"] <= MOTION_TOL or not diff["ao"] <= AO_TOL):
            fail(f"reduced StressTest frame {i} card vs CPU: {diff}")
    imgs = [render_golden("terrain", d) for d in (dev, cpu)]
    diff = float(abs(imgs[0] - imgs[1]).max())
    for d, img in zip(("card", "CPU"), imgs):
        g = golden_scores("terrain", img)
        say(f"[tess] golden terrain on the {d}: SSIM {g['ssim']:.5f}, mean MAE "
            f"{g['mean_mae']:.5f}, worst block {g['block_mae']:.5f} (the PNG "
            f"predates the quad-patch Terrain: goldens.STALE_PNG)")
    say(f"[tess] golden terrain's frame card vs CPU: max |ldr diff| {diff}")
    if not diff <= ENTRY_TOL:
        fail(f"terrain golden frame card vs CPU {diff} > {ENTRY_TOL}")


def run_loop(loop, n: int, card: str, label: str, before=None) -> dict:
    """n engine ticks of loop (the hook advanced by 1/60, the constants
    rebuilt, the frame rendered), CUDA events around each, with the launch
    counts set to 0 first; before(i) runs ahead of tick i (a camera move).
    Ahead of each tick, outside its window, the tick's constants step
    (loop.constants and their upload) runs alone on the host clock, synced
    before and after: the host's share of a tick. Fails on overflow,
    non-finite output, a plain version run on CUDA tensors, or frames
    after the first without motion. -> launches."""
    from vqengine_tpu_torch.ops import _backend
    torch.cuda.synchronize()
    _backend.reset_counts()
    times, host = [], []
    for i in range(n):
        if before is not None:
            before(i)
        t0 = time.perf_counter()
        loop_consts(loop)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = loop.tick()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        ldr = out["ldr"]
        if tuple(ldr.shape) != (H, W, 3) or not bool(torch.isfinite(ldr).all()):
            fail(f"{label} frame {i}: ldr {tuple(ldr.shape)} not finite/shaped")
        if int(out["overflow"].sum()):
            fail(f"{label} frame {i}: overflow {out['overflow'].tolist()}")
        for k in ("ao", "motion", "ssr_history"):
            if k in out and not bool(torch.isfinite(out[k]).all()):
                fail(f"{label} frame {i}: {k} not finite")
        if i and not float(out["motion"].abs().max()) > 0:
            fail(f"{label} frame {i}: nothing moved, but motion is 0")
    launches = dict(_backend.launches)
    plain = dict(_backend.plain_cuda_calls)
    ms = sorted(times)
    say(f"[main] {label}: {n} frames, overflow 0, finite; ms/frame (CUDA "
        f"events, host syncs, the hook and the constants included): mean "
        f"{sum(ms) / n:.3f}, median {ms[n // 2]:.3f}, min {ms[0]:.3f}, max "
        f"{ms[-1]:.3f} on {card}")
    say(f"[main] {label}: the constants step alone (host clock, synced): mean "
        f"{sum(host) / n:.3f}, min {min(host):.3f}, max {max(host):.3f} ms")
    say(f"[main] {label}: kernel launches {launches}; plain-version calls on "
        f"CUDA tensors {plain}")
    if max(plain.values()) != 0:
        fail(f"{label}: plain versions ran on CUDA tensors: {plain}")
    return launches


def loop_consts(loop):
    from vqengine_tpu_torch.render.graph import frame_constants_from_numpy
    return frame_constants_from_numpy(loop.constants(), loop.renderer.device)


def live_after_setup(r, c) -> tuple[int, int]:
    """(amplified triangles that pass the triangle setup, all triangles
    that pass it) in the frame c."""
    from vqengine_tpu_torch.render import graph
    setup, _ = graph.geometry_setup_gbuf(r.scene, c, W, H)
    return (int(setup.valid[r.scene.num_tris_live:].sum()), int(setup.valid.sum()))


def phase_stresstest_path(dev, card: str) -> tuple[dict, tuple]:
    """(i) the engine's StressTest level at 1920x1080 as the engine runs
    it (engine/frame_loop.FrameLoop): the hook advances at 1/60, so the
    shadow maps render in every frame (8 K2 views over all 649,412
    triangles), the moved set holds the 384 animated objects (motion on
    K3's palette path), the TessRock's 12 tri patches amplify; the
    engine's default flags, the environment and skydome. Two warm-up
    ticks, one tick with every K1, K2 and K3 launch held against its plain
    version (uncounted), then 16 timed ticks -> (launches, state)."""
    from vqengine_tpu_torch.engine.frame_loop import FrameLoop
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    t0 = time.perf_counter()
    s = load_scene("StressTest", W, H)
    r = VQRendererTorch(dev)
    r.load_scene(s.buffers, equirect=s.equirect, textures=s.textures)
    torch.cuda.synchronize()
    t_load = (time.perf_counter() - t0) * 1e3
    loop = FrameLoop(r, s, W, H, render_flags(FGraphicsSettings()))
    b = s.buffers
    casters = [l.type.name for l in s.lights if l.enabled and l.casts_shadows]
    say(f"[tess] (i) StressTest: {b.indices.shape[0]} triangles (all LODs), "
        f"{len(b.items)} items, {b.tpatch_corners.shape[0]} tri patches, "
        f"casters {casters}, an update hook; load and upload {t_load:.1f} ms "
        f"(host clock)")
    if loop.cache_shadow_maps or loop.hook is None:
        fail("(i) StressTest would cache its shadow maps")
    for _ in range(2):                            # warm-up: the moved set fills
        loop.tick()
    with checked_launches({}) as found:
        loop.tick()
    report_checked("frame", found, {"raster_gbuf_msaa": 1, "raster_vis": 8,
                                    "palette": 14}, tag="[tess] (i)")
    c = loop_consts(loop)
    amp = amplified(r.scene, c)
    live_amp, live_all = live_after_setup(r, c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = N_FRAMES
    got = run_loop(loop, n, card, "(i) StressTest: engine default (MSAA, SSAO, "
                   "motion on the palette path, SSR), maps in the frame, "
                   "environment and skydome, the TessRock amplified")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if (got["raster_gbuf_msaa"] != n or got["raster_vis"] != 8 * n
            or got["palette"] != 14 * n or got["raster_gbuf"]):
        fail(f"(i) frames launched {got}")
    if len(loop.dynamic_items) <= 16:
        fail(f"(i) only {len(loop.dynamic_items)} items moved")
    say(f"[main] (i) launches per frame {({k: v / n for k, v in got.items()})}; "
        f"{len(loop.dynamic_items)} moved items; TessRock: "
        f"{amplified_text(amp, 'tpatch')}, {live_amp} past the triangle setup "
        f"({live_all} triangles of the frame past it); peak device memory "
        f"{peak:.1f} MiB; pair bucket {r.pair_bucket}")
    return got, (r, loop)


def phase_terrain_path(dev, card: str) -> tuple[dict, tuple]:
    """(j) the engine's Terrain level at 1920x1080 (576 displaced quad
    patches, 56,448 amplified triangles a frame): the Stationary
    directional caster's maps precomputed once in the first tick (1 K2
    view), then a tick with every launch held against its plain version
    (uncounted), 16 timed ticks of a yaw sweep around camera 0 and one
    from camera 1 (top-down, pitch 85: the far factors) -> (launches,
    state)."""
    from vqengine_tpu_torch.engine.frame_loop import FrameLoop
    from vqengine_tpu_torch.engine.scene_load import load_scene
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    from vqengine_tpu_torch.ops import _backend
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    s = load_scene("Terrain", W, H)
    r = VQRendererTorch(dev)
    r.load_scene(s.buffers, equirect=s.equirect, textures=s.textures)
    loop = FrameLoop(r, s, W, H, render_flags(FGraphicsSettings()))
    if not loop.cache_shadow_maps:
        fail("(j) Terrain would render its shadow maps in every frame")
    torch.cuda.synchronize()
    _backend.reset_counts()
    t0 = time.perf_counter()
    loop.tick()                                   # the precompute, then a frame
    torch.cuda.synchronize()
    first = dict(_backend.launches)
    say(f"[tess] (j) Terrain: {s.buffers.indices.shape[0]} triangles, "
        f"{s.buffers.patch_corners.shape[0]} quad patches; first tick (the "
        f"precompute of {sorted(loop.static_maps)} and a frame) "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock), launches {first}")
    if first["raster_vis"] != 1:
        fail(f"(j) the precompute launched K2 {first['raster_vis']} times")
    with checked_launches({}) as found:
        loop.tick()
    report_checked("frame", found, {"raster_gbuf_msaa": 1, "palette": 5},
                   tag="[tess] (j)")
    cam = loop.camera
    base_yaw = cam.yaw
    counts = []
    for k in (0, 1):
        loop.camera = s.cameras[k]
        c = loop_consts(loop)
        counts.append((amplified(r.scene, c), *live_after_setup(r, c)))
    loop.camera = cam
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = N_FRAMES
    sweep = run_loop(loop, n, card, "(j) Terrain: engine default (MSAA, SSAO, "
                     "motion, SSR), cached directional map, environment and "
                     "skydome, 576 patches amplified; yaw sweep around camera 0",
                     before=lambda i: sweep_camera(cam, i, base_yaw))
    consts, prev = [], None
    for i in range(n):
        sweep_camera(cam, i, base_yaw)
        c = r.build_frame_constants(s.buffers, cam, s.lights, prev_view_proj=prev)
        consts.append(c)
        prev = c.view_proj.cpu().numpy()
    cam.yaw = base_yaw
    built = run_frames(r, consts, card, "(j) Terrain, the same sweep with its "
                       "constants built before the window, as (g) is timed",
                       carry_ssr=True, shadow_maps=loop.static_maps,
                       dynamic_item_ids=(), **loop.flags)
    loop.camera = s.cameras[1]
    top = run_loop(loop, 1, card, "(j) Terrain from camera 1 (top-down, pitch "
                   "85: the far factors)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if (sweep["raster_gbuf_msaa"] != n or sweep["palette"] != 5 * n
            or sweep["raster_vis"] or sweep["raster_gbuf"] or built != sweep):
        fail(f"(j) frames launched {sweep}, with the constants built before {built}")
    for k, (amp, live_amp, live_all) in enumerate(counts):
        say(f"[main] (j) camera {k}: {amplified_text(amp, 'patch')}, {live_amp} "
            f"past the triangle setup ({live_all} triangles of the frame past it)")
        if amp["patch collapsed"].numel() != 56448:
            fail(f"(j) amplified {amp['patch collapsed'].numel()} triangles")
    say(f"[main] (j) launches per frame {({k: v / n for k, v in sweep.items()})}; "
        f"peak device memory {peak:.1f} MiB; pair bucket {r.pair_bucket}")
    launches = {k: first[k] + sweep[k] + built[k] + top[k] for k in sweep}
    return launches, (r, loop, s)


def phase_profile_tess(stresstest, terrain) -> None:
    """Stage rows of (i) and (j) (CUDA events, 10 runs each, host syncs
    included): each amplifier alone, the front end with it, (i)'s shadow
    maps in the frame, whole ticks; and a trace of PROFILE_FRAMES ticks of
    each (traces/stresstest_trace.json, traces/terrain_trace.json)."""
    from vqengine_tpu_torch.ops import tessellation as tess
    from vqengine_tpu_torch.render import graph
    ri, li = stresstest
    rj, lj, sj = terrain
    lj.camera = sj.cameras[0]
    ci, cj = loop_consts(li), loop_consts(lj)
    si, sj_ = ri.scene, rj.scene
    stages = {
        "(j) amplify: 576 quad patches, displaced (56,448 triangles)": lambda: tess.amplify(
            sj_.patch_corners, sj_.patch_normals, sj_.patch_uvs, sj_.patch_item,
            cj.world, cj.camera_pos, cj.frustum_planes, sj_.patch_params,
            sj_.patch_tri_idx, sj_.patch_tess_scale, heightmap=sj_.patch_heightmap,
            disp_scale=sj_.patch_disp_scale),
        "(i) amplify_tri: the TessRock's 12 tri patches, displaced": lambda: tess.amplify_tri(
            si.tpatch_corners, si.tpatch_normals, si.tpatch_uvs, si.tpatch_item,
            ci.world, ci.camera_pos, ci.frustum_planes, si.tpatch_bary,
            si.tpatch_tri_idx, si.tpatch_tess_scale, heightmap=si.tpatch_heightmap,
            disp_scale=si.tpatch_disp_scale),
        "(j) front end with the amplifier (cull, LOD, transforms, setup, pack)":
            lambda: graph.geometry_setup_gbuf(sj_, cj, W, H),
        "(i) front end with the amplifier (649,412 static triangles)":
            lambda: graph.geometry_setup_gbuf(si, ci, W, H),
        "(i) shadow maps in the frame (8 K2 views, all triangles)":
            lambda: graph.render_shadow_maps(si, ci),
        "(i) whole tick (hook, constants, frame)": li.tick,
        "(j) whole tick (constants, frame)": lj.tick,
    }
    for name, fn in stages.items():
        say(f"[profile] stage {time_ms(fn, 10):8.3f} ms  {name}")
    trace_frames("stresstest frames", "stresstest_trace.json",
                 "(i) StressTest ticks", li.tick)
    trace_frames("terrain frames", "terrain_trace.json", "(j) Terrain ticks", lj.tick)


def phase_profile_engine(dev) -> None:
    """(k)'s tick on Sponza with the engine's defaults: the stage row of 10
    ticks in a row (CUDA events around the ten, no sync between ticks, as
    the engine runs them) beside (g)'s synced frame, and a trace of
    PROFILE_FRAMES ticks (traces/engine_trace.json)."""
    from vqengine_tpu_torch.engine.engine import VQEngineTorch
    e = VQEngineTorch([f"-W={W}", f"-H={H}", "-Scene=Sponza"], device=dev)
    e.start_loading_scene("Sponza")
    e.tick()
    say(f"[profile] stage {time_ms(e.tick, 10):8.3f} ms  (k) engine tick on "
        f"Sponza, the engine's defaults (events, input, constants, the frame "
        f"without readback; 10 ticks unsynced)")
    trace_frames("engine ticks", "engine_trace.json", "(k) Sponza engine ticks",
                 e.tick)


@contextlib.contextmanager
def engine_log(lines: list):
    """While the context lasts, every message the engine logs through
    utils.log.info is kept in lines (and still logged)."""
    from vqengine_tpu_torch.utils import log
    info = log.info

    def keep(msg: str, *args) -> None:
        lines.append(msg)
        info(msg, *args)
    log.info = keep
    try:
        yield lines
    finally:
        log.info = info


def engine_run(dev, card: str, label: str, scene: str, setup=None,
               context: tuple | None = None) -> dict:
    """One engine run of path (k): -Test -TestFrames=N_FRAMES at W x H on
    `scene`, the engine's defaults (HDR on: the HDR10 dump runs) with
    setup(engine) applied. First an engine set up the same way ticks twice:
    every K1, K2 and K3 launch of its first tick held against the plain
    version (checked_launches), and its second frame against a FrameLoop's
    on the same renderer (ldr within ENTRY_TOL). Then, with the launch
    counts at 0, the run itself: __main__.main in-process when there is no
    setup, else VQEngineTorch.run of a fresh engine so set up. Checks the
    exit code (0), the files the run writes (loading.png, the frame, the
    HDR10 encode and the render context's frame), and reads the engine's
    logged ms/frame; prints the launches per frame and the peak device
    memory. -> launches."""
    import re

    from vqengine_tpu_torch.__main__ import main
    from vqengine_tpu_torch.engine.engine import VQEngineTorch
    from vqengine_tpu_torch.engine.frame_loop import FrameLoop
    from vqengine_tpu_torch.engine.scene_load import LoadedScene
    from vqengine_tpu_torch.engine.settings import render_flags
    from vqengine_tpu_torch.ops import _backend
    out_dir = ROOT / "out" / "engine" / scene
    argv = ["-Test", f"-TestFrames={N_FRAMES}", f"-W={W}", f"-H={H}",
            f"-Scene={scene}", f"-OutputDir={out_dir}"]
    e = VQEngineTorch(argv, device=dev)
    if setup is not None:
        setup(e)
    if not e.start_loading_scene(scene):
        fail(f"(k) {label}: the scene did not load")
    with checked_launches({}) as found:
        e.tick()
    want = {"raster_gbuf_msaa": 1}
    if context is not None:
        want["raster_gbuf"] = 1
    report_checked("first tick", found, want, tag=f"[engine] (k) {label}")
    second = e.tick()
    loop = FrameLoop(e.renderer, LoadedScene(
        name=scene, buffers=e.scene_buffers, cameras=e.cameras, lights=e.lights,
        wants_environment=e.environment is not None, textures=None,
        has_shadow_casters=any(l.enabled and l.casts_shadows for l in e.lights),
        update_hook=e.scene_update_hook), W, H,
        dict(render_flags(e.gfx), env=e.environment, textures=e.texture_arrays))
    loop.tick()
    ref = loop.tick()
    diff = float((second.ldr - ref["ldr"]).abs().max())
    say(f"[engine] (k) {label}: the engine's second tick against FrameLoop's "
        f"second frame on the same renderer: max |ldr diff| {diff} (bar "
        f"{ENTRY_TOL}), ldr {tuple(second.ldr.shape)}, hdr "
        f"{tuple(second.hdr.shape)}")
    if not diff <= ENTRY_TOL:
        fail(f"(k) {label}: engine tick != FrameLoop frame ({diff})")
    del e, loop, second, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_counts()
    lines = []
    t0 = time.perf_counter()
    with engine_log(lines):
        if setup is None:
            rc = main(argv)
        else:
            e = VQEngineTorch(argv, device=dev)
            setup(e)
            rc = e.run()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = dict(_backend.launches)
    plain = dict(_backend.plain_cuda_calls)
    if rc != 0:
        fail(f"(k) {label}: exit code {rc}")
    if max(plain.values()) != 0:
        fail(f"(k) {label}: plain versions ran on CUDA tensors: {plain}")
    files = ["loading.png", f"{scene}_frame{N_FRAMES:04d}.png",
             f"{scene}_hdr10.png"] + ([f"{scene}_{context[0]}.png"]
                                      if context is not None else [])
    missing = [f for f in files if not (out_dir / f).is_file()]
    if missing:
        fail(f"(k) {label}: the run wrote no {missing}")
    logged = [m for m in lines if "ms/frame avg" in m]
    if not logged:
        fail(f"(k) {label}: the engine logged no ms/frame")
    ms = float(re.search(r"\(([\d.]+) ms/frame avg", logged[-1]).group(1))
    say(f"[main] (k) {label}: exit code 0, wrote {files}; the engine's logged "
        f"ms/frame {ms:.3f} over {N_FRAMES} ticks (its host clock from the "
        f"first tick to the last frame's readback: '{logged[-1]}'); the whole "
        f"run {wall:.1f} s with the load and the dumps; peak device memory "
        f"{peak:.1f} MiB; launches {launches} ({({k: v / N_FRAMES for k, v in launches.items()})} "
        f"per tick) on {card}")
    return launches


def phase_engine_path(dev, card: str) -> dict:
    """(k) the engine shell: `python -m vqengine_tpu_torch -Test
    -TestFrames=16` in-process (__main__.main) on Sponza at 1920x1080 with
    the engine's defaults (MSAA, SSAO, motion, SSR, HDR on: the HDR10 dump
    runs), then the Default level at 1920x1080 with RenderScale 0.75 on the
    engine's graphics settings (1440x810 upscaled by FSR1 on every tick)
    and one render context ("debug", 960x540 from camera 1) -> launches of
    both runs."""
    sponza = engine_run(dev, card, "Sponza, engine defaults", "Sponza")
    context = ("debug", 960, 540, 1)

    def scaled(e):
        e.gfx.RenderScale = 0.75
        e.create_render_context(*context)
    default = engine_run(dev, card, "Default, RenderScale 0.75 (FSR1), a render "
                         "context", "Default", setup=scaled, context=context)
    return {k: sponza[k] + default[k] for k in sponza}


# (l): the sharded default frame. Bars of the reference's sharded renderer
# against its single-device frame (tests/test_multichip.py): with SSAO and
# SSR on, the mean and the 99th percentile of |ldr diff| (:222-223,
# :273-274); with them off, the share of pixels more than 1e-3 apart and
# the largest difference (:202-203: a band shift can flip an MSAA sample
# that sits an ulp from an edge, one 0.25 coverage step)
ML_SP = 3                 # 1080 / 3 = 360 rows, a multiple of 4
ML_FRAMES = 8             # timed frames per rank
SEAM_MEAN, SEAM_P99 = 3e-3, 0.05
EDGE_BAD, EDGE_SHARE, EDGE_MAX = 1e-3, 1e-3, 0.26


def sharded_flags() -> tuple[dict, dict]:
    """(the single-card render flags of path (g), the same frame's
    render_forward_sharded flags)."""
    from vqengine_tpu_torch.engine.settings import FGraphicsSettings, render_flags
    gf = dict(render_flags(FGraphicsSettings()), dynamic_item_ids=())
    if gf["shadow_filter"] != "esm" or gf["render_scale"] != 1.0:
        fail(f"(l) expects ESM maps at render scale 1: {gf}")
    keep = ("msaa", "enable_ssao", "ssao_quality", "enable_motion_vectors",
            "enable_ssr", "dynamic_item_ids")
    return gf, {k: gf[k] for k in keep}


def sponza_job(sponza, steps: list, runs: list) -> dict:
    """launch.render_job's job for Sponza as load_sponza's renderer holds
    it: the opaque part bucketed, the environment at the engine's sizes,
    the full-budget ESM maps from the first frame."""
    from vqengine_tpu_torch.render import graph
    from vqengine_tpu_torch.render.scene_buffers import split_transparent
    opaque, transparent = split_transparent(sponza.buffers)
    return dict(scene=graph.scene_fields_numpy(opaque),
                scene_t=(graph.scene_fields_numpy(transparent)
                         if transparent is not None else None),
                env=dict(equirect=sponza.equirect), textures=None,
                slots_used=graph.slots_used_of(sponza.buffers.materials),
                shadow_dims=graph.SHADOW_DIMS, width=W, height=H,
                steps=steps, runs=runs)


def sweep_consts_numpy(sponza, n: int, start: int = 0) -> list:
    """Frames start .. start + n - 1 of (g)'s yaw sweep as numpy frame
    constants, each frame's prev_view_proj the one before's."""
    from vqengine_tpu_torch.render.renderer import frame_constants_numpy
    cam = sponza.cameras[0]
    base_yaw, out, prev = cam.yaw, [], None
    for i in range(start, start + n):
        sweep_camera(cam, i, base_yaw)
        c = frame_constants_numpy(sponza.buffers, cam, sponza.lights,
                                  prev_view_proj=prev)
        out.append(c)
        prev = c["view_proj"]
    cam.yaw = base_yaw
    return out


def single_card_frames(renderer, consts_np: list, maps, flags: dict) -> list:
    """The single-card frames of these constants, the SSR history carried
    -> [ldr on the CPU]."""
    from vqengine_tpu_torch.render import graph
    out, hist = [], None
    for c in consts_np:
        o = renderer.render(graph.frame_constants_from_numpy(c, renderer.device),
                            W, H, shadow_maps=maps, ssr_history=hist, **flags)
        if int(o["overflow"].sum()):
            fail(f"(l) single-card frame overflow {o['overflow'].tolist()}")
        hist = o.get("ssr_history")
        out.append(o["ldr"].cpu())
    return out


def check_ranks(label: str, results: list, run: str) -> dict:
    """Print and check every rank's run: overflow 0 in every band, no plain
    version on CUDA tensors, its first frame's launches held against the
    plain versions -> the run's launches summed over the ranks."""
    total: dict = {}
    for i, r in enumerate(results):
        res = r["runs"][run]
        tag = f"[multigpu] {label}, rank {i} (dp {r['dp_index']}, band {r['band']})"
        if any(v for frame in res["overflow"] for row in frame for v in row):
            fail(f"{tag}: overflow {res['overflow']}")
        if max(res["plain"].values()) != 0:
            fail(f"{tag}: plain versions ran on CUDA tensors: {res['plain']}")
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
        ms = res["ms"]
        peak = ("" if res["peak_mib"] is None
                else f"; peak device memory {res['peak_mib']:.1f} MiB")
        say(f"{tag}: {len(ms)} frames, overflow 0 in the band; ms/frame "
            f"per step {[round(v, 3) for v in ms]} (CUDA events around each "
            f"step, collectives and host copies included){peak}; launches "
            f"{res['launches']}; first frame's launches held against their "
            f"plain versions {res['checked'] or 'none (not checked)'}")
    return total


def frame_bars(label: str, got: torch.Tensor, want: torch.Tensor,
               seams: bool) -> None:
    """Hold a gathered frame against the single-card one at the reference's
    bars; print each figure beside its bar."""
    d = (got.float() - want.float()).abs()
    if seams:
        mean = float(d.mean())
        p99 = float(torch.quantile(d.flatten(), 0.99))
        say(f"[multigpu] {label}: |ldr - single card| mean {mean:.6f} (bar "
            f"{SEAM_MEAN}), 99th percentile {p99:.6f} (bar {SEAM_P99}), max "
            f"{float(d.max()):.6f}")
        if not (mean < SEAM_MEAN and p99 < SEAM_P99):
            fail(f"{label}: mean {mean} / p99 {p99} past the bars")
    else:
        px = d.amax(dim=-1)
        share = float((px > EDGE_BAD).float().mean())
        mx = float(px.max())
        say(f"[multigpu] {label}: pixels more than {EDGE_BAD} apart "
            f"{share:.6f} of the frame (bar {EDGE_SHARE}), max {mx:.6f} (bar "
            f"{EDGE_MAX})")
        if not (share <= EDGE_SHARE and mx < EDGE_MAX):
            fail(f"{label}: share {share} / max {mx} past the bars")


def check_replicas(label: str, results: list, renderer, maps) -> None:
    """The ranks' environment tables and shadow maps, each built by the
    rank, bitwise equal across the ranks and to the single-card
    renderer's."""
    from vqengine_tpu_torch.parallel import launch
    want = {f"shadow.{k}": launch.digest(v) for k, v in maps.items()}
    env = renderer.env
    for name in ("equirect", "diffuse_cube", "brdf_lut", "sh_irradiance",
                 "brdf_poly"):
        want[f"env.{name}"] = launch.digest(getattr(env, name))
    for m, t in enumerate(env.specular_mips):
        want[f"env.specular_mip{m}"] = launch.digest(t)
    for i, r in enumerate(results):
        if r["digests"] != want:
            bad = sorted(k for k in want if r["digests"].get(k) != want[k])
            fail(f"{label}: rank {i}'s replicated tables differ: {bad}")
        pre = r.get("precompute_checked", {})
        if pre.get("raster_vis", (0,))[0] != 8:
            fail(f"{label}: rank {i}'s precompute checked {pre}")
    say(f"[multigpu] {label}: every rank's environment tables and shadow "
        f"maps ({len(want)} tables, built by each rank) bitwise equal across "
        f"the ranks and to the single-card renderer's; each rank's 8 K2 "
        f"precompute launches held against the plain version")


def band_stage_times(card: str, sponza, renderer) -> None:
    """What a band's binning, raster and MSAA edge resolve cost alone on the
    card (the main process, no rank running), band by band of (l): the
    band's rasters cover the frame's rows up to its end, and its edge
    resolve compacts at the whole frame's capacity. Each against the same
    stage of a band that covered its own rows only (band 0's raster) and
    compacted at its share of the capacity."""
    from vqengine_tpu_torch.ops import raster
    from vqengine_tpu_torch.render import graph
    c = renderer.build_frame_constants(sponza.buffers, sponza.cameras[0],
                                       sponza.lights)
    setup, extra = graph.geometry_setup_gbuf(renderer.scene, c, W, H)
    whole = raster.bin_triangles(setup, W, H, extra=extra)
    depth, tri_id, gbuf, cov = raster.rasterize_gbuf(whole, W, H, msaa=True)
    attrs, mask = graph._attrs_from_gbuf(renderer.scene, c, depth, tri_id,
                                         gbuf, W, H)
    records = raster.pack_records(setup, extra)
    obj = attrs["ids"][..., 0].to(torch.int32)
    hdr = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(3)
                     ).to(depth.device)
    bh = H // ML_SP
    t_whole = time_ms(lambda: raster.rasterize_gbuf(raster.bin_triangles(
        setup, W, H, extra=extra), W, H, msaa=True), 5)
    say(f"[multigpu] (l) band stages alone on the card (one process, frame 0 "
        f"of (g)'s sweep, CUDA events, mean of 5 after 2 warm-up, on {card}): "
        f"the whole frame's binning and MSAA raster {t_whole:.4f} ms")
    for band in range(ML_SP):
        y0 = band * bh
        end = raster.band_end(y0, bh, H)
        t_r = time_ms(lambda: raster.rasterize_gbuf_band(raster.bin_triangles(
            raster.rows_of_setup(setup, end), W, end, extra=extra), W, bh, y0,
            H, msaa=True), 5)
        idx = torch.arange(y0 - 1, y0 + bh + 1, device=depth.device).clamp(0, H - 1)
        halo = tuple(t[idx] for t in (tri_id, depth, obj, mask))
        rows = slice(y0, y0 + bh)
        a = {"ids": attrs["ids"][rows], "records": records,
             "wpos": attrs["wpos"][rows]}

        def edges(cap):
            return graph._msaa_edge_neighbor(
                a, tri_id[rows], depth[rows], mask[rows],
                cov[:, rows].contiguous(), hdr[rows], W, bh, halo=halo,
                hdr_halo=hdr[idx], cap=cap, y_offset=y0)
        cap_f, cap_b = graph.msaa_edge_cap(W, H), graph.msaa_edge_cap(W, bh)
        t_ef, t_eb = time_ms(lambda: edges(cap_f), 5), time_ms(lambda: edges(cap_b), 5)
        say(f"[multigpu] (l) band {band} (rows {y0}-{y0 + bh - 1}) alone: "
            f"binning and MSAA raster of the frame's rows 0-{end - 1} "
            f"{t_r:.4f} ms; neighbour edge resolve at the frame's capacity "
            f"{cap_f} {t_ef:.4f} ms, at the band's share {cap_b} {t_eb:.4f} ms")


def four_card_run(sponza, renderer, maps) -> dict:
    """(l) on four cards: Sponza 1080p with (g)'s flags on dp 2 x sp 2 NCCL
    ranks, one per card, two frames with the history carried; dp row 0
    renders frames 0-1 of (g)'s sweep and dp row 1 frames 8-9 (each row's
    views its own), each held against the single card's frames at the
    reference's bars -> the ranks' launches."""
    from vqengine_tpu_torch.parallel import launch
    gf, sf = sharded_flags()
    c2 = [sweep_consts_numpy(sponza, 2, start=8 * i) for i in range(2)]
    steps4 = [[c2[0][k], c2[1][k]] for k in range(2)]
    r4 = launch.run(launch.render_job, 2, 2, backend="nccl", device="cuda",
                    timeout=480, job=sponza_job(sponza, steps4, [dict(
                        name="full", flags=sf, steps=[0, 1], carry_ssr=True,
                        gather=True, check=True)]))
    got = check_ranks("(l) Sponza 1080p, dp 2 x sp 2, NCCL, one rank per "
                      "card", r4, "full")
    for i in range(2):
        ref = single_card_frames(renderer, c2[i], maps, gf)
        for f in range(2):
            frame_bars(f"(l) 4 cards, view {i} (sweep frame {8 * i + f})",
                       r4[0]["runs"]["full"]["frames"][f][0][i], ref[f], True)
    return got


def phase_multigpu(dev, card: str, sponza, renderer, st, rt) -> dict:
    """(l) the engine's default frame (g), sharded: Sponza 1920x1080 on dp 1
    x sp 3 gloo ranks that share cuda:0 (parallel/launch.py), two frames
    with the history carried (the first's launches held against their plain
    versions), ML_FRAMES timed frames, and two frames with SSAO and SSR
    off; the gathered frames against the single-card frames at the
    reference's bars. The translucent Sponza of (f) the same way, SSAO and
    SSR off (the transparent layers' and the edge resolve's bands against
    the single card's frame). The band stages alone on the card. Then the
    dryrun scene (entry.dryrun_multigpu's) at
    128x64 on dp 2 x sp 2: gloo ranks on the card against gloo ranks on the
    CPU; NCCL with one rank on cuda:0; and where there are four cards, Sponza
    on dp 2 x sp 2 over NCCL, one rank per card. -> the ranks' launches."""
    from vqengine_tpu_torch import entry
    from vqengine_tpu_torch.parallel import launch
    from vqengine_tpu_torch.render import graph
    gf, sf = sharded_flags()
    n_steps = 2 + ML_FRAMES
    consts = sweep_consts_numpy(sponza, n_steps)
    steps = [[c] for c in consts]
    off = dict(sf, enable_ssao=False, enable_ssr=False)
    runs = [dict(name="full", flags=sf, steps=[0, 1], carry_ssr=True,
                 gather=True, check=True),
            dict(name="timed", flags=sf, steps=list(range(2, n_steps)),
                 carry_ssr=True),
            dict(name="off", flags=off, steps=[0, 1], gather=True)]
    t0 = time.perf_counter()
    res = launch.run(launch.render_job, 1, ML_SP, backend="gloo", device=dev,
                     timeout=480, job=sponza_job(sponza, steps, runs))
    wall = time.perf_counter() - t0
    label = (f"(l) Sponza {W}x{H}, engine default frame, dp 1 x sp {ML_SP} "
             f"gloo ranks sharing {dev}")
    say(f"[multigpu] {label}: ranks spawned, built their scene, environment "
        f"and ESM maps and rendered {2 + ML_FRAMES + 2} frames each in "
        f"{wall:.1f} s (host clock, spawn included)")
    maps = renderer.precompute_shadow_maps(
        graph.frame_constants_from_numpy(consts[0], dev))
    check_replicas(label, res, renderer, maps)
    launches = {}
    for run in ("full", "timed", "off"):
        got = check_ranks(f"{label}, {run}", res, run)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    for r in res:
        chk = r["runs"]["full"]["checked"]
        if chk.get("raster_gbuf_msaa", (0,))[0] != 1 or chk.get("palette", (0,))[0] < 1:
            fail(f"{label}: first frame's checked launches {chk}")
    timed = [r["runs"]["timed"] for r in res]
    for i, t in enumerate(timed):
        if (t["launches"]["raster_gbuf_msaa"] != ML_FRAMES
                or t["launches"]["palette"] <= 0 or t["launches"]["raster_vis"]):
            fail(f"{label}: rank {i} timed launches {t['launches']}")
        ms = sorted(t["ms"])
        say(f"[multigpu] (l) rank {i} (band {res[i]['band']}): ms/frame "
            f"(CUDA events) mean {sum(ms) / len(ms):.3f}, median "
            f"{ms[len(ms) // 2]:.3f}, min {ms[0]:.3f}, max {ms[-1]:.3f}; peak "
            f"device memory {t['peak_mib']} MiB, on {card}; the "
            f"{ML_SP} ranks time-slice one card, so this is no scaling "
            f"figure")
    ref_full = single_card_frames(renderer, consts[:2], maps, gf)
    ref_off = single_card_frames(renderer, consts[:2], maps,
                                 dict(gf, enable_ssao=False, enable_ssr=False))
    for f in range(2):
        frame_bars(f"{label}, frame {f}, SSAO and SSR on",
                   res[0]["runs"]["full"]["frames"][f][0][0], ref_full[f], True)
        frame_bars(f"{label}, frame {f}, SSAO and SSR off (the MSAA edge "
                   f"resolve)", res[0]["runs"]["off"]["frames"][f][0][0],
                   ref_off[f], False)

    # the translucent Sponza of (f): two transparent layers (K1-bounded)
    # in every band, held with the edge resolve's bars
    t_consts = sweep_consts_numpy(st, 2)
    t_res = launch.run(launch.render_job, 1, ML_SP, backend="gloo", device=dev,
                       timeout=300, job=sponza_job(st, [[c] for c in t_consts], [
                           dict(name="translucent", flags=off, steps=[0, 1],
                                gather=True, check=True)]))
    t_label = (f"(l) translucent Sponza (f) {W}x{H}, dp 1 x sp {ML_SP} gloo "
               f"ranks sharing {dev}, SSAO and SSR off")
    t_maps = rt.precompute_shadow_maps(
        graph.frame_constants_from_numpy(t_consts[0], dev))
    check_replicas(t_label, t_res, rt, t_maps)
    got = check_ranks(t_label, t_res, "translucent")
    launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    for i, r in enumerate(t_res):
        run_ = r["runs"]["translucent"]
        if (run_["checked"].get("raster_gbuf_bounded", (0,))[0] != 2
                or run_["launches"]["raster_gbuf_bounded"] != 2):
            fail(f"{t_label}: rank {i}'s transparent layers {run_['checked']} "
                 f"{run_['launches']}")
    ref_t = single_card_frames(rt, t_consts, t_maps,
                               dict(gf, enable_ssao=False, enable_ssr=False))
    for f in range(2):
        frame_bars(f"{t_label}, frame {f}",
                   t_res[0]["runs"]["translucent"]["frames"][f][0][0],
                   ref_t[f], False)
    band_stage_times(card, sponza, renderer)

    # the dryrun scene at 128x64, dp 2 x sp 2: the card's ranks against the
    # CPU's
    job = entry.dryrun_job(2, 2)
    g_res = launch.run(launch.render_job, 2, 2, backend="gloo", device=dev,
                       timeout=300, job=job)
    got = check_ranks("dryrun 128x64, dp 2 x sp 2, gloo on the card",
                      g_res, "dryrun")
    launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    job["runs"][0]["check"] = False
    c_res = launch.run(launch.render_job, 2, 2, backend="gloo", device="cpu",
                       timeout=300, job=job)
    g_run, c_run = g_res[0]["runs"]["dryrun"], c_res[0]["runs"]["dryrun"]
    for f, (a, b) in enumerate(zip(g_run["frames"], c_run["frames"])):
        errs = {"ldr": float((a[0] - b[0]).abs().max()),
                "ao": float((g_run["ao"][f] - c_run["ao"][f]).abs().max()),
                "motion": float((g_run["motion"][f]
                                 - c_run["motion"][f]).abs().max()),
                "SSR history": float((a[2] - b[2]).abs().max())}
        bars = {"ldr": ENTRY_TOL, "ao": AO_TOL, "motion": MOTION_TOL,
                "SSR history": HIST_TOL}
        say(f"[multigpu] dryrun 128x64, dp 2 x sp 2, frame {f}: card ranks vs "
            f"CPU ranks, max |diff|: "
            + ", ".join(f"{k} {v:.3e} (bar {bars[k]})" for k, v in errs.items())
            + f"; depth {float((a[1] - b[1]).abs().max()):.3e}")
        if any(errs[k] > bars[k] for k in errs):
            fail(f"dryrun card vs CPU frame {f}: {errs}")

    # NCCL: one rank on cuda:0 (its init and the all_gathers on device
    # tensors); four cards: Sponza on dp 2 x sp 2, one rank per card
    n_res = launch.run(launch.render_job, 1, 1, backend="nccl", device="cuda",
                       timeout=240, job=entry.dryrun_job(1, 1))
    got = check_ranks("dryrun 128x32, dp 1 x sp 1, NCCL on cuda:0", n_res,
                      "dryrun")
    launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    cards = torch.cuda.device_count()
    if cards >= 4:
        got = four_card_run(sponza, renderer, maps)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    else:
        say(f"[multigpu] the four-card NCCL run (Sponza 1080p, dp 2 x sp 2, "
            f"one rank per card) was not run: torch.cuda.device_count() is "
            f"{cards}")
    say(f"[multigpu] every rank above found neither jax nor vqengine_tpu in "
        f"its sys.modules before it exited (parallel/launch.py)")
    say(f"[multigpu] launches of the ranks' runs (first frames' checked "
        f"launches excluded): {launches}")
    return launches


def check_imports() -> None:
    bad = sorted(m for m in sys.modules if m in ("jax", "vqengine_tpu")
                 or m.startswith(("jax.", "vqengine_tpu.")))
    if bad:
        fail(f"the port imported {bad}")


def main() -> None:
    t0 = time.perf_counter()

    def timed(label: str, fn, *args):
        """Run one phase and print the seconds since the start."""
        out = fn(*args)
        say(f"[time] {label} done at {time.perf_counter() - t0:.1f} s")
        return out
    card = phase_device()
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    timed("native", phase_native, card)
    sponza, renderer = timed("Sponza", load_sponza, dev)
    st, rt = timed("translucent Sponza", load_sponza, dev, True)
    k3 = timed("K3", phase_palette, dev, sponza, renderer)
    k1, k1_msaa = timed("K1, K1-MSAA", phase_raster, dev, sponza, renderer)
    k1_bounded, k1_msaa_bounded = timed("K1-bounded", phase_raster_bounded, dev,
                                        sponza, renderer, st, rt)
    timed("reject probes", phase_reject_probe, dev)
    k2, k2_msaa4 = timed("K2, K2-msaa4", phase_vis, dev, sponza, renderer)
    env_cpu = timed("environment", phase_environment, dev, card, sponza)
    timed("env frames card vs CPU", phase_env_card_vs_cpu, dev, env_cpu)
    timed("goldens", phase_goldens, dev)
    timed("shadow card vs CPU", phase_shadow_card_vs_cpu, dev)
    timed("MSAA card vs CPU", phase_msaa_card_vs_cpu, dev)
    timed("transparent card vs CPU", phase_transparent_card_vs_cpu, dev)
    timed("SSAO/SSR/motion card vs CPU", phase_post_card_vs_cpu, dev, env_cpu)
    timed("post tail card vs CPU", phase_post_tail_card_vs_cpu, dev)
    timed("textures card vs CPU", phase_texture_card_vs_cpu, dev)
    launches = timed("main paths (a)-(e)", phase_main_path, dev, card, sponza,
                     renderer)
    lt = timed("main path (f)", phase_transparent_path, card, st, rt)
    lg = timed("main path (g)", phase_default_path, dev, card, sponza, renderer)
    lh, stress = timed("main path (h)", phase_stress_path, dev, card)
    timed("tessellation card vs CPU", phase_tess_card_vs_cpu, dev)
    li, stresstest = timed("main path (i)", phase_stresstest_path, dev, card)
    lj, terrain = timed("main path (j)", phase_terrain_path, dev, card)
    lk = timed("main path (k)", phase_engine_path, dev, card)
    ll = timed("multi-GPU (l)", phase_multigpu, dev, card, sponza, renderer,
               st, rt)
    launches = {k: launches[k] + lt[k] + lg[k] + lh[k] + li[k] + lj[k] + lk[k]
                + ll.get(k, 0) for k in launches}
    if "--profile" in sys.argv[1:]:
        # timed before the traced frames, as phase_profile times its stages
        phase_profile_transparent(st, rt)
        phase_profile(sponza, renderer)
        phase_profile_stress(stress)
        phase_profile_tess(stresstest, terrain)
        phase_profile_engine(dev)
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
    say(f"[device] the whole run took {time.perf_counter() - t0:.1f} s (the "
        f"kernels' build included)")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
