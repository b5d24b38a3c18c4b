"""Launch the ranks of a multi-GPU render (parallel/multichip.py): dp x sp
processes started with the "spawn" method and a file:// rendezvous in a
temporary directory, each rank running one task of this package (so that a
spawned rank can import it, whatever started the launcher), its result
returned to the caller. There is no fallback: a rank's failure, a
collective's error or the time limit kills every rank and raises.

    from vqengine_tpu_torch.parallel import launch
    results = launch.run(launch.render_job, dp=1, sp=3, backend="gloo",
                         device="cuda", timeout=600, job=job)

render_job is the task the entry points and the smoke use: it builds the
scene, environment, textures and shadow maps on the rank's device from
the job's numpy inputs (the replicated resources; nothing is broadcast)
and renders the job's runs through multichip.render_forward_sharded.
"""
from __future__ import annotations

import contextlib
import datetime
import hashlib
import os
import socket
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from multiprocessing import connection as mp_connection

from ..ops import _backend, launch_check
from ..ops import texture as tex_ops
from ..render import graph
from . import multichip

FORBIDDEN_MODULES = ("jax", "vqengine_tpu")


def _loopback_if_unresolved(backend: str) -> None:
    """gloo finds its interface by the host's name; where that name does not
    resolve to an address of this machine (a sealed machine), name the
    loopback interface for these single-host ranks and say so."""
    if backend != "gloo" or "GLOO_SOCKET_IFNAME" in os.environ:
        return
    try:
        with socket.socket() as s:
            s.bind((socket.gethostbyname(socket.gethostname()), 0))
    except OSError:
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        warnings.warn("gloo: the host's name does not resolve to a local "
                      "address; the ranks use the loopback interface "
                      "(GLOO_SOCKET_IFNAME=lo)")


def _imported_forbidden() -> list[str]:
    return sorted(m for m in sys.modules if m in FORBIDDEN_MODULES
                  or m.startswith(tuple(f + "." for f in FORBIDDEN_MODULES)))


def _rank_main(rank: int, world: int, dp: int, sp: int, backend: str,
               device: str, init: str, out_dir: str, timeout: float) -> None:
    """One rank: load the task, join the group, build its Mesh, run the
    task, check that neither jax nor the JAX package was imported, save
    the result; on any error save the traceback and exit non-zero."""
    try:
        task, kwargs = torch.load(Path(out_dir) / "task.pt", weights_only=False)
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout),
                                **kw)
        try:
            mesh = multichip.make_mesh(dp, sp, backend, device)
            result = task(mesh, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        bad = _imported_forbidden()
        if bad:
            raise RuntimeError(f"rank {rank} imported {bad}")
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)


def run(task, dp: int, sp: int, backend: str, device,
        timeout: float = 300.0, **kwargs) -> list:
    """Run task(mesh, **kwargs) on dp x sp spawned ranks and return their
    results, by rank. The caller names the backend and the device (no
    default): "nccl" takes one card per rank (and raises with fewer
    cards); "gloo" runs every rank on `device` ("cpu", or the one card the
    ranks share). The CUDA kernels are built here, once,
    before the ranks start. Waits at most `timeout` seconds: past it, or as
    soon as a rank fails, every rank is killed and this raises
    (RuntimeError with the failing rank's traceback, or TimeoutError)."""
    world = dp * sp
    dev = torch.device(device)
    if backend == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(f"nccl: {world} ranks need one card each, "
                           f"{torch.cuda.device_count()} found")
    if dev.type == "cuda" or backend == "nccl":
        _backend.library()
    _loopback_if_unresolved(backend)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="vq_ranks_") as tmp:
        init = Path(tmp, "rendezvous").as_uri()
        # the task and its inputs go through a file: a rank that dies while
        # it starts cannot leave the parent blocked on a full spawn pipe
        torch.save((task, kwargs), Path(tmp) / "task.pt")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, dp, sp, backend, str(device),
                                   init, tmp, timeout))
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    r = failed[0]
                    err = Path(tmp, f"rank{r}.err")
                    raise RuntimeError(
                        f"rank {r} of {world} ({dp}x{sp}, {backend} on "
                        f"{device}) failed with exit code {codes[r]}:\n"
                        + (err.read_text() if err.is_file() else
                           "(no traceback: the rank died before its task)"))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks ({dp}x{sp}, {backend} "
                                       f"on {device}) still running after "
                                       f"{timeout} s")
                mp_connection.wait([p.sentinel for p in procs
                                    if p.exitcode is None], timeout=0.5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (bitwise identity across ranks)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def render_job(mesh: multichip.Mesh, job: dict) -> dict:
    """Build the job's replicated resources on the rank's device, then render
    its runs.

    job: "scene" (fields, num_tris_live) of graph.scene_fields_numpy, and
    optionally "scene_t" the same of the transparent part; "env" (the
    equirect and build_environment's sizes) or None; "textures" (mip
    arrays for texture.pack_texture_quads) or None; "slots_used";
    "shadow_dims" (render_shadow_maps from the first step's first frame,
    ESM) or None; "width", "height"; "steps", a list of frame batches
    (each B frame-constant dicts of numpy leaves, B a multiple of dp); and
    "runs", each dict(name, flags (render_forward_sharded's), steps (step
    indices, rendered in order), carry_ssr (carry the history from step
    to step, zeros first), gather (return the gathered frames of each
    step), check (hold every kernel launch of the first step, and of the
    shadow precompute, against its plain version; CUDA only)).
    -> dict(digests of the environment tables and shadow maps, band,
    runs: {name: dict(ms [per step, CUDA events or host clock], overflow
    [per step, per frame], launches, plain, checked, frames (gathered
    (ldr, depth[, history]) per step, rank 0 only), ao and motion
    (gathered per step, where their passes ran; rank 0 only),
    peak_mib)})."""
    dev = mesh.device
    fields, tl = job["scene"]
    scene = graph.device_scene_from_numpy(fields, tl, dev)
    scene_t = (graph.device_scene_from_numpy(*job["scene_t"], dev)
               if job.get("scene_t") else None)
    env = None
    if job.get("env") is not None:
        e = dict(job["env"])
        env = graph.build_environment(e.pop("equirect"), dev, **e)
    textures = (tex_ops.pack_texture_quads(job["textures"], dev)
                if job.get("textures") is not None else None)
    steps = [multichip.stack_frame_constants(
        [graph.frame_constants_from_numpy(c, dev) for c in step])
        for step in job["steps"]]
    width, height = job["width"], job["height"]
    out = {"band": mesh.band, "dp_index": mesh.dp_index, "runs": {},
           "digests": {}}
    checking = any(r.get("check") for r in job["runs"]) and dev.type == "cuda"
    shadow_maps = None
    if job.get("shadow_dims") is not None:
        found: dict = {}
        ctx = (launch_check.checked_launches(found) if checking
               else contextlib.nullcontext())
        with ctx:
            shadow_maps = graph.render_shadow_maps(
                scene, multichip.frame_of(steps[0], 0), job["shadow_dims"])
            _sync(dev)
        out["precompute_checked"] = _found_text(found)
    if env is not None:
        for name in ("equirect", "diffuse_cube", "brdf_lut", "sh_irradiance",
                     "brdf_poly"):
            out["digests"][f"env.{name}"] = digest(getattr(env, name))
        for m, t in enumerate(env.specular_mips):
            out["digests"][f"env.specular_mip{m}"] = digest(t)
    for k, t in (shadow_maps or {}).items():
        out["digests"][f"shadow.{k}"] = digest(t)
    for run_ in job["runs"]:
        out["runs"][run_["name"]] = _render_run(
            mesh, run_, steps, scene, scene_t, env, textures, shadow_maps,
            width, height, job.get("slots_used"))
    return out


def _found_text(found: dict) -> dict:
    return {k: (n, err) for k, (n, err, _) in found.items()}


def _render_run(mesh, run_: dict, steps: list, scene, scene_t, env, textures,
                shadow_maps, width: int, height: int, slots_used) -> dict:
    dev = mesh.device
    flags = dict(run_["flags"])
    hist = None
    if run_.get("carry_ssr") and flags.get("enable_ssr"):
        b = int(steps[run_["steps"][0]].world.shape[0])
        hist = multichip.shard_history(
            torch.zeros((b, height // 2, width // 2, 7)), mesh)
    res = {"ms": [], "overflow": [], "frames": []}
    found: dict = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _backend.reset_counts()
    for k, s in enumerate(run_["steps"]):
        checking = run_.get("check") and k == 0 and dev.type == "cuda"
        if k == 1 and run_.get("check"):
            # the checked step's launches (and its plain versions) are not
            # the run's
            _sync(dev)
            _backend.reset_counts()
        ctx = (launch_check.checked_launches(found) if checking
               else contextlib.nullcontext())
        stats: dict = {}
        with ctx:
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            outs = multichip.render_forward_sharded(
                mesh, scene, steps[s], width, height, env=env,
                shadow_maps=shadow_maps, textures=textures,
                slots_used=slots_used, scene_transparent=scene_t,
                ssr_history=hist, stats=stats, **flags)
            if dev.type == "cuda":
                end.record()
                torch.cuda.synchronize(dev)
                res["ms"].append(start.elapsed_time(end))
            else:
                res["ms"].append((time.perf_counter() - t0) * 1e3)
        if hist is not None:
            hist = outs[2]
        for t in outs:
            if not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"{run_['name']} step {s}: band "
                                   f"{mesh.band} output not finite")
        res["overflow"].append(stats["overflow"].cpu().tolist())
        if run_.get("gather"):
            frames = multichip.gather_frames(mesh, *outs)
            extra = {k: multichip.gather_frames(mesh, stats[k])[0]
                     for k in ("ao", "motion") if k in stats}
            if mesh.rank == 0:
                res["frames"].append(tuple(f.cpu() for f in frames))
                for k, v in extra.items():
                    res.setdefault(k, []).append(v.cpu())
    _sync(dev)
    res["launches"] = dict(_backend.launches)
    res["plain"] = dict(_backend.plain_cuda_calls)
    res["checked"] = _found_text(found)
    res["peak_mib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                       if dev.type == "cuda" else None)
    return res

