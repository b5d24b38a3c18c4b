"""A one-card cell: the engine's tick (VQEngineTorch.tick) on the
configuration's level at the traffic's resolution, as the engine's
automated -Test run drives it: camera 0, no input, ticks back to back.

Set-up: the engine, the level's load (the environment maps with it) and
the warm-up ticks, the first of which precomputes the static casters'
maps and builds the kernels on a fresh checkout. The window: ticks until
`seconds` have passed, each frame's end marked by a CUDA event. With
trace, a short window of `trace_frames` ticks runs under torch.profiler
instead, with the harness's spans around the tick and the renderer's
render. After the window: the peak memory, then the captured frames
against the reference (harness/check.py).
"""
from __future__ import annotations

import gc
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from . import check, frames, trace as trace_mod
from .clock import FrameClock, sync


@contextmanager
def spanned(obj, attr: str, name: str, totals: dict):
    """Wrap obj.attr (an instance attribute) in a profiler span and a host
    clock; totals[name] collects its seconds."""
    fn = getattr(obj, attr)
    totals[name] = 0.0

    def wrapped(*a, **kw):
        t = time.perf_counter()
        with torch.profiler.record_function(name):
            out = fn(*a, **kw)
        totals[name] += time.perf_counter() - t
        return out
    setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        delattr(obj, attr)


def check_settings(gfx, wanted: dict) -> None:
    """The configuration states the graphics settings it is run with; the
    engine has read them from Data/EngineSettings.ini."""
    for key, value in wanted.items():
        if getattr(gfx, key) != value:
            raise RuntimeError(f"engine setting {key} = {getattr(gfx, key)!r}, "
                               f"the configuration states {value!r}")


def picks(seed: int, n: int, within: int) -> list[int]:
    """The window frames whose output is judged: n drawn from the seed
    among the first `within`, never the first."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    return sorted(int(i) for i in rng.choice(np.arange(1, within), n,
                                             replace=False))


def load_engine(cell, device: torch.device, env_sizes: dict | None = None):
    """The engine at the traffic's size with the configuration's level
    loaded (the environment maps with it) -> (engine, seconds the load
    took). env_sizes: smaller environment maps, for a CPU rehearsal."""
    from vqengine_tpu_torch.engine.engine import VQEngineTorch
    cfg, tr = cell.config, cell.traffic
    engine = VQEngineTorch([f"-W={tr['width']}", f"-H={tr['height']}"],
                           device=device)
    check_settings(engine.gfx, cfg["graphics"])
    if env_sizes:
        build = engine._build_environment_maps
        engine._build_environment_maps = lambda eq: build(eq, **env_sizes)
    t = time.perf_counter()
    if not engine.start_loading_scene(cfg["level"]):
        raise RuntimeError(f"level {cfg['level']} did not load")
    sync(device)
    return engine, time.perf_counter() - t


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, env_sizes: dict | None = None) -> dict:
    tr = cell.traffic
    engine, load_s = load_engine(cell, device, env_sizes)
    ticks = 0
    bad = torch.zeros((), dtype=torch.int64, device=device)
    captures: list[check.Capture] = []

    def tick(capture: bool, count: bool) -> None:
        nonlocal bad, ticks
        hist_in = engine.loop.ssr_history
        out = engine.tick()
        if count:
            bad = bad + ((out.overflow.sum() > 0)
                         | ~torch.isfinite(out.ldr).all()).to(torch.int64)
        if capture:
            captures.append(check.Capture(ticks, out.ldr, hist_in,
                                          engine.loop.ssr_history))
        ticks += 1

    for i in range(int(tr["warmup_ticks"])):
        tick(capture=i == 0, count=False)
    sync(device)
    setup_s = time.perf_counter() - t0
    n_check = int(tr["check_frames"])
    clock = FrameClock(device)
    result: dict = {"setup_s": setup_s, "load_s": load_s, "device": device,
                    "env_sizes": env_sizes}
    if not trace:
        chosen = picks(seed, n_check, int(tr["check_within"]))
        clock.start()
        tw = time.perf_counter()
        j = 0
        while j <= chosen[-1] or time.perf_counter() - tw < seconds:
            tick(capture=j in chosen, count=True)
            clock.mark()
            j += 1
        ends = clock.ends_ms()
        result.update(frames=j, frame_ms=frames.frame_ms(ends),
                      frame_ms_p90=frames.frame_ms_p90(ends))
    else:
        n = int(tr["trace_frames"])
        chosen = picks(seed, n_check, n)
        totals: dict = {}
        with tempfile.TemporaryDirectory() as tmp:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with spanned(engine, "tick", "tick", totals), \
                    spanned(engine.renderer, "render", "render", totals), \
                    torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("window"):
                    for j in range(n):
                        tick(capture=j in chosen, count=True)
                    sync(device)
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
            events = trace_mod.load(path)
        win = trace_mod.window(events, "window")
        del events
        result.update(frames=n, window=win, busy_ms=win.busy_ms,
                      window_ms=win.ms,
                      host_ms=(totals["tick"] - totals["render"]) / n * 1e3)
    sync(device)
    result["failed"] = int(bad)
    result["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                            if device.type == "cuda" else 0)
    for c in captures:
        c.ldr = c.ldr.cpu()
        c.hist_in = c.hist_in.cpu() if c.hist_in is not None else None
        c.hist_out = c.hist_out.cpu() if c.hist_out is not None else None
    del engine, tick
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["captures"] = captures
    return result
