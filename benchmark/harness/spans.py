"""The program's own spans and sync counters (vqengine_tpu_torch.utils.trace),
which record while the traced window's profiler runs: per tick, the host or
device ms of named spans and the blocking reads. Every reader returns None
where the program has no tracer (ImportError) or it recorded no tick."""
from __future__ import annotations

import importlib


def summary() -> dict | None:
    """The tracer's summary of the traced window, or None."""
    try:
        trace = importlib.import_module("vqengine_tpu_torch.utils.trace")
    except ImportError:
        return None
    s = trace.summary()
    return s if s.get("ticks") else None


def host_ms(name: str) -> float | None:
    """Host ms a tick in the span `name`; None where it never opened."""
    s = summary()
    if s is None or name not in s["spans"]:
        return None
    return s["spans"][name]["host_ms"] / s["ticks"]


def device_ms(names) -> float | None:
    """Device ms a tick in the spans `names` (CUDA event pairs); None
    where none of them has a device time."""
    s = summary()
    if s is None:
        return None
    ms = [s["spans"][n]["device_ms"] for n in names if n in s["spans"]]
    ms = [m for m in ms if m is not None]
    return sum(ms) / s["ticks"] if ms else None


def syncs() -> tuple[float, float] | None:
    """(synchronizations, host ms blocked in them) a tick, all sites."""
    s = summary()
    if s is None:
        return None
    sites = s["syncs"].values()
    return (sum(v["count"] for v in sites) / s["ticks"],
            sum(v["wait_ms"] for v in sites) / s["ticks"])
