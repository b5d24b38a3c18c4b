"""The port's own spans and sync counters, on exactly while a torch.profiler
session records (``torch.autograd._profiler_enabled()``).

    with torch.profiler.profile(activities=[...]):
        for _ in range(n):
            engine.tick()
    torch.cuda.synchronize()
    print(trace.summary())

A span (``span(name, device)``) opens a ``torch.profiler.record_function``
of its name, so the profiler's chrome trace stamps it on the kernels' clock,
and records its name, its parent span, the tick it belongs to (the count of
``tick()`` spans opened so far) and its host start and end
(``perf_counter_ns``). Given a CUDA device it also records a CUDA event pair
on the device's current stream: the pair's elapsed time is the span's share
of the device timeline, from the device reaching the span's work to the
device finishing it, idle included. The port runs on one stream, so
consecutive spans partition it. The events are resolved only when
``summary()`` reads them, after the caller's synchronize: the tracer never
synchronizes.

``blocking(site, syncs)`` wraps a host operation that waits for the device
(a read of a device value, ``nonzero``, ``bincount``, a pageable upload):
it counts the site's synchronizations and the host ns spent in it, under a
``vq.sync.<site>`` annotation.

With no profiler recording, ``span`` and ``blocking`` cost one flag check
and return a shared do-nothing context: no annotation, no event, no
allocation. Spans are opened by the thread that drives the device.
"""
from __future__ import annotations

import time

import torch

_recording = torch.autograd._profiler_enabled
_now = time.perf_counter_ns

TICK = "vq.tick"


class _Off:
    """The context of a span or sync site while no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Tracer:
    """Spans and sync counts of the profiled window since the last reset.
    spans: [name, parent index (-1 at the top), tick, host start ns, host
    end ns (0 while open), start event, end event (None without a CUDA
    device)]; syncs: {site: [synchronizations, host ns blocked]}."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.spans: list[list] = []
        self.syncs: dict[str, list[int]] = {}
        self.ticks = 0
        self._open: list[int] = []

    def summary(self) -> dict:
        """{"ticks": tick spans opened, "spans": {name: {"count", "host_ms",
        "device_ms"}}, "syncs": {site: {"count", "wait_ms"}}}. device_ms is
        None for a span with no event pair; a pair the device has not
        reached yet is left out (synchronize first)."""
        spans: dict[str, dict] = {}
        for name, _, _, t0, t1, ev0, ev1 in self.spans:
            if not t1:
                continue
            s = spans.setdefault(name, {"count": 0, "host_ms": 0.0,
                                        "device_ms": None})
            s["count"] += 1
            s["host_ms"] += (t1 - t0) / 1e6
            if ev1 is not None and ev1.query():
                s["device_ms"] = (s["device_ms"] or 0.0) + ev0.elapsed_time(ev1)
        syncs = {site: {"count": n, "wait_ms": ns / 1e6}
                 for site, (n, ns) in self.syncs.items()}
        return {"ticks": self.ticks, "spans": spans, "syncs": syncs}


class _Span:
    __slots__ = ("tracer", "name", "stream", "is_tick", "rf", "rec")

    def __init__(self, tracer: Tracer, name: str, stream, is_tick: bool):
        self.tracer, self.name, self.stream = tracer, name, stream
        self.is_tick = is_tick

    def __enter__(self):
        tr = self.tracer
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.is_tick:
            tr.ticks += 1
        ev0 = ev1 = None
        if self.stream is not None:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record(self.stream)
        self.rec = [self.name, tr._open[-1] if tr._open else -1, tr.ticks,
                    _now(), 0, ev0, ev1]
        tr._open.append(len(tr.spans))
        tr.spans.append(self.rec)

    def __exit__(self, *exc):
        rec = self.rec
        if rec[6] is not None:
            rec[6].record(self.stream)
        rec[4] = _now()
        self.tracer._open.pop()
        return self.rf.__exit__(*exc)


class _Blocking:
    __slots__ = ("tracer", "site", "n", "rf", "t0")

    def __init__(self, tracer: Tracer, site: str, n: int):
        self.tracer, self.site, self.n = tracer, site, n

    def __enter__(self):
        self.rf = torch.profiler.record_function("vq.sync." + self.site)
        self.rf.__enter__()
        self.t0 = _now()

    def __exit__(self, *exc):
        dt = _now() - self.t0
        c = self.tracer.syncs.setdefault(self.site, [0, 0])
        c[0] += self.n
        c[1] += dt
        return self.rf.__exit__(*exc)


TRACER = Tracer()


def span(name: str, device: torch.device | None = None):
    """A span of the profiled window (a no-op without a profiler); with a
    CUDA device, timed on the device too."""
    if not _recording():
        return _OFF
    stream = (torch.cuda.current_stream(device)
              if device is not None and device.type == "cuda" else None)
    return _Span(TRACER, name, stream, False)


def tick():
    """The span of one engine tick: the spans inside it share its number."""
    if not _recording():
        return _OFF
    return _Span(TRACER, TICK, None, True)


def blocking(site: str, syncs: int = 1):
    """A host wait on the device at `site`, which synchronizes `syncs`
    times (a no-op without a profiler)."""
    if not _recording():
        return _OFF
    return _Blocking(TRACER, site, syncs)


def read_int(t: torch.Tensor, site: str) -> int:
    """int(t), counted as one blocking read at `site`."""
    with blocking(site):
        return int(t)


def summary() -> dict:
    return TRACER.summary()


def reset() -> None:
    TRACER.reset()
