"""Frame pacing from the device's frame-end times.

The window's CUDA events give, after one synchronize, the time from the
window's start event to each frame's end event. frame_ms is the window's
length over the frames completed in it; frame_ms_p90 the 90th percentile
of the intervals between consecutive frame ends (the first from the
window's start), as a player sees the frames arrive.
"""
from __future__ import annotations

import statistics


def intervals(ends_ms: list[float]) -> list[float]:
    """Frame-end times from the window's start -> the frames' intervals."""
    out, prev = [], 0.0
    for t in ends_ms:
        out.append(t - prev)
        prev = t
    return out


def frame_ms(ends_ms: list[float]) -> float:
    return ends_ms[-1] / len(ends_ms)


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0 < q < 100), linear between closest ranks
    (numpy's default), of at least one value."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def frame_ms_p90(ends_ms: list[float]) -> float:
    return percentile(intervals(ends_ms), 90.0)


def spread(values: list[float]) -> float:
    """Quartile distance over the median (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
