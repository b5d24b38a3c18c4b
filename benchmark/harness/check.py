"""Whether the frames the timed ticks produced are right: each captured
frame against the reference's render of the same tick from the same SSR
history (reference/level.py).

Numbers, the worst over the captured frames; a cell compares those its
limits/<cell>.json gives a limit (the others are reported, not compared):
  ldr_mean_gap   mean |program - reference| over the presented frame's
                 pixels and channels
  ldr_max_gap    the widest |program - reference| of any pixel's channel
  hist_mean_gap  mean |program - reference| of the new SSR history over
                 the mean |reference|
A number that is not finite (a NaN or an infinity on either side), or a
history on one side only, reads inf, so it fails any limit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

NUMBERS = ("ldr_mean_gap", "ldr_max_gap", "hist_mean_gap")


@dataclass
class Capture:
    tick: int                    # the run's tick (0 = the first frame)
    ldr: torch.Tensor            # [H, W, 3], as presented
    hist_in: torch.Tensor | None  # the SSR history the frame started from
    hist_out: torch.Tensor | None


def gaps(ldr: torch.Tensor, ref_ldr: torch.Tensor, hist, ref_hist) -> dict:
    d = (ldr.to(ref_ldr.device, torch.float32) - ref_ldr).abs()
    out = {"ldr_mean_gap": float(d.mean()), "ldr_max_gap": float(d.max())}
    out["hist_mean_gap"] = 0.0
    if (hist is None) != (ref_hist is None):
        out["hist_mean_gap"] = math.inf
    elif ref_hist is not None:
        dh = (hist.to(ref_hist.device) - ref_hist).abs().mean()
        out["hist_mean_gap"] = float(dh / ref_hist.abs().mean().clamp_min(1e-30))
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def judge(captures: list[Capture], level) -> dict:
    """The worst of each number over the captures, in tick order."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for c in sorted(captures, key=lambda c: c.tick):
        hist_in = (c.hist_in.to(level.device) if c.hist_in is not None
                   else None)
        ref = level.render(c.tick, hist_in)
        g = gaps(c.ldr, ref["ldr"], c.hist_out, ref["ssr_history"])
        for k, v in g.items():
            worst[k] = max(worst[k], v)
        del ref
    return worst


def verdict(worst: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every compared number within its limit, {name: [number,
    limit]} of the compared ones). A cell that compares nothing fails."""
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise KeyError(f"limits for unknown numbers: {sorted(unknown)}")
    checks = {k: [worst[k], limits[k]] for k in NUMBERS if k in limits}
    ok = bool(checks) and all(v <= lim for v, lim in checks.values())
    return ok, checks
