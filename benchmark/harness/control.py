"""The correctness check's control: the reference itself, computed one
precision step below what the configuration states, put in the program's
place. The port runs f32 with TF32 off; the control turns TF32 on (matmuls
and convolutions), the step that would tempt a later change. It renders
the frames a run judges (the run's first frame, and each window frame a
run of this seed picks, from the control's own previous frame) and the
reference judges them as it judges the program's."""
from __future__ import annotations

from contextlib import contextmanager

import torch

from . import check
from .engine_cell import picks


@contextmanager
def tf32(on: bool):
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def readings(cell, seed: int, device: torch.device,
             env_sizes: dict | None = None) -> dict:
    """The worst of each compared number, for the control on this seed."""
    from reference.level import Level
    tr = cell.traffic
    warm = int(tr["warmup_ticks"])
    ticks = [warm + j for j in picks(seed, int(tr["check_frames"]),
                                     int(tr["check_within"]))]
    args = (cell.config["level"], tr["width"], tr["height"], device)
    with tf32(True):
        ctl = Level(*args, env_sizes=env_sizes)
        captures = []
        out = ctl.render(0, None)
        captures.append(check.Capture(0, out["ldr"].cpu(), None,
                                      _cpu(out["ssr_history"])))
        for k in ticks:
            prev = ctl.render(k - 1, None)["ssr_history"]
            out = ctl.render(k, prev)
            captures.append(check.Capture(k, out["ldr"].cpu(), _cpu(prev),
                                          _cpu(out["ssr_history"])))
        del ctl, out, prev
    ref = Level(*args, env_sizes=env_sizes)
    return check.judge(captures, ref)


def _cpu(t):
    return t.cpu() if t is not None else None
