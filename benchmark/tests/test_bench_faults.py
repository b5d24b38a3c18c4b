"""A run with the timed path broken underneath comes out not correct.

Drives the one-card cell's run (harness/engine_cell.run and the report's
judge) on the CPU, past the harness's look for a card, at 96x64 with small
environment and shadow maps on both sides, with each fault the cell can
have planted in the program: the SSR history returned unchanged (a step
that returns its state unchanged), half of the frame's rows left out, a
block of pixels altered where the frame is produced, a NaN in the first
frame (a warm-up frame, which `failed` does not count) and a NaN in the
history. The cell's own limits judge."""
import time

import pytest
import torch

from harness import engine_cell, report, spec

SMALL_ENV = dict(diffuse_size=4, specular_base=8, lut_size=16)
SMALL_MAPS = (64, 64, 64)


def _history_unchanged(out, flags):
    if flags.get("ssr_history") is not None:
        out["ssr_history"] = flags["ssr_history"]


def _half_rows(out, flags):
    out["ldr"] = out["ldr"].clone()
    out["ldr"][out["ldr"].shape[0] // 2:] = 0.0


def _block_altered(out, flags):
    out["ldr"] = out["ldr"].clone()
    out["ldr"][8:12, 8:12] = 1.0 - out["ldr"][8:12, 8:12]


def _nan_first_frame(out, flags):
    if flags.get("ssr_history") is None:
        out["ldr"] = out["ldr"].clone()
        out["ldr"][3, 5, 1] = float("nan")


def _nan_history(out, flags):
    if out.get("ssr_history") is not None:
        out["ssr_history"] = out["ssr_history"].clone()
        out["ssr_history"].view(-1)[7] = float("nan")


FAULTS = {"none": None, "history_unchanged": _history_unchanged,
          "half_rows": _half_rows, "block_altered": _block_altered,
          "nan_first_frame": _nan_first_frame, "nan_history": _nan_history}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell_name", ["sponza-4k-autotest",
                                       "stresstest-4k-autotest"])
def test_fault_is_not_correct(fault, cell_name, monkeypatch):
    from vqengine_tpu_torch.engine import engine as engine_mod
    from vqengine_tpu_torch.render.renderer import VQRendererTorch
    import reference.level as ref_level
    torch.set_num_threads(4)
    for mod in (engine_mod, ref_level):
        flags_of = mod.render_flags
        monkeypatch.setattr(mod, "render_flags", lambda gfx, f=flags_of: {
            **f(gfx), "shadow_dims": SMALL_MAPS})
    f = FAULTS[fault]
    if f is not None:
        render = VQRendererTorch.render

        def broken(self, consts, width, height, **kw):
            out = render(self, consts, width, height, **kw)
            f(out, kw)
            return out
        monkeypatch.setattr(VQRendererTorch, "render", broken)
    cell = spec.cell(cell_name)
    cell.traffic.update(width=96, height=64, warmup_ticks=2, check_within=3)
    res = engine_cell.run(cell, 2 ** 31 + 4242, 0.5, False,
                          torch.device("cpu"), time.perf_counter(),
                          env_sizes=SMALL_ENV)
    correct, checks = report.judge(cell, res)
    assert correct == (fault == "none"), checks
