"""The goldens the port renders so far: render a scene with the golden
setup and score it against ``tests/goldens/<name>.png``.

The setup and the bars are those of the reference's golden test
(tests/test_golden.py:151-245): 192x108, the scene's own camera, light
gizmos on, the scene's environment maps built at load at the engine's
default sizes; SSIM >= 0.985, mean MAE < 0.01 and worst 16x16 block MAE
< 0.08 (PNG quantization noise floor ~0.004).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..render.renderer import VQRendererTorch
from ..utils.image_io import read_png
from ..utils.ssim import ssim
from .scene_load import load_scene

GOLDEN_DIR = Path(__file__).resolve().parent.parent.parent / "tests" / "goldens"
WIDTH, HEIGHT = 192, 108
# golden -> (scene, render flags), as tests/test_golden.py configures them
SCENES = {"hello_triangle": ("HelloTriangle", {}),
          "hello_cube": ("HelloCube", {}),
          "hello_cube_msaa": ("HelloCube", {"msaa": True}),
          "default_scene": ("Default", {"shadow_dims": (64, 64, 64)}),
          "default_ssao": ("Default", {"shadow_dims": (64, 64, 64),
                                       "enable_ssao": True}),
          "default_ssr": ("Default", {"shadow_dims": (64, 64, 64),
                                      "enable_ssr": True}),
          "default_pcf": ("Default", {"shadow_dims": (128, 64, 128),
                                      "shadow_filter": "pcf"}),
          "envmap_unit_test": ("EnvironmentMapUnitTest", {})}
SSIM_MIN, MEAN_MAE_MAX, BLOCK_MAE_MAX = 0.985, 0.01, 0.08


def render_golden(golden: str, device: torch.device, env=None) -> np.ndarray:
    """-> ldr [HEIGHT, WIDTH, 3] of the golden's scene, on the host. env:
    the scene's environment maps when the caller has built them
    (graph.build_environment of its equirect at the default sizes), else
    they are built at load."""
    name, flags = SCENES[golden]
    s = load_scene(name, WIDTH, HEIGHT, draw_light_gizmos=True)
    r = VQRendererTorch(device)
    r.load_scene(s.buffers, equirect=s.equirect if env is None else None)
    if env is not None:
        r.env = env
    consts = r.build_frame_constants(s.buffers, s.cameras[0], s.lights)
    return r.render(consts, WIDTH, HEIGHT, **flags)["ldr"].cpu().numpy()


def golden_scores(golden: str, img: np.ndarray) -> dict:
    """-> {"ssim", "mean_mae", "block_mae", "ok"} of img against the golden."""
    ref = read_png(GOLDEN_DIR / f"{golden}.png").astype(np.float32)[:, :, :3] / 255.0
    err = np.abs(img - ref).mean(axis=-1)
    h, w = err.shape
    hb, wb = h // 16 * 16, w // 16 * 16
    blocks = err[:hb, :wb].reshape(hb // 16, 16, wb // 16, 16).mean((1, 3))
    scores = {"ssim": float(ssim(img, ref)), "mean_mae": float(err.mean()),
              "block_mae": float(blocks.max())}
    scores["ok"] = (scores["ssim"] >= SSIM_MIN
                    and scores["mean_mae"] < MEAN_MAE_MAX
                    and scores["block_mae"] < BLOCK_MAE_MAX)
    return scores
