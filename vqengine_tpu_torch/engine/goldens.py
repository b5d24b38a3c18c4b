"""The hello-scene goldens through the port: render a scene with the
golden setup and score it against ``tests/goldens/<name>.png``.

The setup and the bars are those of the reference's golden test
(tests/test_golden.py:186-245): 192x108, the scene's own camera, light
gizmos on; SSIM >= 0.985, mean MAE < 0.01 and worst 16x16 block MAE
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
          "hello_cube_msaa": ("HelloCube", {"msaa": True})}
SSIM_MIN, MEAN_MAE_MAX, BLOCK_MAE_MAX = 0.985, 0.01, 0.08


def render_golden(golden: str, device: torch.device) -> np.ndarray:
    """-> ldr [HEIGHT, WIDTH, 3] of the golden's scene, on the host."""
    name, flags = SCENES[golden]
    s = load_scene(name, WIDTH, HEIGHT, draw_light_gizmos=True)
    r = VQRendererTorch(device)
    r.load_scene(s.buffers)
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
