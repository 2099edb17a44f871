"""Golden-reconstruction harness.

The reference ships six golden renders in ``/root/reference/samples`` but only
three scene sources survive (the headers were edited in place; SURVEY.md §6).
This tool renders a candidate scene registered in models/scenes.py and scores
it against a golden: both images are mean-pooled to a common grid and compared
as 8-bit values (MAD = mean |a-b| in /255 units).

Usage:
    python scripts/reconstruct.py --scene depth_of_field \
        --golden /root/reference/samples/depth_of_field.png \
        [--width 256 --height 192 --spp 16 --out /tmp/cand.png]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from PIL import Image


def load_golden(path: str) -> np.ndarray:
    """Golden PNG -> float [H,W,3] in [0,1] (8-bit / 255)."""
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def pool(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Mean-pool [H,W,3] to [h,w,3] (H,W divisible by h,w)."""
    H, W, _ = img.shape
    return img.reshape(h, H // h, w, W // w, 3).mean(axis=(1, 3))


def mad255(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).mean() * 255.0)


def score(candidate_linear: np.ndarray, golden_path: str, grid=(96, 128)) -> dict:
    """Compare a linear-radiance candidate [H,W,3] against a golden file.

    Applies the reference's gamma-2.2 transfer (src/utils.cpp:11-16) to the
    candidate, pools both to ``grid`` and reports MAD plus per-channel means.
    """
    from cpu_path_tracing_tpu.utils.image import tonemap

    cand = tonemap(candidate_linear).astype(np.float32) / 255.0
    gold = load_golden(golden_path)
    h, w = grid
    cp, gp = pool(cand, h, w), pool(gold, h, w)
    return {
        "mad255": round(mad255(cp, gp), 2),
        "cand_mean255": [round(float(m) * 255, 1) for m in cp.reshape(-1, 3).mean(0)],
        "gold_mean255": [round(float(m) * 255, 1) for m in gp.reshape(-1, 3).mean(0)],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", required=True)
    ap.add_argument("--golden", required=True)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=100)
    ap.add_argument("--out", default=None, help="also write the candidate PNG here")
    a = ap.parse_args()

    import jax
    import cpu_path_tracing_tpu as pt

    cfg = pt.RenderConfig(width=a.width, height=a.height, spp=a.spp, max_depth=a.max_depth)
    scene = pt.get_scene(a.scene, a.width, a.height)
    img = np.asarray(jax.block_until_ready(pt.render_image(scene, cfg)))
    if a.out:
        pt.write_png(a.out, img)
    import json

    print(json.dumps({"scene": a.scene, "golden": a.golden, **score(img, a.golden)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
