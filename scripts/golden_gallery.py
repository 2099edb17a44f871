"""Score every registered scene against its reference golden render.

Produces the README gallery table: pooled MAD (tonemapped, /255 units —
reconstruct.score) between this framework's render and each of the six
goldens in /root/reference/samples.  Run on a GPU (high spp needed: the
reference's per-subpixel clamp makes brightness spp-dependent).

Usage: python scripts/golden_gallery.py [--spp 512] [--out GALLERY.md]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

import cpu_path_tracing_tpu as pt
from reconstruct import score

GOLDEN_DIR = "/root/reference/samples"

# (golden file, scene name or scene-json path, provenance note)
PAIRS = [
    ("disco_sphere.png", "box_mirror", "data port (src/box_mirror_scene.hpp)"),
    ("box_scene.png", "box", "data port (src/box_scene.hpp)"),
    ("new_camera.png", "new_camera", "reconstruction (simple data + black sky)"),
    ("depth_of_field.png", "depth_of_field", "reconstruction (aperture 0.55)"),
    ("clear_light.png", "clear_light", "inverse-rendered candidate"),
    ("greenish_party.png", "greenish_party", "inverse-rendered candidate"),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--spp", type=int, default=512)
    ap.add_argument("--max-depth", type=int, default=100)
    ap.add_argument("--out", default=None, help="markdown table output")
    ap.add_argument("--png-dir", default=None, help="save candidate renders here")
    a = ap.parse_args()

    rows = []
    names = set(pt.scene_names())
    for golden, scene_name, note in PAIRS:
        if scene_name not in names and not os.path.exists(scene_name):
            rows.append((golden, scene_name, note, None))
            print(json.dumps({"golden": golden, "scene": scene_name,
                              "status": "no candidate scene"}), flush=True)
            continue
        if scene_name in names:
            scene = pt.get_scene(scene_name, a.width, a.height)
        else:
            from cpu_path_tracing_tpu.models.io import load_scene

            scene = load_scene(scene_name, a.width, a.height)
        cfg = pt.RenderConfig(width=a.width, height=a.height, spp=a.spp // 4,
                              max_depth=a.max_depth)
        img = np.asarray(jax.block_until_ready(pt.render_image(scene, cfg)))
        s = score(img, os.path.join(GOLDEN_DIR, golden))
        rows.append((golden, scene_name, note, s))
        print(json.dumps({"golden": golden, "scene": scene_name, **s}), flush=True)
        if a.png_dir:
            os.makedirs(a.png_dir, exist_ok=True)
            pt.write_png(os.path.join(a.png_dir, golden), img)

    lines = [
        "# Golden gallery — per-golden reconstruction error",
        "",
        f"Candidates rendered at {a.width}x{a.height} @ {a.spp} total spp,",
        "scored as pooled mean-absolute difference of the tonemapped images",
        "(/255 units, scripts/reconstruct.py) against the six reference",
        "goldens (`/root/reference/samples`, the de-facto oracle, SURVEY §4).",
        "",
        "| golden | scene | provenance | MAD /255 |",
        "|---|---|---|---|",
    ]
    for golden, scene_name, note, s in rows:
        mad = f"{s['mad255']:.2f}" if s else "(no candidate)"
        lines.append(f"| {golden} | `{scene_name}` | {note} | {mad} |")
    text = "\n".join(lines) + "\n"
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(text)
    print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
