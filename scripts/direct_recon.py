"""Derivative-free golden reconstruction: coordinate search on the OFFICIAL
tonemapped-MAD metric (round 4; the tool that produced the registered
clear_light / greenish_party scenes — docs/RECONSTRUCTION.md).

Why derivative-free, after building a differentiable renderer?  Three
measured reasons (full post-mortem in docs/RECONSTRUCTION.md):

1. The goldens are CLAMPED LDR images; matching them end-to-end means
   optimizing through `round(clamp(mean)^)`-style nonlinearities whose
   gradients either vanish (hard clamp) or bias brightness (any soft
   surrogate we tried: measured ±25% brightness error between surrogate
   optimum and official-metric optimum).
2. Geometry (sphere positions/radii, camera) has near-zero detached-
   estimator gradient in closed scenes — it must be searched anyway.
3. An official-metric evaluation (256x192 @ 1024 total spp) is cheap on an
   accelerator, so ~400 evaluations — a full multi-wave search — are
   affordable.

Method: coordinate descent with shrinking steps over a scene
PARAMETRIZATION (per-wall brightness scales against image-measured
chromas, light emission/size/position, sphere geometry, camera), with a
JSON state file so waves resume after an interruption.  Alternating waves
(colors -> light -> sphere geometry -> colors) escape the single-wave
plateaus; each wave's trace is printed and kept.

Usage:
  python scripts/direct_recon.py --target clear_light --rounds 10
  python scripts/direct_recon.py --target greenish_party --rounds 10 \
      --state /tmp/gp_state.json --out fitted.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.models.io import load_scene
from cpu_path_tracing_tpu.utils.image import tonemap
from reconstruct import load_golden, pool, mad255

GOLDEN_DIR = "/root/reference/samples"

# ---------------------------------------------------------------------------
# Scene parametrizations.  x is a flat vector; bounds/steps per target.
# Wall CHROMAS are measured from golden wall patches (linear, max-normalized)
# and held fixed: the search moves one brightness scale per wall, which
# decouples "what color is this wall" (readable from the image) from "how
# reflective is it" (entangled with the light through transport).
# ---------------------------------------------------------------------------

CL_CHROMA = {
    0: (1.0, 0.39, 0.36), 1: (0.45, 0.45, 1.0), 2: (1.0, 1.0, 0.95),
    3: (0.45, 1.0, 0.35), 4: (1.0, 1.0, 0.98),
}
GP_CHROMA = {
    0: (1.0, 0.68, 0.28), 1: (0.55, 0.72, 0.85), 2: (0.55, 1.0, 0.5),
    3: (0.5, 1.0, 0.35), 4: (0.6, 0.8, 0.62),
}
WALL_CENTERS = [
    [-1e6 - 0.4, 0.0, -1.0], [1e6 + 0.4, 0.0, -1.0], [0.0, 0.0, -1e6 - 1.0],
    [0.0, 1e6 + 0.4, -1.0], [0.0, -1e6 - 0.4, -1.0],
]


def make_clear_light(x):
    s = x[:5]
    e, lr_, mag, ly, ap, wem, lx = x[5:12]
    m = x[12:16]   # mirror xyz r
    g2 = x[16:20]  # magenta xyz r
    g3 = x[20:24]  # glass xyz r
    d = {"camera": {"position": [0, 0, 2.0], "look_at": [0, 0, -0.4],
                    "up": [0, 1, 0], "vfov": 0.5, "aperture": float(ap),
                    "focus_distance": 2.4, "origin_advance": 0.0},
         "background": [[0, 0, 0], [0, 0, 0]], "spheres": []}
    for i in range(5):
        alb = [min(2.0, s[i] * CL_CHROMA[i][k]) for k in range(3)]
        d["spheres"].append({"radius": 1e6, "center": WALL_CENTERS[i],
                             "emission": [float(wem) * a for a in alb],
                             "albedo": alb, "material": "diffuse"})
    d["spheres"].append({"radius": float(lr_), "center": [float(lx), float(ly), -1.16],
                         "emission": [float(e)] * 3, "albedo": [1.8] * 3,
                         "material": "diffuse"})
    d["spheres"].append({"radius": float(m[3]), "center": [float(v) for v in m[:3]],
                         "emission": [0, 0, 0], "albedo": [0.95] * 3,
                         "material": "specular"})
    d["spheres"].append({"radius": float(g2[3]), "center": [float(v) for v in g2[:3]],
                         "emission": [0, 0, 0], "albedo": [0.9, float(mag), 0.9],
                         "material": "specular"})
    d["spheres"].append({"radius": float(g3[3]), "center": [float(v) for v in g3[:3]],
                         "emission": [0, 0, 0], "albedo": [1.0] * 3,
                         "material": "dielectric"})
    return d


def make_greenish_party(x):
    s = x[:5]
    e, R, poke, etint, vfov, wem, cem, camz = x[5:13]
    m = x[13:17]
    g = x[17:21]
    d = {"camera": {"position": [0, 0, float(camz)], "look_at": [0, 0, -0.4],
                    "up": [0, 1, 0], "vfov": float(vfov), "aperture": 0.05,
                    "focus_distance": float(camz) + 0.4, "origin_advance": 0.0},
         "background": [[0, 0, 0], [0, 0, 0]], "spheres": []}
    for i in range(5):
        alb = [min(2.0, s[i] * GP_CHROMA[i][k]) for k in range(3)]
        scale = float(cem) if i == 3 else float(wem)  # glowing ceiling
        d["spheres"].append({"radius": 1e6, "center": WALL_CENTERS[i],
                             "emission": [scale * a for a in alb],
                             "albedo": alb, "material": "diffuse"})
    cy = 0.4 + R - poke  # sphere poking `poke` through the ceiling plane
    d["spheres"].append({"radius": float(R), "center": [0.0, float(cy), -1.0],
                         "emission": [float(e * 0.9), float(e), float(e * etint)],
                         "albedo": [1.8] * 3, "material": "diffuse"})
    d["spheres"].append({"radius": float(m[3]), "center": [float(v) for v in m[:3]],
                         "emission": [0, 0, 0], "albedo": [0.95] * 3,
                         "material": "specular"})
    d["spheres"].append({"radius": float(g[3]), "center": [float(v) for v in g[:3]],
                         "emission": [0, 0, 0], "albedo": [1.0] * 3,
                         "material": "dielectric"})
    return d


TARGETS = {
    "clear_light": dict(
        make=make_clear_light, golden="clear_light.png",
        x0=[0.74, 0.63, 0.62, 0.51, 0.82, 8.0, 0.2475, 0.35, 0.0886, 0.01,
            0.0415, -0.052,
            -0.26, -0.266, -0.678, 0.175, 0.14, -0.2244, -0.72, 0.175,
            0.21, -0.24, -0.238, 0.2],
        step=[0.07] * 5 + [2.0, 0.015, 0.08, 0.02, 0.02, 0.015, 0.015]
             + [0.04, 0.04, 0.08, 0.025] * 3,
        lo=[0.2] * 5 + [2.0, 0.15, 0.05, -0.15, 0.0, 0.0, -0.08]
           + [-0.4, -0.38, -1.0, 0.08] * 3,
        hi=[2.0] * 5 + [160.0, 0.38, 0.95, 0.25, 0.3, 0.25, 0.08]
           + [0.4, 0.05, -0.1, 0.3] * 3,
    ),
    "greenish_party": dict(
        make=make_greenish_party, golden="greenish_party.png",
        x0=[0.288, 0.2152, 0.628, 1.5288, 0.15, 9.0, 0.8, 0.05, 0.84, 0.46,
            0.0, 0.7, 1.55,
            -0.18, -0.17, -0.518, 0.1054, 0.2, -0.224, -0.48, 0.15],
        step=[0.06] * 5 + [2.0, 0.1, 0.012, 0.08, 0.03, 0.012, 0.12, 0.12]
             + [0.03, 0.03, 0.06, 0.02] * 2,
        lo=[0.15] * 5 + [3.0, 0.25, 0.004, 0.2, 0.3, 0.0, 0.0, 0.8]
           + [-0.35, -0.38, -0.9, 0.08] * 2,
        hi=[2.0] * 5 + [120.0, 1.6, 0.15, 1.2, 0.85, 0.25, 2.0, 2.2]
           + [0.35, 0.0, -0.1, 0.3] * 2,
    ),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True, choices=sorted(TARGETS))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--total-spp", type=int, default=1024)
    ap.add_argument("--state", default=None, help="resumable state JSON")
    ap.add_argument("--out", default=None, help="write the best scene here")
    a = ap.parse_args()

    t = TARGETS[a.target]
    gold = pool(load_golden(os.path.join(GOLDEN_DIR, t["golden"])),
                a.height, a.width)
    cfg = pt.RenderConfig(width=a.width, height=a.height,
                          spp=a.total_spp // 4, max_depth=100)
    tmp = f"/tmp/direct_recon_{a.target}.json"

    def evaluate(d):
        json.dump(d, open(tmp, "w"))
        scene = load_scene(tmp, a.width, a.height)
        img = np.asarray(jax.block_until_ready(pt.render_image(scene, cfg)))
        return mad255(tonemap(img).astype(np.float32) / 255.0, gold)

    x = np.asarray(t["x0"], np.float64)
    st = np.asarray(t["step"], np.float64)
    lo, hi = np.asarray(t["lo"]), np.asarray(t["hi"])
    if a.state and os.path.exists(a.state):
        d = json.load(open(a.state))
        x, st, best = np.asarray(d["x"]), np.asarray(d["st"]), d["best"]
        print(f"resume best {best:.2f}", flush=True)
    else:
        best = evaluate(t["make"](x))
        print(f"init MAD {best:.2f}", flush=True)

    def save():
        if a.state:
            json.dump({"x": x.tolist(), "st": st.tolist(), "best": best},
                      open(a.state, "w"))
        if a.out:
            json.dump(t["make"](x), open(a.out, "w"), indent=1)

    for rnd in range(a.rounds):
        improved = False
        for i in range(len(x)):
            for sgn in (+1, -1):
                xx = x.copy()
                xx[i] = np.clip(x[i] + sgn * st[i], lo[i], hi[i])
                if xx[i] == x[i]:
                    continue
                m = evaluate(t["make"](xx))
                if m < best - 0.03:
                    best, x, improved = m, xx, True
                    print(f"r{rnd} p{i}{'+' if sgn > 0 else '-'} -> {m:.2f}",
                          flush=True)
                    save()
                    break
        if not improved:
            st = st * 0.6
            save()
            print(f"r{rnd}: shrink", flush=True)
    print(f"BEST {best:.2f}", flush=True)
    print(np.round(x, 4).tolist(), flush=True)
    save()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
