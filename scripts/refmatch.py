"""Race the framework against the FRESHLY-EXECUTED reference binary.

The vendored sandbox smallpt (``/root/reference/sandbox/main.cpp``) is the
only runnable, deterministic piece of the reference: it builds with one
``g++ -O3 -fopenmp`` line (``sandbox/run.sh:3``) and its RNG is seeded
per-row with ``Xi = {0, 0, y^3}`` (``sandbox/main.cpp:245``), so its output
for a given spp is a fixed oracle (bit-identical across runs).  This script
writes ``REFMATCH.md``: a statistical
comparison of this framework's render against that fresh output, plus the
wall-clock race.

Estimator deltas (documented quirks) and how each is handled:

* refraction index: sandbox 1.5 (``main.cpp:204``) vs the src/ tree's 2.0
  quirk reproduced by the framework -> the ``smallpt_exact`` scene carries
  ior=1.5 (models/scenes.py).
* subpixel filter: sandbox tent filter (``main.cpp:253-256``) vs uniform ->
  ``RenderConfig(jitter='tent')``.
* dielectric estimator: the sandbox SPLITS into both branches at depth<=2
  and Russian-roulettes with P=.25+.5Re above (``main.cpp:219-226``); the
  framework single-samples by Schlick probability (src/main.cpp:141-154).
  Both are unbiased for the same integrand, so they share per-pixel
  EXPECTATIONS; only variance differs (plus the per-subpixel clamp's
  variance-dependent bias near saturated pixels, which vanishes as spp
  grows).  Bounded statistically below rather than reproduced.
* recursion depth: unbounded (RR-terminated) vs max_depth=100 — the tail
  past depth 100 carries ~(0.75)^~90 of throughput on this scene's diffuse
  walls; negligible.

Method: the sandbox render is ONE draw from its estimator's distribution.
The framework renders a K-seed ensemble of the exact-variant estimator at
the same spp; per-pixel mean/std of the ensemble give a z-score for the
sandbox draw (std floored at the 0.5/255 quantization noise).  If the
estimators agree, z is ~N(0,1)-distributed (plus the documented variance
mismatch from dielectric splitting).

Usage (writes REFMATCH.md + /tmp/refmatch artifacts):
    python scripts/refmatch.py --ref-ppm /tmp/refbuild/image_1024.ppm \
        --total-spp 1024 --seeds 8 [--ref-seconds 539]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import cpu_path_tracing_tpu as pt


def read_ppm_p3(path: str) -> np.ndarray:
    """Parse the sandbox's ASCII P3 output -> [H,W,3] uint8."""
    with open(path) as fh:
        tok = fh.read().split()
    assert tok[0] == "P3", tok[0]
    w, h, maxv = int(tok[1]), int(tok[2]), int(tok[3])
    assert maxv == 255
    vals = np.asarray(tok[4:4 + w * h * 3], dtype=np.int64)
    return vals.reshape(h, w, 3).astype(np.uint8)


def tonemap(img: np.ndarray) -> np.ndarray:
    """Linear [H,W,3] -> uint8 bytes, the reference's gamma path
    (``toInt``, sandbox/main.cpp:130-133 == src/ppm.cpp)."""
    return (np.power(np.clip(img, 0.0, 1.0), 1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def render_bytes(scene_name: str, cfg: pt.RenderConfig) -> tuple[np.ndarray, float]:
    scene = pt.get_scene(scene_name, cfg.width, cfg.height)
    t0 = time.perf_counter()
    img = np.asarray(jax.block_until_ready(pt.render_image(scene, cfg)))
    # render_image chunks internally; block_until_ready + host copy is an
    # honest end-to-end wall time.
    dt = time.perf_counter() - t0
    return tonemap(img), dt


def _write_bytes_png(path: str, img_u8: np.ndarray) -> None:
    """Dump an ALREADY-tonemapped byte image (write_png applies the gamma
    transfer itself, so feed it the linearized bytes)."""
    pt.write_png(path, np.power(img_u8.astype(np.float64) / 255.0, 2.2))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-ppm", required=True)
    ap.add_argument("--total-spp", type=int, default=1024)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--ref-seconds", type=float, default=None,
                    help="wall time of the reference run (from `time ./smallpt N`)")
    ap.add_argument("--out", default="REFMATCH.md")
    ap.add_argument("--dump-dir", default="/tmp/refmatch")
    args = ap.parse_args()

    ref = read_ppm_p3(args.ref_ppm).astype(np.float64)
    H, W = ref.shape[:2]
    spp = max(1, args.total_spp // 4)
    base = pt.RenderConfig(width=W, height=H, spp=spp, max_depth=100)
    os.makedirs(args.dump_dir, exist_ok=True)

    # --- as-is race: the framework's `smallpt` port (src-tree estimator) ----
    asis, t_asis = render_bytes("smallpt", base)
    _write_bytes_png(os.path.join(args.dump_dir, "asis.png"), asis)

    # --- exact-variant ensemble: ior 1.5 + tent filter, K seeds ------------
    ens = []
    t_exact = None
    for k in range(args.seeds):
        cfg = base.replace(jitter="tent", seed=k)
        img, dt = render_bytes("smallpt_exact", cfg)
        if k == 0:
            t_exact = dt
            _write_bytes_png(os.path.join(args.dump_dir, "exact_seed0.png"), img)
        ens.append(img.astype(np.float64))
        print(f"seed {k}: {dt:.1f}s", file=sys.stderr)
    ens = np.stack(ens)
    mean = ens.mean(axis=0)
    # ddof=1 unbiased; floor at quantization noise so converged pixels don't
    # produce infinite z.
    std = np.maximum(ens.std(axis=0, ddof=1), 0.5)
    z = (ref - mean) / (std * np.sqrt(1.0 + 1.0 / args.seeds))

    mad_exact = float(np.abs(ref - mean).mean())
    mad_asis = float(np.abs(ref - asis.astype(np.float64)).mean())
    mad_ens = float(np.abs(ens[0] - mean).mean())  # internal noise scale
    zabs = np.abs(z)
    stats = {
        "mad_exact_vs_ref": round(mad_exact, 3),
        "mad_asis_vs_ref": round(mad_asis, 3),
        "mad_ensemble_internal": round(mad_ens, 3),
        "z_p50": round(float(np.quantile(zabs, 0.5)), 3),
        "z_p95": round(float(np.quantile(zabs, 0.95)), 3),
        "z_p999": round(float(np.quantile(zabs, 0.999)), 3),
        "frac_z_gt3": round(float((zabs > 3).mean()), 5),
        "frac_z_gt5": round(float((zabs > 5).mean()), 6),
    }
    # Where do the z>5 pixels live?  (expected: glass sphere / caustic for
    # variance mismatch, light rim for clamp bias)
    ys, xs = np.nonzero((zabs > 5).any(axis=-1))
    stats["n_pixels_z_gt5"] = int(ys.size)

    # difference maps for the writeup
    pt.write_png(os.path.join(args.dump_dir, "absdiff_exact.png"),
                 np.abs(ref - mean) / 255.0 * 8.0)
    pt.write_png(os.path.join(args.dump_dir, "zmap.png"),
                 np.clip(zabs / 8.0, 0, 1))

    perf = {
        "framework_asis_seconds": round(t_asis, 2),
        "framework_exact_seconds": round(t_exact, 2),
        "reference_seconds": args.ref_seconds,
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
    }
    print(json.dumps({"stats": stats, "perf": perf}, indent=1))
    with open(os.path.join(args.dump_dir, "stats.json"), "w") as fh:
        json.dump({"stats": stats, "perf": perf,
                   "total_spp": args.total_spp, "seeds": args.seeds}, fh, indent=1)
    return 0


if __name__ == "__main__":
    main()
