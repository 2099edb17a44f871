"""Inverse-render the reference's retired goldens (by
differentiable rendering).

The clear_light / greenish_party goldens have no surviving scene source and
hand-sweeping albedos stalled around MAD ~27-54/255 — so recover them with
the framework's own flagship capability: gradient-descend the scene
parameters (wall/ball albedos, light emission, optionally geometry) against
the golden image itself.

Mechanics:
* target = golden PNG, gamma-DECODED to linear (inverting
  src/utils.cpp:11-16), pooled to the fit resolution, vertically flipped to
  the renderer's bottom-up cell order;
* loss: DUAL-BUFFER unbiased squared error — two independent sample halves
  r1, r2 give E[(r1-t)(r2-t)] = (mu-t)^2 exactly, so the objective does not
  penalize Monte-Carlo VARIANCE (a plain MSE of a noisy clipped render is
  minimized by dimming the light to kill clip spikes — observed: the fit
  collapsed a 30-emission light to 2.3); saturated golden pixels
  (target >= 0.995, the light disc) are masked out;
* fresh MC samples every step WITHOUT recompiling: the sample range start is
  a traced argument (sample_start = step*spp), so Adam sees new noise each
  step (stochastic gradients, one compile);
* params are projected to >= 0 after each update (albedo/emission are
  physical).

Usage:
  python scripts/fit_golden.py --target clear_light --steps 300
  python scripts/fit_golden.py --target greenish_party --steps 300 \
      --fields albedo,emission,p0,radius
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import optax
from PIL import Image

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.grad import merge_params, split_params
from cpu_path_tracing_tpu.models.io import save_scene
from cpu_path_tracing_tpu.render import render_cells_range
from recon_search import TARGETS, GOLDEN_DIR, render as hq_render
from reconstruct import score


def golden_target_cells(path: str, width: int, height: int) -> np.ndarray:
    """Golden PNG -> linear [width*height, 3] in renderer cell order
    (num_subpixels=1: cell id = y*W + x with y=0 the BOTTOM row)."""
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    lin = img ** 2.2  # invert round(clamp^(1/2.2)*255)
    H, W, _ = lin.shape
    assert H % height == 0 and W % width == 0, (H, W, height, width)
    pooled = lin.reshape(height, H // height, width, W // width, 3).mean(axis=(1, 3))
    return pooled[::-1].reshape(-1, 3)  # flip: renderer rows are bottom-up


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True, choices=sorted(TARGETS))
    ap.add_argument("--params", default="{}", help="builder kwargs (JSON)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--max-depth", type=int, default=40)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--lr-emission", type=float, default=0.3,
                    help="separate Adam lr for the emission field: Adam moves "
                         "each param ~lr per step in ABSOLUTE units, so a "
                         "30-scale emission is frozen at the albedo lr")
    ap.add_argument("--fields", default="albedo,emission")
    ap.add_argument("--out-json", default=None, help="write the fitted scene here")
    ap.add_argument("--out-png", default=None, help="write a HQ render here")
    ap.add_argument("--eval-spp", type=int, default=256)
    ap.add_argument("--init-json", default=None,
                    help="start from this fitted scene JSON instead of the builder")
    ap.add_argument("--cap-albedo", type=float, default=None,
                    help="project albedo <= CAP after each step: prevents the "
                         "saturation ratchet (albedo > 1 everywhere -> every "
                         "path blows out -> clamp gradients vanish -> the fit "
                         "strands in an all-white, grey-walled optimum)")
    ap.add_argument("--free-emission", action="store_true",
                    help="let every sphere's emission float (default: emission "
                         "is structurally masked to the builder's emitters — "
                         "otherwise the optimizer 'explains' wall colors by "
                         "turning walls into dim lights)")
    a = ap.parse_args()

    build, golden_name = TARGETS[a.target]
    golden = os.path.join(GOLDEN_DIR, golden_name)
    if a.init_json:
        from cpu_path_tracing_tpu.models.io import load_scene

        scene = load_scene(a.init_json, a.width, a.height)
    else:
        scene = build(a.width, a.height, **json.loads(a.params))
    fields = tuple(a.fields.split(","))
    params = split_params(scene, fields)
    em_mask = (np.asarray(scene.emission).sum(axis=1, keepdims=True) > 0).astype(np.float32)
    em_mask = None if a.free_emission else jnp.asarray(em_mask)

    cfg = pt.RenderConfig(width=a.width, height=a.height, spp=a.spp,
                          num_subpixels=1, max_depth=a.max_depth,
                          loop="scan", integrator="batch", remat=True)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    target = jnp.asarray(golden_target_cells(golden, a.width, a.height))
    live = jnp.asarray(target < 0.995, jnp.float32)  # mask saturated pixels

    optimizer = optax.multi_transform(
        {"emission": optax.adam(a.lr_emission), "other": optax.adam(a.lr)},
        {k: ("emission" if k == "emission" else "other") for k in params},
    )
    opt_state = optimizer.init(params)

    half = max(1, cfg.spp // 2)

    @jax.jit
    def step_fn(params, opt_state, s0):
        def loss_fn(p):
            sc = merge_params(scene, p)
            r1 = render_cells_range(sc, cfg, ids, s0, half) / half
            r2 = render_cells_range(sc, cfg, ids, s0 + half, half) / half
            # Forward model for a HIGH-spp golden: the reference clamps the
            # per-SUBPIXEL MEAN (src/main.cpp:195-196), and at the goldens'
            # spp that mean is converged — so stored-unsaturated pixels
            # satisfy stored == mu exactly and the unclamped dual-buffer
            # product E[(r1-t)(r2-t)] = (mu-t)^2 is the right unbiased
            # objective (a per-sample-clamp model overshoots: it must crank
            # flux until E[clamp(single sample)] reaches clamp(mu) levels,
            # then the real pipeline renders too bright — measured +25%).
            # Saturated pixels (t >= 0.995) carry no information except
            # "mu >= 1": mask them from the product and push them up with a
            # one-sided hinge that vanishes once the disc oversaturates.
            e1 = live * (r1 - target)
            e2 = live * (r2 - target)
            sat = (1.0 - live)
            rbar = 0.5 * (r1 + r2)
            hinge = sat * jnp.maximum(1.05 - rbar, 0.0)
            return jnp.mean(e1 * e2) + 0.1 * jnp.mean(hinge * hinge)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        # physical projection: albedo/emission/radius stay non-negative;
        # emission confined to the builder's emitters unless --free-emission
        params = {k: (jnp.maximum(v, 0.0) if k in ("albedo", "emission", "radius") else v)
                  for k, v in params.items()}
        if a.cap_albedo is not None and "albedo" in params:
            params["albedo"] = jnp.minimum(params["albedo"], a.cap_albedo)
        if em_mask is not None and "emission" in params:
            params["emission"] = params["emission"] * em_mask
        return params, opt_state, loss

    t0 = time.perf_counter()
    for it in range(a.steps):
        params, opt_state, loss = step_fn(params, opt_state, jnp.int32(it * cfg.spp))
        if it % max(1, a.steps // 15) == 0 or it == a.steps - 1:
            print(json.dumps({"step": it, "loss": round(float(loss), 6),
                              "s_per_step": round((time.perf_counter() - t0) / (it + 1), 2)}),
                  flush=True)

    fitted = merge_params(scene, params)
    # honest evaluation at HQ via the standard score
    if a.init_json:
        from cpu_path_tracing_tpu.models.io import load_scene

        big = load_scene(a.init_json, 512, 384)
    else:
        big = build(512, 384, **json.loads(a.params))
    big_fit = merge_params(big, params)  # same sphere count: params transfer
    img = hq_render(big_fit, 512, 384, a.eval_spp, 100)
    s = score(img, golden)
    print(json.dumps({"target": a.target, "fitted": True, **s}), flush=True)
    for k in fields:
        print(f"# {k}:\n{np.round(np.asarray(params[k]), 4)}", flush=True)
    if a.out_png:
        pt.write_png(a.out_png, img)
    if a.out_json:
        save_scene(a.out_json, fitted)
        print(f"wrote {a.out_json}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
