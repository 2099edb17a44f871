"""Smoke test of the path tracer on NVIDIA GPUs: the quickest proof that the
system starts on the card and computes the right thing.

    python chip_smoke.py             # one card: phases 1-4 below
    python chip_smoke.py --chips 4   # four cards: phase 1 + the sharded phase

One process drives the card(s); the CLI jobs run in-process through
``cpu_path_tracing_tpu.cli.main``.  Phases (one card):

1. Device check: JAX must report a ``gpu`` device, else the script exits 2
   and prints no result.  The card's name and power limit are printed as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. Kernel checks: the fused GPU kernel (ops/pallas/gpu_kernel.py) is
   compiled at the headline width (its ``memory_analysis`` printed) and
   held to its plain reference, the XLA wavefront ``render_wavefront``, by
   a two-tier gate on every registered scene at 96x64 and on disco_sphere
   at 1024x768.  Threefry draws are integers and bit-identical, but Triton
   and XLA contract floating-point operations differently, so a small share
   of paths takes the other side of a discrete decision (a Schlick choice,
   a roulette draw) and then decorrelates over many bounces.  Hence:
     * strict tier, max_depth 8: the scale-aware deviation
       |a-b|/max(|a|,|b|,1) has p99.9 < 1e-5, and the share of cells
       above 1e-3 is < 1e-3;
     * statistical tier, max_depth 100: the mean deviation is at most 1.5x
       that of an independent render of the wavefront (other samples), and
       every channel mean agrees within 1%.
   Then the kernel and the wavefront are timed on the headline render
   (disco_sphere 1024x768, 32 total spp, max_depth 100; warm, median of 3),
   and one replay backward at the production invert chunk.
3. Main path through the CLI: ``render`` of the headline configuration to a
   PNG (finite image, channel means within 1% of the wavefront's render,
   the PNG equal to the tone-mapped image) and a three-step ``invert`` at
   the production box config (finite losses, the last below the first).
4. Replay precision: the analytic replay gradients against ``jax.grad`` of
   the scan integrator on box 32x32, 2 spp, max_depth 12, f32 — elementwise
   within 1e-3 relative (plus 1e-5 of the field's largest entry).  A float32
   contraction running in TF32 would fail it.

With ``--chips 4``: the sharded forward render of the headline
configuration on meshes (4,1) (bit for bit equal to the one-card render)
and (2,2) (within 1e-6 scale-aware: the sample psum reassociates the sum),
and one sharded accumulated train step at the production invert config
against the one-card step (loss within 1e-5 relative, gradients within 1e-4
of each field's largest entry).

Details go to ``chiprun_out/chip_smoke_<chips>.json``.  The last line of standard
output is ``{"ok": true, "device": {"platform", "kind", "count"}}``; any
failed check raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")

HEADLINE = dict(scene="disco_sphere", width=1024, height=768, spp=8, max_depth=100)
INVERT = dict(scene="box", width=400, height=400, spp=16, max_depth=100,
              cell_chunk=1 << 17)


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


def scale_aware(a, b):
    """Elementwise |a-b| / max(|a|,|b|,1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)


def strict_tier(kern, ref) -> dict:
    d = scale_aware(kern, ref)
    rec = {"p999": float(np.quantile(d, 0.999)), "flipped_frac": float((d > 1e-3).mean())}
    rec["ok"] = rec["p999"] < 1e-5 and rec["flipped_frac"] < 1e-3
    return rec


def statistical_tier(kern, ref, alt) -> dict:
    """``alt``: an independent wavefront render (other samples), the
    Monte-Carlo noise yardstick."""
    ratios = (np.asarray(kern).reshape(-1, 3).mean(0)
              / np.maximum(np.asarray(ref).reshape(-1, 3).mean(0), 1e-12))
    rec = {"mean_dev": float(scale_aware(kern, ref).mean()),
           "yardstick": float(scale_aware(alt, ref).mean()),
           "channel_ratios": [float(r) for r in ratios]}
    rec["ok"] = bool(rec["mean_dev"] <= 1.5 * rec["yardstick"] + 1e-6
                     and np.all(np.abs(ratios - 1.0) < 0.01))
    return rec


@functools.lru_cache(maxsize=None)
def _renderers(cfg, interpret):
    """Jitted span renderers for one config: (kernel, wavefront); each
    takes (scene, cell_ids, sample_start) and returns (sums, segments)."""
    import jax

    from cpu_path_tracing_tpu.ops.pallas.gpu_kernel import render_kernel
    from cpu_path_tracing_tpu.ops.wavefront import render_wavefront

    def kern(s, i, s0):
        out, st = render_kernel(s, cfg, i, s0, cfg.spp, interpret=interpret,
                                with_stats=True)
        return out, st["segments"]

    def wave(s, i, s0):
        out, st = render_wavefront(s, cfg, i, s0, cfg.spp, with_stats=True)
        return out, st["segments"]

    return jax.jit(kern), jax.jit(wave)


def gate_scene(name, width, height, spp, *, interpret=False, timing=False):
    """Both tiers for one scene; with ``timing`` also the kernel-vs-wavefront
    timing at max_depth 100 (warm, median of 3)."""
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu.utils.metrics import median_seconds

    scene = pt.get_scene(name, width, height)
    rec = {"scene": name, "size": [width, height, spp], "spheres": scene.num_spheres}
    lo = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=8)
    ids = jnp.arange(lo.num_cells, dtype=jnp.int32)
    kern, wave = _renderers(lo, interpret)
    rec["strict"] = strict_tier(np.asarray(kern(scene, ids, 0)[0]),
                                np.asarray(wave(scene, ids, 0)[0]))

    hi = lo.replace(max_depth=100)
    kern, wave = _renderers(hi, interpret)
    k_out, k_seg = kern(scene, ids, 0)
    w_out, w_seg = wave(scene, ids, 0)
    alt = wave(scene, ids, spp)[0]
    rec["statistical"] = statistical_tier(np.asarray(k_out), np.asarray(w_out),
                                          np.asarray(alt))
    if timing:
        rec["kernel_s"] = median_seconds(lambda: kern(scene, ids, 0)[0])
        rec["wavefront_s"] = median_seconds(lambda: wave(scene, ids, 0)[0])
        rec["kernel_segments"], rec["wavefront_segments"] = int(k_seg), int(w_seg)
        rec["kernel_mrays_s"] = int(k_seg) / rec["kernel_s"] / 1e6
        rec["wavefront_mrays_s"] = int(w_seg) / rec["wavefront_s"] / 1e6
    tiers = f"strict {rec['strict']}  statistical {rec['statistical']}"
    print(f"{name} {width}x{height}x{spp}: {tiers}", flush=True)
    check(rec["strict"]["ok"] and rec["statistical"]["ok"], f"two-tier gate: {name}")
    return rec


def compile_headline(*, interpret=False, **kw) -> dict:
    """Compile the kernel at the headline width and report its memory."""
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt

    c = {**HEADLINE, **kw}
    cfg = pt.RenderConfig(width=c["width"], height=c["height"], spp=c["spp"],
                          max_depth=c["max_depth"])
    scene = pt.get_scene(c["scene"], cfg.width, cfg.height)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    kern, _ = _renderers(cfg, interpret)
    t0 = time.perf_counter()
    compiled = kern.lower(scene, ids, 0).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    print(f"kernel compiled at {cfg.width}x{cfg.height}x{cfg.spp} in {secs:.1f}s; "
          f"memory_analysis: {mem}", flush=True)
    return {"compile_s": secs, "memory_analysis": str(mem)}


def time_replay(*, width=INVERT["width"], height=INVERT["height"],
                spp=INVERT["spp"], cells=INVERT["cell_chunk"]) -> dict:
    """One replay backward over a production invert cell chunk."""
    import jax
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu.ops.replay import replay_param_grads_wavefront
    from cpu_path_tracing_tpu.utils.metrics import median_seconds

    cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=INVERT["max_depth"])
    scene = pt.get_scene(INVERT["scene"], width, height)
    ids = jnp.arange(min(cells, cfg.num_cells), dtype=jnp.int32)
    ct = jnp.asarray(np.random.default_rng(0).normal(0, 1e-2, (ids.shape[0], 3)),
                     jnp.float32)
    f = jax.jit(lambda s, i, c: replay_param_grads_wavefront(s, cfg, i, 0, spp, c))
    t0 = time.perf_counter()
    g = jax.block_until_ready(f(scene, ids, ct))
    first = time.perf_counter() - t0
    rec = {"cells": int(ids.shape[0]), "spp": spp, "first_call_s": first,
           "replay_s": median_seconds(lambda: f(scene, ids, ct))}
    print(f"replay backward {rec}", flush=True)
    check(all(bool(jnp.all(jnp.isfinite(v))) for v in g.values()), "replay gradients finite")
    return rec


def cli_render(out_png, **kw) -> dict:
    """The headline render through ``cli render``; checked against the XLA
    wavefront's render of the same image on the same device."""
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu import cli
    from cpu_path_tracing_tpu.render import render_image
    from cpu_path_tracing_tpu.utils.image import read_png, tonemap

    c = {**HEADLINE, **kw}
    argv = ["render", "--scene", c["scene"], "--width", str(c["width"]),
            "--height", str(c["height"]), "--total-spp", str(4 * c["spp"]),
            "--max-depth", str(c["max_depth"]), "-o", out_png]
    t0 = time.perf_counter()
    check(cli.main(argv) == 0, "cli " + " ".join(argv))
    secs = time.perf_counter() - t0
    cfg = pt.RenderConfig(width=c["width"], height=c["height"], spp=c["spp"],
                          max_depth=c["max_depth"])
    scene = pt.get_scene(c["scene"], cfg.width, cfg.height)
    img = np.asarray(render_image(scene, cfg))
    ref = np.asarray(render_image(scene, cfg.replace(integrator="wavefront")))
    png = read_png(out_png)
    ratios = img.reshape(-1, 3).mean(0) / np.maximum(ref.reshape(-1, 3).mean(0), 1e-12)
    rec = {"cli_s": secs, "channel_ratios": [float(r) for r in ratios]}
    print(f"cli render: {rec}", flush=True)
    check(png.shape == (cfg.height, cfg.width, 3), f"PNG shape {png.shape}")
    check(bool(np.all(np.isfinite(img))), "rendered image finite")
    check(bool(np.array_equal(png, tonemap(img))), "PNG equals the tone-mapped render")
    check(bool(np.all(np.abs(ratios - 1.0) < 0.01)), "channel means within 1% of the wavefront")
    return rec


def cli_invert(*, steps=3, **kw) -> dict:
    """Three optimizer steps of ``cli invert`` at the production box config."""
    from cpu_path_tracing_tpu import cli

    c = {**INVERT, **kw}
    argv = ["invert", "--scene", c["scene"], "--width", str(c["width"]),
            "--height", str(c["height"]), "--total-spp", str(4 * c["spp"]),
            "--max-depth", str(c["max_depth"]), "--fields", "albedo,emission",
            "--cell-chunk", str(c["cell_chunk"]), "--steps", str(steps)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    recs = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    losses = [r["loss"] for r in recs]
    rec = {"cli_s": secs, "losses": losses, "steps_per_s": recs[-1]["steps_per_s"] if recs else None}
    print(f"cli invert: {rec}", flush=True)
    check(rc == 0 and len(losses) == steps, "cli " + " ".join(argv))
    check(bool(np.all(np.isfinite(losses))), "invert losses finite")
    check(losses[-1] < losses[0], "invert loss decreases")
    return rec


def replay_precision(width=32, height=32, spp=2, max_depth=12) -> dict:
    """Replay gradients vs jax.grad of the scan integrator, f32."""
    import jax
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu.grad import merge_params, split_params
    from cpu_path_tracing_tpu.ops.replay import replay_param_grads_wavefront
    from cpu_path_tracing_tpu.render import render_cells_range

    cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=max_depth,
                          loop="scan", integrator="batch")
    base = pt.get_scene("box", width, height, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    scene = merge_params(base, {  # strictly positive albedos: the replay's domain
        "albedo": jnp.abs(base.albedo + rng.normal(0, 0.03, base.albedo.shape)
                          .astype(np.float32)) + 1e-3,
        "emission": jnp.abs(base.emission + rng.normal(0, 0.03, base.emission.shape)
                            .astype(np.float32)),
    })
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    ct = jnp.asarray(rng.normal(0, 1, (cfg.num_cells, 3)), jnp.float32)
    fields = ("albedo", "emission", "background")
    params = split_params(scene, fields)

    @jax.jit
    def ad(p):
        return jax.grad(lambda q: jnp.sum(
            render_cells_range(merge_params(scene, q), cfg, ids, 0, spp) * ct))(p)

    g_ad = ad(params)
    g_rp = jax.jit(lambda s: replay_param_grads_wavefront(
        s, cfg.replace(loop="while", integrator="auto"), ids, 0, spp, ct))(scene)
    rec = {}
    for k in fields:
        a, b = np.asarray(g_rp[k], np.float64), np.asarray(g_ad[k], np.float64)
        err, scale = np.abs(a - b), np.abs(b).max()
        # A field with no gradient at all (background in a closed room)
        # must come out exactly zero.
        tol = 1e-3 * np.abs(b) + 1e-5 * scale if scale > 0 else np.ones_like(b)
        rec[k] = {"max_abs_err": float(err.max()), "scale": float(scale),
                  "worst_over_tol": float((err / tol).max()) if scale > 0
                  else float(np.inf if err.max() > 0 else 0.0)}
    print(f"replay vs jax.grad: {rec}", flush=True)
    check(all(r["worst_over_tol"] <= 1.0 for r in rec.values()),
          "replay gradients within 1e-3 of jax.grad")
    return rec


def four_card_phase(*, width=HEADLINE["width"], height=HEADLINE["height"],
                    spp=HEADLINE["spp"], invert=None) -> dict:
    """The tiles x samples mesh on four devices against one device."""
    import jax
    import jax.numpy as jnp
    import optax

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu.grad import (
        make_accum_train_step, make_sharded_accum_train_step, render_target, split_params)
    from cpu_path_tracing_tpu.parallel.mesh import make_mesh
    from cpu_path_tracing_tpu.parallel.render import render_cells_sharded
    from cpu_path_tracing_tpu.render import render_cells

    devices = jax.devices()[:4]
    check(len(devices) == 4, f"four devices ({len(jax.devices())} found)")
    rec = {}
    cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=HEADLINE["max_depth"])
    scene = pt.get_scene(HEADLINE["scene"], width, height)
    with jax.default_device(devices[0]):
        one = np.asarray(render_cells(scene, cfg, jnp.arange(cfg.num_cells, dtype=jnp.int32)))
    for shape in ((4, 1), (2, 2)):
        t0 = time.perf_counter()
        got = np.asarray(render_cells_sharded(scene, cfg, make_mesh(*shape, devices=devices)))
        dev = float(scale_aware(got, one).max())
        rec[f"render_{shape[0]}x{shape[1]}"] = {"max_scale_aware_dev": dev,
                                               "first_call_s": time.perf_counter() - t0}
        print(f"sharded render mesh {shape}: max scale-aware deviation {dev:.3g}", flush=True)
        if shape == (4, 1):
            check(bool(np.array_equal(got, one)), "mesh (4,1) render bit for bit equal")
        else:
            check(dev <= 1e-6, "mesh (2,2) render within 1e-6 scale-aware")

    c = {**INVERT, **(invert or {})}
    cfg = pt.RenderConfig(width=c["width"], height=c["height"], spp=c["spp"],
                          max_depth=c["max_depth"])
    scene = pt.get_scene(c["scene"], cfg.width, cfg.height)
    with jax.default_device(devices[0]):
        target = render_target(scene, cfg, c["cell_chunk"])
    params = jax.tree.map(lambda x: x + 0.02, split_params(scene, ("albedo", "emission")))
    opt = optax.adam(1e-2)

    def grads(step):
        # After one Adam step the first moment is exactly (1 - b1) * grad.
        _, state, loss = step(params, opt.init(params), target)
        return float(loss), {k: np.asarray(v) / 0.1 for k, v in state[0].mu.items()}

    with jax.default_device(devices[0]):
        l1, g1 = grads(make_accum_train_step(scene, cfg, opt, cell_chunk=c["cell_chunk"]))
    l4, g4 = grads(make_sharded_accum_train_step(
        make_mesh(2, 2, devices=devices), scene, cfg, opt, cell_chunk=c["cell_chunk"]))
    rec["train_step"] = {
        "loss_rel": abs(l4 - l1) / abs(l1),
        "grad_rel": {k: float(np.abs(g4[k] - g1[k]).max() / np.abs(g1[k]).max()) for k in g1}}
    print(f"sharded train step mesh (2, 2): {rec['train_step']}", flush=True)
    check(rec["train_step"]["loss_rel"] <= 1e-5, "sharded loss within 1e-5")
    check(all(v <= 1e-4 for v in rec["train_step"]["grad_rel"].values()),
          "sharded gradients within 1e-4")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="1: every one-card phase; 4: only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < args.chips:
        print(f"chip_smoke.py needs {args.chips} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform!r} device(s)", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)

    from cpu_path_tracing_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    res = {"nvidia_smi": smi, "device_kind": devices[0].device_kind}
    if args.chips == 4:
        res["four_card"] = four_card_phase()
    else:
        import cpu_path_tracing_tpu as pt

        res["compile"] = compile_headline()
        res["gate"] = [gate_scene(n, 96, 64, 4) for n in pt.scene_names()]
        res["headline"] = gate_scene(HEADLINE["scene"], HEADLINE["width"],
                                     HEADLINE["height"], HEADLINE["spp"], timing=True)
        res["replay"] = time_replay()
        res["cli_render"] = cli_render(os.path.join(OUT_DIR, "disco_sphere.png"))
        res["cli_invert"] = cli_invert()
        res["replay_precision"] = replay_precision()
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, f"chip_smoke_{args.chips}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(f"chip_smoke finished in {res['seconds']:.0f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
