"""Command-line interface.

Replaces the reference's single positional argument (total spp,
``src/main.cpp:203-206``) and its compile-time scene/resolution constants
with a real CLI: ``render`` / ``invert`` / ``bench`` subcommands, scenes by
name, checkpoint/resume, sharded execution, profiling.

For reference-compatibility, ``--total-spp N`` mimics the reference semantics
(N is divided by num_subpixels^2, ``src/main.cpp:206``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import RenderConfig, get_scene, scene_names, write_png, write_ppm
from .utils.checkpoint import render_progressive
from .utils.metrics import (
    ProgressLogger, RenderReport, Timer, device_record, median_seconds)
from .utils.profiling import maybe_trace


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="box_mirror", choices=scene_names())
    p.add_argument(
        "--scene-file", default=None,
        help="load the scene from a JSON file instead of --scene (models/io.py)",
    )
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    sp = p.add_mutually_exclusive_group()
    sp.add_argument("--spp", type=int, default=None, help="samples per subpixel cell")
    sp.add_argument(
        "--total-spp", type=int, default=None,
        help="total spp as in the reference CLI (divided by subpixels^2)",
    )
    p.add_argument("--subpixels", type=int, default=2)
    p.add_argument("--max-depth", type=int, default=100)
    p.add_argument("--rr-depth", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--integrator", choices=("auto", "wavefront", "pallas", "batch"),
                   default="auto",
                   help="auto: the fused GPU kernel (pallas) on a GPU, the XLA "
                        "wavefront elsewhere (render.resolve_integrator)")
    p.add_argument("--jitter", choices=("uniform", "tent"), default="uniform",
                   help="subpixel filter: uniform (reference binary) or tent "
                        "(sandbox smallpt; XLA integrators only)")
    p.add_argument("--lanes", type=int, default=None,
                   help="wavefront lane-pool width (default: auto-tuned per "
                        "scene by a pilot render — render.tune_wavefront)")
    p.add_argument("--ring", type=int, default=None,
                   help="wavefront retirement-ring depth K (stall headroom; "
                        "default auto — see config.py wavefront_ring)")
    p.add_argument("--profile-dir", default=None, help="capture a jax.profiler trace here")
    p.add_argument(
        "--debug-nans", action="store_true",
        help="numerical sanitizer: raise at the first NaN-producing op "
             "(utils/debug.py; the ASan/UBSan analog, SURVEY.md §5.2)",
    )
    p.add_argument("--mesh", default=None, help="TILESxSAMPLES device mesh, e.g. 4x2")
    # Multi-host process group (parallel/distributed.py); one process/host.
    p.add_argument("--coordinator", default=None, help="process-0 address host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--shard-dir", default=None,
        help="zero-collective mode: each host writes its tile shard here",
    )


def _config(args) -> RenderConfig:
    spp = args.spp
    if spp is None:
        total = args.total_spp if args.total_spp is not None else 4
        spp = max(1, total // (args.subpixels * args.subpixels))
    return RenderConfig(
        width=args.width,
        height=args.height,
        spp=spp,
        num_subpixels=args.subpixels,
        max_depth=args.max_depth,
        rr_depth=args.rr_depth,
        seed=args.seed,
        integrator=args.integrator,
        wavefront_lanes=args.lanes if args.lanes is not None else (1 << 19),
        wavefront_ring=args.ring,
        jitter=args.jitter,
    )


def _maybe_tune(args, scene, cfg) -> RenderConfig:
    """Auto-tune lanes/ring unless the user pinned them (render.tune_wavefront)."""
    if args.lanes is not None or args.ring is not None:
        return cfg
    if cfg.integrator == "batch" or cfg.loop != "while":
        return cfg
    from .render import tune_wavefront

    return tune_wavefront(scene, cfg)


def _scene(args, cfg: RenderConfig):
    if getattr(args, "scene_file", None):
        from .models.io import load_scene

        return load_scene(args.scene_file, cfg.width, cfg.height)
    return get_scene(args.scene, cfg.width, cfg.height)


def _write(path: str, image) -> None:
    if path.endswith(".ppm"):
        write_ppm(path, image)
    else:
        write_png(path, image)


def cmd_render(args) -> int:
    if args.num_processes:
        return _render_multihost(args)
    cfg = _config(args)
    scene = _scene(args, cfg)
    if not args.mesh:
        cfg = _maybe_tune(args, scene, cfg)

    with maybe_trace(args.profile_dir):
        with Timer() as t:
            if args.mesh:
                from .parallel.mesh import make_mesh
                from .parallel.render import render_image_sharded

                n_tiles, n_samples = (int(v) for v in args.mesh.split("x"))
                img = render_image_sharded(scene, cfg, make_mesh(n_tiles, n_samples))
            elif args.tile_cells:
                from .orchestrator import FaultInjector, render_tiled

                injector = (
                    FaultInjector.parse(args.inject_fault) if args.inject_fault else None
                )
                img = render_tiled(
                    scene, cfg,
                    tile_cells=args.tile_cells,
                    checkpoint_path=args.checkpoint,
                    max_retries=args.max_retries,
                    fault_injector=injector,
                    progress=ProgressLogger(cfg.total_spp),
                )
            elif args.checkpoint or args.preview:
                img = render_progressive(
                    scene, cfg, args.checkpoint, args.flush_every,
                    progress=ProgressLogger(cfg.total_spp),
                    preview_path=args.preview,
                )
            else:
                from .render import render_image

                img = render_image(scene, cfg)
            img = jax.block_until_ready(img)

    _write(args.out, np.asarray(img))
    n_rays = cfg.num_cells * cfg.spp
    print(
        f"{args.scene} {cfg.width}x{cfg.height} @ {cfg.total_spp} total spp "
        f"-> {args.out} in {t.seconds:.2f}s ({n_rays / 1e6:.1f}M camera rays)",
        file=sys.stderr,
    )
    return 0


def _render_multihost(args) -> int:
    """Multi-process render: one process per host (parallel/distributed.py).

    Replicated mode (default): the image is all-gathered and process 0 writes
    it.  Shard mode (--shard-dir): zero cross-host collectives — every
    process writes only its own tile shard, then process 0 assembles.
    """
    from .parallel.distributed import (
        assemble_shards,
        global_mesh,
        init_distributed,
        render_image_multihost,
        render_shard_multihost,
        write_shards,
    )

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    cfg = _config(args)
    scene = _scene(args, cfg)
    mesh = global_mesh(n_samples=int(args.mesh.split("x")[1]) if args.mesh else 1)
    pid = jax.process_index()
    for flag in ("tile_cells", "checkpoint", "preview"):
        if getattr(args, flag, None):
            print(f"WARNING: --{flag.replace('_', '-')} is a single-process "
                  f"feature and is ignored under --num-processes",
                  file=sys.stderr)

    with Timer() as t:
        if args.shard_dir:
            from .parallel.distributed import (
                render_fingerprint, signal_lost_hosts, wait_all_or_lost,
                wait_for_shards)

            fp = render_fingerprint(scene, cfg)
            shards = render_shard_multihost(scene, cfg, mesh)
            if args.inject_shard_loss is not None and pid == args.inject_shard_loss:
                # Fault injection (tests): this "host" dies after rendering
                # but before persisting its shard — the crash-at-the-worst-
                # moment case recovery must cover.
                print(f"inject-shard-loss: process {pid} exiting", file=sys.stderr)
                sys.stderr.flush()
                os._exit(3)
            write_shards(args.shard_dir, shards, cfg, pid, fingerprint=fp)
            if pid == 0:
                # Elastic: a file-based wait (atomic shard writes) instead of
                # a collective barrier a dead host would hang forever.
                names = wait_for_shards(args.shard_dir, jax.process_count(),
                                        timeout=args.shard_timeout, fingerprint=fp)
                lost_hosts = len(names) < jax.process_count()
                if lost_hosts:
                    # Broadcast before the (possibly slow) recovery render so
                    # the other survivors can clean-exit immediately.
                    signal_lost_hosts(args.shard_dir)
                img = assemble_shards(args.shard_dir, cfg, scene=scene,
                                      fingerprint=fp)
            else:
                # Survivors must learn whether a host died: the
                # jax.distributed atexit shutdown barrier aborts EVERY
                # remaining process once the coordinator marks the dead task
                # ERROR, so on 'lost' they take the same clean-exit path as
                # process 0.  Margin past --shard-timeout covers
                # process 0's own detection latency.
                outcome = wait_all_or_lost(
                    args.shard_dir, jax.process_count(),
                    timeout=args.shard_timeout + 30.0, fingerprint=fp)
                if outcome == "lost":
                    print(f"process {pid}: host loss signalled; shard written, "
                          f"exiting cleanly", file=sys.stderr)
                    sys.stderr.flush()
                    sys.stdout.flush()
                    os._exit(0)
                if outcome == "timeout":
                    print(f"process {pid}: no completion or loss signal within "
                          f"timeout (process 0 may have died)", file=sys.stderr)
                    return 1
                img = None
        else:
            img = jax.block_until_ready(render_image_multihost(scene, cfg, mesh))
    if pid == 0:
        _write(args.out, np.asarray(img))
        print(
            f"[multihost {jax.process_count()} procs x "
            f"{jax.local_device_count()} devices] {args.scene} "
            f"{cfg.width}x{cfg.height} @ {cfg.total_spp} total spp -> "
            f"{args.out} in {t.seconds:.2f}s",
            file=sys.stderr,
        )
        if args.shard_dir and lost_hosts:
            # A host died: jax.distributed's atexit shutdown barrier would
            # fatally abort this process (the coordination service already
            # marked the dead task ERROR) AFTER our successful recovery.
            # The image is written and synced — exit cleanly and skip it.
            sys.stderr.flush()
            sys.stdout.flush()
            os._exit(0)
    return 0


def cmd_invert(args) -> int:
    """Inverse rendering at production scale (BASELINE config: box_scene
    400x400@64 total spp, max_depth 100).

    Forward pass: the fast wavefront/Pallas path.  Backward: sample-chunked,
    cell-chunked, rematerialized recompute (grad.make_diff_render).  Optimizer
    state checkpoint/resume via --checkpoint (utils/checkpoint.InvertState).
    """
    import optax

    from .grad import make_accum_train_step, render_target, split_params
    from .utils.checkpoint import invert_fingerprint, load_or_init_invert

    cfg = _config(args)
    scene = _scene(args, cfg)

    with Timer() as t_target:
        target = jax.block_until_ready(render_target(scene, cfg, args.cell_chunk))
    print(f"target rendered in {t_target.seconds:.2f}s", file=sys.stderr)

    fields = tuple(args.fields.split(","))
    params = split_params(scene, fields)
    true_params = params
    rng = np.random.default_rng(args.seed)
    params = jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(0, args.perturb, x.shape), x.dtype), params
    )
    optimizer = optax.adam(args.lr)
    opt_state = optimizer.init(params)

    mesh_shape = tuple(int(v) for v in args.mesh.split("x")) if args.mesh else None
    fp = invert_fingerprint(scene, cfg, fields, args.lr,
                            cell_chunk=args.cell_chunk, sample_chunk=args.sample_chunk,
                            mesh_shape=mesh_shape)
    state = load_or_init_invert(args.checkpoint, fp, params, opt_state)
    if state.step:
        print(f"resumed from {args.checkpoint} at step {state.step}", file=sys.stderr)
    params, opt_state = state.params, state.opt_state

    if args.mesh:
        from .grad import make_sharded_accum_train_step
        from .parallel.mesh import make_mesh

        n_tiles, n_samples = (int(v) for v in args.mesh.split("x"))
        step_fn = make_sharded_accum_train_step(
            make_mesh(n_tiles, n_samples), scene, cfg, optimizer,
            cell_chunk=args.cell_chunk, sample_chunk=args.sample_chunk,
            compact=not args.no_compact_backward,
            replay=not args.no_replay_backward,
        )
    else:
        step_fn = make_accum_train_step(
            scene, cfg, optimizer, cell_chunk=args.cell_chunk,
            sample_chunk=args.sample_chunk,
            compact=not args.no_compact_backward,
            replay=not args.no_replay_backward,
        )
    save_every = args.save_every or max(1, args.steps // 10)
    t0 = time.perf_counter()
    for step in range(state.step, args.steps):
        params, opt_state, loss = step_fn(params, opt_state, target)
        if args.checkpoint and ((step + 1) % save_every == 0 or step == args.steps - 1):
            from .utils.checkpoint import InvertState

            jax.block_until_ready(loss)
            InvertState(params, opt_state, step + 1, fp).save(args.checkpoint)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            errs = jax.tree.map(
                lambda p, tp: float(jnp.abs(p - tp).mean()), params, true_params
            )
            sps = (step + 1 - state.step) / (time.perf_counter() - t0)
            rec = {"step": step, "loss": float(loss),
                   "steps_per_s": round(sps, 4), "mean_abs_err": errs}
            # Compacted-backward monitor: parameter drift lengthens paths;
            # report (don't hide) any lanes the capacity schedule truncates
            # at the CURRENT params (grad.backward_drop_count).
            if hasattr(step_fn, "drop_check"):
                d = step_fn.drop_check(params)
                if d:
                    rec["backward_dropped_lanes"] = d
                    print(f"WARNING: compacted backward truncated {d} live "
                          f"lanes at step {step}; gradients carry a "
                          f"depth-truncation bias on those lanes — re-run "
                          f"tuning or pass --no-compact-backward",
                          file=sys.stderr)
            print(json.dumps(rec))
    return 0


# The BASELINE.md benchmark matrix (resolutions/spp from BASELINE.json's
# `configs`; the reference itself hardcodes 1024x768 and publishes no
# numbers), plus the many-sphere stress scenes (they exercise the fused
# kernel's unrolled intersect loop at 13x and 66x the reference's sphere
# count).
BENCH_MATRIX = (
    # (scene, width, height, total_spp)
    ("simple", 640, 480, 16),
    ("box", 400, 400, 64),
    ("depth_of_field", 800, 600, 256),
    ("disco_sphere", 1024, 768, 1024),
    ("random_spheres", 640, 480, 64),
    ("random_spheres_512", 640, 480, 64),
)


def _sample_chunk(spp: int, num_cells: int, items_cap: int = 64 << 20) -> int:
    """Launch-size cap shared with the plain render path (render.py)."""
    from .render import sample_chunk_for

    return sample_chunk_for(spp, num_cells, items_cap)


def _bench_one(scene_name, width, height, total_spp, *, lanes, repeats,
               max_depth=100, collect_hist=False) -> "RenderReport":
    from .ops.wavefront import render_wavefront
    from .render import span_renderer

    spp = max(1, total_spp // 4)
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=max_depth,
                       wavefront_lanes=lanes if lanes is not None else (1 << 19))
    scene = get_scene(scene_name, width, height)
    if lanes is None:
        from .render import tune_wavefront

        cfg = tune_wavefront(scene, cfg)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    chunk = _sample_chunk(spp, cfg.num_cells)
    wf = span_renderer(scene, cfg)

    def run(s, i, start):
        out, stats = wf(s, cfg, i, start, chunk, with_stats=True)
        return jnp.sum(out), stats

    f = jax.jit(run)
    # Warm-up (compile) pass; the stats are deterministic per (scene, cfg),
    # so they are read here, outside the timed renders.
    segments, iters, lanes_used = 0, 0, 0
    for start in range(0, spp, chunk):
        _, stats = f(scene, ids, start)
        segments += int(stats["segments"])
        iters += int(stats.get("iters", 0))
        lanes_used = int(stats.get("lanes", 0))
    seconds = median_seconds(
        lambda: [f(scene, ids, start)[0] for start in range(0, spp, chunk)], repeats)
    hist = None
    if collect_hist:
        # Path-length histogram from an untimed low-spp observability run on
        # the XLA wavefront (the histogram reduce would distort timed numbers).
        _, hstats = jax.jit(
            lambda s, i: render_wavefront(s, cfg, i, 0, 1, with_stats=True,
                                          depth_hist=True)
        )(scene, ids)
        hist = [int(v) for v in jax.device_get(hstats["depth_hist"])]
    return RenderReport(
        scene=scene_name, width=width, height=height, total_spp=cfg.total_spp,
        seconds=seconds, segments=segments, camera_rays=cfg.num_cells * cfg.spp,
        iters=iters, lanes=lanes_used, depth_hist=hist,
    )


def _bench_invert(steps=None, production=None):
    """Inverse-rendering throughput: optimizer steps/s on box_scene at the
    BASELINE.json inverse config (400x400 @ 64 total spp, max_depth 100) —
    fast forward + analytic replay backward (grad.make_accum_train_step).
    On the CPU the config is shrunk (the production size is an accelerator
    workload); the machinery is identical."""
    import optax

    from .grad import make_accum_train_step, render_target, split_params

    if production is None:
        production = jax.default_backend() != "cpu"
    if production:
        cfg = RenderConfig(width=400, height=400, spp=16, max_depth=100)
        cell_chunk, sample_chunk = 1 << 17, 1
        steps = steps or 3
    else:
        cfg = RenderConfig(width=64, height=64, spp=2, max_depth=12)
        cell_chunk, sample_chunk = 1 << 14, 1
        steps = steps or 5
    scene = get_scene("box", cfg.width, cfg.height)
    target = render_target(scene, cfg, cell_chunk)
    params = jax.tree.map(lambda x: x + 0.02, split_params(scene, ("albedo", "emission")))
    optimizer = optax.adam(1e-2)
    opt_state = optimizer.init(params)
    step_fn = make_accum_train_step(scene, cfg, optimizer,
                                    cell_chunk=cell_chunk, sample_chunk=sample_chunk)
    # Warm-up/compile step, then timed steps.
    params, opt_state, loss0 = step_fn(params, opt_state, target)
    jax.block_until_ready(loss0)
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, target)
    jax.block_until_ready(loss)
    dt = time.perf_counter() - t0
    return {
        "scene": (
            f"box (inverse rendering, {cfg.width}x{cfg.height}@{cfg.total_spp} "
            f"total spp, max_depth {cfg.max_depth}, albedo/emission)"
        ),
        "steps_per_s": round(steps / dt, 4),
        "loss_start": float(loss0),
        "loss_end": float(loss),
    }


def cmd_bench_suite(args) -> int:
    from .utils.metrics import MetricsSink

    sink = MetricsSink(echo=True)  # per-scene structured records on stdout
    dev = device_record()
    sink.log(**dev)
    rows = []
    for scene_name, w, h, tspp in BENCH_MATRIX:
        tspp = max(4, tspp // args.suite_scale)
        rep = _bench_one(scene_name, w, h, tspp, lanes=args.lanes,
                         repeats=args.repeats, collect_hist=True)
        rows.append(rep)
        sink.log(**json.loads(rep.to_json()))
        print(rep.summary(), file=sys.stderr)
    inv = _bench_invert()
    sink.log(**inv)

    lines = [
        f"# Benchmark suite — {dev['kind']} x{dev['count']} ({dev['platform']}; "
        f"{dev['nvidia_smi']})",
        "",
        "| scene | resolution | total spp | wall s | Mrays/s | avg depth | occupancy | path-len p50/p90/p99 |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        pct = r.depth_percentiles() or {}
        lines.append(
            f"| {r.scene} | {r.width}x{r.height} | {r.total_spp} | "
            f"{r.seconds:.3f} | {r.mrays_per_s:.1f} | {r.avg_depth:.2f} | "
            f"{100 * r.occupancy:.1f}% | "
            f"{pct.get('p50', '-')}/{pct.get('p90', '-')}/{pct.get('p99', '-')} |"
        )
    lines += [
        "",
        f"Inverse rendering ({inv['scene']}): "
        f"{inv['steps_per_s']} steps/s (loss {inv['loss_start']:.3g} -> {inv['loss_end']:.3g}).",
    ]
    report = "\n".join(lines) + "\n"
    if args.suite_out:
        with open(args.suite_out, "w") as fh:
            fh.write(report)
    print(report, file=sys.stderr)
    return 0


def cmd_bench_scaling(args) -> int:
    """Strong-scaling efficiency harness: the same
    fixed workload rendered on meshes of 1, 2, 4, ... devices (tiles axis);
    reports wall time, Mrays/s, and efficiency vs linear scaling from one
    device.  On a multi-host pod this is the artifact for the BASELINE.md
    ">=90% linear rays/s to 2 hosts" target; locally it runs on the virtual
    CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8
    JAX_PLATFORMS=cpu) — a correctness/plumbing gate, not a hardware-scaling
    measurement, since virtual devices share the same host cores.
    """
    from .parallel.mesh import make_mesh
    from .parallel.render import render_cells_sharded

    devices = jax.devices()
    counts = [c for c in (1, 2, 4, 8, 16, 32, 64) if c <= len(devices)]
    cfg = _config(args)
    scene = _scene(args, cfg)

    rows = []
    for n in counts:
        mesh = make_mesh(n_tiles=n, n_samples=1, devices=devices[:n])
        f = jax.jit(lambda s: render_cells_sharded(s, cfg, mesh))
        jax.block_until_ready(f(scene))  # compile + warm
        best = None
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(scene))
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        rows.append((n, best))
        camera_rays = cfg.num_cells * cfg.spp
        t1 = rows[0][1]
        # NOTE: camera rays (cells x spp), NOT path segments — this field is
        # a fixed-workload rate for relative efficiency only and is not
        # comparable to the headline segments-based Mrays/s (bench.py).
        rec = {
            "devices": n,
            "seconds": round(best, 4),
            "camera_mrays_per_s": round(camera_rays / best / 1e6, 2),
            "speedup": round(t1 / best, 3),
            "efficiency_vs_linear": round(t1 / (n * best), 4),
        }
        print(json.dumps(rec), flush=True)

    dev = jax.devices()[0]
    on_cpu = jax.default_backend() == "cpu"
    title = ("Mesh-scaling PLUMBING GATE" if on_cpu else "Strong scaling")
    lines = [
        f"# {title} — {args.scene} {cfg.width}x{cfg.height}@{cfg.total_spp} "
        f"total spp on {dev.device_kind} ({jax.default_backend()})",
        "",
        "Fixed workload, tiles-axis mesh 1..N devices.  Rates are camera",
        "rays/s (cells x spp / wall), not path segments/s — relative",
        "efficiency only; not comparable to the headline Mrays/s.",
        *(
            [
                "",
                "CAVEAT: cpu backend = N *virtual* devices timesharing one",
                "host's cores (xla_force_host_platform_device_count), so wall",
                "time CANNOT improve with device count — this run is a",
                "correctness/plumbing gate for the sharded path at every mesh",
                "size, not a hardware-scaling measurement.  Interpret the",
                "efficiency column only on a real multi-chip slice.",
            ]
            if jax.default_backend() == "cpu"
            else []
        ),
        "",
        "| devices | wall s | speedup | efficiency vs linear |",
        "|---|---|---|---|",
    ]
    t1 = rows[0][1]
    for n, dt in rows:
        lines.append(f"| {n} | {dt:.3f} | {t1 / dt:.2f}x | {100 * t1 / (n * dt):.1f}% |")
    report = "\n".join(lines) + "\n"
    if args.suite_out:
        with open(args.suite_out, "w") as fh:
            fh.write(report)
    print(report, file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    if args.scaling:
        return cmd_bench_scaling(args)
    if args.suite:
        return cmd_bench_suite(args)
    from .render import span_renderer

    cfg = _config(args)
    scene = _scene(args, cfg)
    cfg = _maybe_tune(args, scene, cfg)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    wf = span_renderer(scene, cfg)
    f = jax.jit(lambda s, i: wf(s, cfg, i, 0, cfg.spp, with_stats=True))
    out, stats = f(scene, ids)
    jax.block_until_ready(out)  # compile + warm
    # Deterministic stats read once, untimed (see _bench_one).
    rep = RenderReport(
        scene=args.scene, width=cfg.width, height=cfg.height,
        total_spp=cfg.total_spp,
        seconds=median_seconds(lambda: f(scene, ids)[0], args.repeats),
        segments=int(stats["segments"]), camera_rays=cfg.num_cells * cfg.spp,
        iters=int(stats.get("iters", 0)), lanes=int(stats.get("lanes", 0)),
    )
    print(json.dumps({**json.loads(rep.to_json()), "device": device_record()}))
    print(rep.summary(), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="cpu_path_tracing_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG/PPM")
    _add_common(pr)
    pr.add_argument("-o", "--out", default="image.png")
    pr.add_argument("--checkpoint", default=None, help="progressive checkpoint path (.npz)")
    pr.add_argument("--flush-every", type=int, default=0, help="samples per checkpoint flush")
    pr.add_argument(
        "--preview", default=None,
        help="write the partial image here after every flush (encoded on the "
             "native writer thread, overlapping device compute)",
    )
    pr.add_argument(
        "--tile-cells", type=int, default=0,
        help="render as independent retried tiles of this many cells "
             "(fault-tolerant path; 0 = single launch)",
    )
    pr.add_argument("--max-retries", type=int, default=2, help="retries per failed tile")
    pr.add_argument(
        "--inject-fault", default=None, metavar="TILE[:TIMES],...",
        help="fault injection: fail these tiles on their first TIMES attempts",
    )
    pr.add_argument(
        "--inject-shard-loss", type=int, default=None, metavar="PROC",
        help="fault injection (multi-host shard mode): process PROC exits "
             "after rendering but before writing its shard — exercises the "
             "elastic recovery path (assemble re-renders the lost span)",
    )
    pr.add_argument(
        "--shard-timeout", type=float, default=300.0,
        help="seconds process 0 waits for other hosts' shard files before "
             "recovering the missing spans locally",
    )
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("invert", help="inverse rendering (recover scene params)")
    _add_common(pi)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=1e-2)
    pi.add_argument("--fields", default="albedo,emission")
    pi.add_argument("--perturb", type=float, default=0.05)
    pi.add_argument("--cell-chunk", type=int, default=1 << 17,
                    help="cells per gradient-accumulation chunk")
    pi.add_argument("--sample-chunk", type=int, default=1,
                    help="samples recomputed per backward slice (memory knob)")
    pi.add_argument("--no-compact-backward", action="store_true",
                    help="disable live-lane compaction in the backward scan "
                         "(grad.tune_backward_schedule)")
    pi.add_argument("--no-replay-backward", action="store_true",
                    help="disable the analytic wavefront-replay backward "
                         "(ops/replay.py) and force the scan VJP even for "
                         "replay-eligible fields")
    pi.add_argument("--checkpoint", default=None,
                    help="optimizer-state checkpoint path (.npz); resumes if present")
    pi.add_argument("--save-every", type=int, default=0,
                    help="checkpoint every N steps (default: steps/10)")
    pi.set_defaults(fn=cmd_invert)

    pb = sub.add_parser("bench", help="throughput benchmark")
    _add_common(pb)
    pb.add_argument("--repeats", type=int, default=3)
    pb.add_argument("--suite", action="store_true",
                    help="run the full BASELINE.md benchmark matrix")
    pb.add_argument("--suite-scale", type=int, default=1,
                    help="divide matrix spp by this (for CPU smoke runs)")
    pb.add_argument("--suite-out", default=None, help="write the markdown table here")
    pb.add_argument("--scaling", action="store_true",
                    help="strong-scaling efficiency over 1,2,4,... device meshes")
    pb.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if getattr(args, "debug_nans", False):
        from .utils.debug import debug_context

        with debug_context(nans=True):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
