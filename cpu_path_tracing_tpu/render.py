"""High-level rendering pipeline.

Replacement for the reference's driver loop
(``main``/``render_subpixel``, ``src/main.cpp:160-248``): instead of one
Taskflow task per image row with a sequential per-row RNG
(``src/main.cpp:214-236``), the image is a flat array of *subpixel cells*
(pixel x 2x2 subpixels), rays for all cells advance together, and samples
accumulate in a device-resident ``fori_loop``.  Determinism is total: the
image is a pure function of (scene, config, seed), independent of chunking or
device mesh (ops/rng.py).

Layout: cell = (y*W + x) * ns^2 + sy*ns + sx, with y=0 the *bottom* image row
(the reference's vertical flip ``row = (h-y-1)*w + x``, ``src/main.cpp:181``,
happens at image assembly).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import RenderConfig
from .models.camera import build_camera, get_rays
from .models.scene import Scene
from .ops import rng as rng_ops
from .ops.integrator import radiance


def decode_cells(cell_ids, cfg: RenderConfig):
    """cell id -> (x, y, sx, sy) int32 arrays."""
    ns = cfg.num_subpixels
    sub = cell_ids % (ns * ns)
    pix = cell_ids // (ns * ns)
    sx = sub % ns
    sy = sub // ns
    x = pix % cfg.width
    y = pix // cfg.width
    return x, y, sx, sy


def camera_rays_for_cells(scene: Scene, cfg: RenderConfig, cell_ids, u4, dtype):
    """Thin-lens rays for given cells from a [B,4] camera-uniform block.

    Mirrors ``render_subpixel``'s jitter (uniform within the subpixel cell,
    ``src/main.cpp:186-190``) + ``camera::get_ray`` (``src/camera.cpp:32-38``).
    """
    ns = cfg.num_subpixels
    x, y, sx, sy = decode_cells(cell_ids, cfg)
    sub_len = 1.0 / ns
    if cfg.jitter == "tent":
        # smallpt's tent filter (sandbox/main.cpp:253-256): r=2u,
        # dx = r<1 ? sqrt(r)-1 : 1-sqrt(2-r) in [-1,1] about the subpixel
        # CENTER — the kernel overlaps neighbouring subpixels.
        def _tent(u):
            r = 2.0 * u
            return jnp.where(r < 1.0, jnp.sqrt(r) - 1.0, 1.0 - jnp.sqrt(2.0 - r))

        jx = 0.5 + _tent(u4[:, 0])
        jy = 0.5 + _tent(u4[:, 1])
    else:
        jx, jy = u4[:, 0], u4[:, 1]
    x_in = x.astype(dtype) + sx.astype(dtype) * sub_len + jx * sub_len
    y_in = y.astype(dtype) + sy.astype(dtype) * sub_len + jy * sub_len
    # Multiply by the reciprocal constant (not divide) — the fused kernel's
    # exact structure (ops/intersect.py docstring on why this matters).
    s = x_in * jnp.asarray(1.0 / cfg.width, dtype)
    t = y_in * jnp.asarray(1.0 / cfg.height, dtype)
    cam = build_camera(scene.camera)
    return get_rays(cam, s, t, u4[:, 2], u4[:, 3])


def camera_rays(scene: Scene, cfg: RenderConfig, cell_ids, sample_idx, root_key, dtype):
    """Per-(cell, sample) keys + jittered thin-lens rays.

    Returns ((a0, a1), origins [B,3], dirs [B,3]).
    """
    a0, a1 = rng_ops.item_keys(root_key, cell_ids, sample_idx)
    u = rng_ops.camera_uniforms(a0, a1).astype(dtype)
    origins, dirs = camera_rays_for_cells(scene, cfg, cell_ids, u, dtype)
    return (a0, a1), origins, dirs


def check_contiguous_cells(cell_ids) -> None:
    """Reject non-contiguous cell id sets on the wavefront paths.

    The wavefront integrators regenerate ids as ``cell_ids[0] + offset`` (no
    per-iteration id-table gather), so an arbitrary id set would
    silently render the WRONG cells.  Validate whenever the ids are concrete
    (i.e. the caller passed a real array rather than a tracer); under jit the
    contract is enforced at the jitted boundary where the array was concrete.
    """
    try:
        ids = np.asarray(cell_ids)
    except Exception:  # traced values: contract checked at the concrete caller
        return
    if ids.size and not (np.all(np.diff(ids) == 1)):
        raise ValueError(
            "wavefront integrators require a contiguous ascending cell_ids "
            "span (got a non-contiguous id set); use integrator='batch' for "
            "arbitrary id sets"
        )


def resolve_integrator(scene: Scene, cfg: RenderConfig) -> str:
    """The one place that picks the integrator for this backend and scene.

    ``auto`` resolves to the fused GPU kernel (``pallas``,
    ops/pallas/gpu_kernel.py) on the ``gpu`` backend for float32 scenes
    with uniform jitter, and to the XLA wavefront everywhere else.  An
    explicit choice is returned as given, after checking the kernel's
    jitter filter."""
    integ = cfg.integrator
    if integ == "auto":
        on_gpu = jax.default_backend() == "gpu"
        f32 = scene.p0.dtype == jnp.float32
        integ = "pallas" if (on_gpu and f32 and cfg.jitter == "uniform") else "wavefront"
    if integ == "pallas" and cfg.jitter != "uniform":
        raise ValueError(
            f"jitter={cfg.jitter!r} is not implemented in the fused GPU "
            f"kernel's in-kernel camera; use integrator='wavefront'/'batch'")
    return integ


def span_renderer(scene: Scene, cfg: RenderConfig):
    """The forward span renderer ``resolve_integrator`` picks, for callers
    that want its stats: ``f(scene, cfg, cell_ids, sample_start, n,
    with_stats=True) -> (sums, {"segments", ...})``."""
    if resolve_integrator(scene, cfg) == "pallas":
        from .ops.pallas.gpu_kernel import render_kernel

        return render_kernel
    from .ops.wavefront import render_wavefront

    return render_wavefront


def render_cells_range(scene: Scene, cfg: RenderConfig, cell_ids, sample_start, num_samples: int) -> jax.Array:
    """SUM of radiance over samples [sample_start, sample_start+num_samples).

    The building block for sample-sharded and progressive rendering: because
    keys depend only on (seed, cell, sample), any partition of the sample
    range sums to the identical total.  [B,3], un-clamped, un-normalized.

    NOTE: the wavefront integrator assumes ``cell_ids`` is a CONTIGUOUS span
    (it regenerates ids as cell_ids[0] + offset, with no id-table gather).
    Every in-tree caller passes arange spans; pass
    integrator='batch' for arbitrary id sets.  Concrete non-contiguous ids
    raise (check_contiguous_cells).
    """
    integ = resolve_integrator(scene, cfg)
    if integ in ("wavefront", "pallas"):
        check_contiguous_cells(cell_ids)
        if cfg.loop == "while":
            return span_renderer(scene, cfg)(scene, cfg, cell_ids, sample_start, num_samples)

    dtype = scene.p0.dtype
    root_key = rng_ops.master_key(cfg.seed)

    def one_sample(sample_idx):
        keys, o, d = camera_rays(scene, cfg, cell_ids, sample_idx, root_key, dtype)
        if cfg.loop == "scan" and cfg.compact_schedule is not None:
            from .ops.integrator import radiance_compact

            out, _ = radiance_compact(
                scene, o, d, keys,
                max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                epsilon=cfg.epsilon, inf=cfg.inf,
                schedule=cfg.compact_schedule, remat=cfg.remat,
            )
            return out
        return radiance(
            scene, o, d, keys,
            max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
            epsilon=cfg.epsilon, inf=cfg.inf, loop=cfg.loop, remat=cfg.remat,
        )

    def body(i, acc):
        return acc + one_sample(sample_start + i)

    # Accumulator derived from cell_ids (not a fresh constant) so the carry
    # is mesh-varying under shard_map (cf. ops/integrator.py init_state).
    acc0 = (cell_ids[:, None] * 0).astype(dtype) + jnp.zeros((1, 3), dtype)
    return jax.lax.fori_loop(0, num_samples, body, acc0, unroll=False)


def tune_wavefront(scene: Scene, cfg: RenderConfig, probe_cells: int = 1 << 15) -> RenderConfig:
    """Auto-tune the wavefront lane-pool width and ring depth for this scene.

    The wavefront's throughput regime depends on the path-length
    distribution:

    * LONG-path scenes (closed boxes, E[depth] ~ 12): per-generation work
      dominates; a maximal pool (cfg.wavefront_lanes) at ring K=8 is best.
    * SHORT-path scenes (sky-escape, E[depth] ~ 2 with RR straggler tails to
      60+): a maximal pool leaves only ~n_items/B generations, so the final
      generations' stragglers run ~100 iterations against a mostly-idle pool
      (drain tail), and mid-render the K-generation stall headroom binds.
      Shrinking the pool (more generations, relatively smaller tail) and
      deepening the ring shortens that tail.  On the H100 this tuning is
      not measured yet.

    Pilot: one-sample batch-integrator render of a strided ~``probe_cells``
    cell subset (strided, not a contiguous span — path length correlates
    with image row) measuring segments/ray = E[depth].  The pilot compiles
    once per (shape, config) — scenes are traced arguments — and costs
    milliseconds to run.  Explicit ``wavefront_ring`` settings are
    respected; only the lane/ring pair is tuned.
    """
    from .ops import rng as rng_ops
    from .ops.integrator import radiance

    # The fused GPU kernel has no lane pool or ring to tune.
    if resolve_integrator(scene, cfg) == "pallas":
        return cfg

    n = cfg.num_cells
    stride = max(1, n // probe_cells)
    ids = jnp.arange(0, n, stride, dtype=jnp.int32)

    @partial(jax.jit, static_argnames=("c",))
    def pilot(sc, i, c):
        keys, o, d = camera_rays(sc, c, i, jnp.uint32(0), rng_ops.master_key(c.seed), sc.p0.dtype)
        _, st = radiance(sc, o, d, keys, max_depth=c.max_depth, rr_depth=c.rr_depth,
                         epsilon=c.epsilon, inf=c.inf, loop="while", with_stats=True)
        return st["segments"]

    e_depth = float(jax.device_get(pilot(scene, ids, cfg))) / ids.shape[0]
    if e_depth >= 8.0:
        return cfg  # long-path regime: the defaults are right
    # Short-path regime: bound the drain tail by targeting >=256 generations
    # per launch (launch size mirrors the bench/CLI sample chunking cap).
    items = min(n * cfg.spp, 64 << 20)
    lanes = max(1 << 16, min(cfg.wavefront_lanes, items // 256))
    ring = cfg.wavefront_ring if cfg.wavefront_ring is not None else 32
    return cfg.replace(wavefront_lanes=int(lanes), wavefront_ring=ring)


def sample_chunk_for(spp: int, num_cells: int, items_cap: int = 64 << 20) -> int:
    """Largest divisor of spp keeping num_cells*chunk items per launch under
    the cap (the wavefront's item-output buffer is 12 bytes/item — one launch
    of disco_sphere@1024 total spp would need ~9.7 GB of HBM unchunked)."""
    cap = max(1, items_cap // max(1, num_cells))
    return max(c for c in range(1, min(spp, cap) + 1) if spp % c == 0)


@partial(jax.jit, static_argnames=("cfg",))
def render_cells(scene: Scene, cfg: RenderConfig, cell_ids) -> jax.Array:
    """Mean radiance over cfg.spp samples for each cell.  [B,3], un-clamped."""
    return render_cells_range(scene, cfg, cell_ids, 0, cfg.spp) / cfg.spp


@partial(jax.jit, static_argnames=("cfg", "num_samples"))
def _render_cells_span(scene: Scene, cfg: RenderConfig, cell_ids,
                       sample_start, num_samples: int) -> jax.Array:
    """Jitted radiance SUM over a sample sub-range (one compile per span
    length; ``sample_start`` stays traced so every chunk reuses it)."""
    return render_cells_range(scene, cfg, cell_ids, sample_start, num_samples)


def finalize_image(cell_means: jax.Array, cfg: RenderConfig) -> jax.Array:
    """Cell means [num_cells,3] -> linear image [H,W,3] (top row first).

    Per-subpixel clamp to [0,1] *before* averaging the ns^2 subpixels — the
    reference's (smallpt-inherited) bright-pixel bias, ``src/main.cpp:195-196``
    (SURVEY.md fidelity #2).
    """
    ns2 = cfg.num_subpixels * cfg.num_subpixels
    c = jnp.clip(cell_means, 0.0, 1.0)
    pixels = c.reshape(cfg.height, cfg.width, ns2, 3).mean(axis=2)
    return pixels[::-1]  # y=0 is the bottom row; files are top-to-bottom


def render_image(scene: Scene, cfg: RenderConfig) -> jax.Array:
    """Render the full image.  Returns linear-radiance [H,W,3] float array.

    Samples are chunked so no single launch's item buffer exceeds the
    ``sample_chunk_for`` cap (an unchunked ``render --scene disco_sphere
    --total-spp 1024`` would allocate a ~9.7 GB item buffer); cells are
    additionally chunked to
    cfg.ray_chunk when set.  Keys depend only on (seed, cell, sample)
    (ops/rng.py), so cell chunking is bitwise-invariant; sample chunking —
    which only engages above the item cap — re-associates the per-cell f32
    sample sum ((s0..s7)+(s8..s15) vs s0+...+s15), the same ~1-ulp caveat as
    a sample-sharded mesh (parallel/distributed.py).
    """
    n = cfg.num_cells
    chunk = cfg.ray_chunk or n
    # Keep whole pixels inside one chunk so finalize can reduce subpixels.
    ns2 = cfg.num_subpixels * cfg.num_subpixels
    chunk = max(ns2, chunk - chunk % ns2)

    outs = []
    for start in range(0, n, chunk):
        ids = jnp.arange(start, min(start + chunk, n), dtype=jnp.int32)
        schunk = sample_chunk_for(cfg.spp, ids.shape[0])
        if schunk == cfg.spp:
            outs.append(render_cells(scene, cfg, ids))
        else:
            acc = _render_cells_span(scene, cfg, ids, 0, schunk)
            for s0 in range(schunk, cfg.spp, schunk):
                acc = acc + _render_cells_span(scene, cfg, ids, s0, schunk)
            outs.append(acc / cfg.spp)
    cell_means = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
    return finalize_image(cell_means, cfg)
