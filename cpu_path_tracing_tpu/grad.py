"""Differentiable rendering and inverse rendering.

The reference has no analog — this is the capability this build adds on
top of reproducing it (BASELINE.json north star: pixel gradients w.r.t.
sphere centers/radii, albedos and camera parameters through the
re-parameterized bounce loop; inverse rendering on box_scene).

Estimator: the 'scan' integrator path (fixed trip count — reverse-mode
differentiable, unlike lax.while_loop) with detached discrete decisions; see
ops/integrator.py.  The loss lives in linear radiance space on subpixel cells
(before the clamp of src/main.cpp:195-196, which would zero gradients for
bright pixels).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from .config import RenderConfig
from .models.scene import Scene
from .render import render_cells_range, resolve_integrator
from .parallel.mesh import SAMPLE_AXIS, TILE_AXIS

# Scene fields that may be optimized.
OPTIMIZABLE = ("p0", "radius", "albedo", "emission", "camera", "background")
# Fields whose gradients the analytic replay backward covers (multilinear in
# the estimator — ops/replay.py); the rest need the reverse-mode scan.
OPTIMIZABLE_REPLAY = ("albedo", "emission", "background")


def split_params(scene: Scene, fields=("p0", "radius", "albedo")) -> Dict[str, Any]:
    """Extract an optimizable parameter pytree from a scene."""
    bad = set(fields) - set(OPTIMIZABLE)
    if bad:
        raise ValueError(f"cannot optimize {sorted(bad)}; allowed: {OPTIMIZABLE}")
    return {f: getattr(scene, f) for f in fields}


def merge_params(scene: Scene, params: Dict[str, Any]) -> Scene:
    return dataclasses.replace(scene, **params)


def _diff_cfg(cfg: RenderConfig) -> RenderConfig:
    if cfg.loop == "scan" and cfg.integrator == "batch":
        return cfg
    return cfg.replace(loop="scan", integrator="batch")


def cell_loss(params, scene: Scene, cfg: RenderConfig, cell_ids, target_cells,
              sample_start=0, num_samples=None):
    """Mean squared error between rendered cell radiance and target [B,3]."""
    cfg = _diff_cfg(cfg)
    ns = cfg.spp if num_samples is None else num_samples
    sc = merge_params(scene, params)
    cells = render_cells_range(sc, cfg, cell_ids, sample_start, ns) / ns
    return jnp.mean((cells - target_cells) ** 2)


@partial(jax.jit, static_argnames=("cfg", "optimizer"))
def train_step(params, opt_state, scene: Scene, cfg: RenderConfig, optimizer,
               cell_ids, target_cells):
    """Single-device inverse-rendering step (optax)."""
    loss, grads = jax.value_and_grad(cell_loss)(params, scene, cfg, cell_ids, target_cells)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
    return params, opt_state, loss


def tune_backward_schedule(scene: Scene, cfg: RenderConfig, *, group: int = 4,
                           margin: float = 1.5, min_frac: float = 1.0 / 64,
                           probe_cells: int = 1 << 14):
    """Build a live-lane compaction schedule for the backward scan from a
    pilot survival-curve measurement (the adaptive-depth backward;
    ops/integrator.radiance_compact).

    One cheap 1-sample scan over a strided ~``probe_cells`` cell subset
    yields the live-lane count per bounce depth; stage capacities are
    ``margin`` x the live fraction at each stage start (floored at
    ``min_frac`` against probe noise and parameter drift during
    optimization).  A new stage opens only when the capacity would shrink to
    <=``shrink`` of the previous one: each boundary costs two XLA scatters
    (ops/integrator.radiance_compact), so only >=3x drops
    pay for themselves — box tunes to ~3 boundaries capturing ~80% of the
    dead-lane savings.  Scenes whose paths do not die (specular boxes:
    survival ~1 per bounce) tune to a single full-width stage and return
    None — the plain scan is already optimal there.
    """
    from .ops import rng as rng_ops
    from .ops.integrator import radiance
    from .render import camera_rays

    n = cfg.num_cells
    stride = max(1, n // probe_cells)
    ids = jnp.arange(0, n, stride, dtype=jnp.int32)

    @jax.jit
    def pilot(sc, i):
        keys, o, d = camera_rays(sc, cfg, i, jnp.uint32(0),
                                 rng_ops.master_key(cfg.seed), sc.p0.dtype)
        _, st = radiance(sc, o, d, keys, max_depth=cfg.max_depth,
                         rr_depth=cfg.rr_depth, epsilon=cfg.epsilon,
                         inf=cfg.inf, loop="scan", with_stats=True)
        return st["live_per_depth"]

    curve = np.asarray(jax.device_get(pilot(scene, ids)), np.float64) / ids.shape[0]
    shrink = 1.0 / 3.0
    stages: list[list] = []  # [n_steps, capacity_fraction]
    for d0 in range(0, cfg.max_depth, group):
        g = min(group, cfg.max_depth - d0)
        frac = min(1.0, max(margin * float(curve[d0]), min_frac))
        if stages and frac > shrink * stages[-1][1]:
            stages[-1][0] += g  # shrink too small to pay a compaction for
        else:
            stages.append([g, frac])
    if len(stages) <= 1:
        return None
    return tuple((int(s), float(f)) for s, f in stages)


def backward_drop_count(scene: Scene, cfg: RenderConfig, num_cells: int,
                        params=None, sample_idx: int = 0) -> int:
    """Truncated-lane count of the compacted backward scan at the production
    chunk shape — the monitor that keeps the capacity schedule from being a
    *silent* cap: step builders run it once at build, cmd_invert re-runs it
    periodically as the optimized parameters drift the survival curve."""
    from .ops import rng as rng_ops
    from .ops.integrator import radiance_compact
    from .render import camera_rays

    sc = merge_params(scene, params) if params else scene

    @jax.jit
    def probe(sc, i):
        keys, o, d = camera_rays(sc, cfg, i, jnp.uint32(sample_idx),
                                 rng_ops.master_key(cfg.seed), sc.p0.dtype)
        _, dropped = radiance_compact(
            sc, o, d, keys, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
            epsilon=cfg.epsilon, inf=cfg.inf, schedule=cfg.compact_schedule,
            remat=False)
        return dropped

    ids = jnp.arange(min(num_cells, cfg.num_cells), dtype=jnp.int32)
    return int(jax.device_get(probe(sc, ids)))


def _contracted_render_sum(sc: Scene, cfg: RenderConfig, cell_ids, sample_start,
                           num_samples: int, ct) -> jax.Array:
    """Scalar ``sum(render_cells_range(...) * ct)`` computed through the
    compacted integrator's gather-based retirement (no scatters) — the
    backward-pass primal of ``make_diff_render_span`` (see ``bwd``)."""
    from .ops import rng as rng_ops
    from .ops.integrator import radiance_compact
    from .render import camera_rays

    dtype = sc.p0.dtype
    root_key = rng_ops.master_key(cfg.seed)
    ctd = ct.astype(dtype)

    def one(i):
        keys, o, d = camera_rays(sc, cfg, cell_ids, sample_start + i, root_key, dtype)
        s, _ = radiance_compact(
            sc, o, d, keys, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
            epsilon=cfg.epsilon, inf=cfg.inf, schedule=cfg.compact_schedule,
            remat=cfg.remat, ct=ctd)
        return s

    return jax.lax.fori_loop(0, num_samples, lambda i, a: a + one(i),
                             jnp.zeros((), dtype))


def _compact_bwd_cfg(scene: Scene, cfg: RenderConfig, compact: bool) -> RenderConfig:
    """The backward-pass config: rematerialized scan, plus a pilot-tuned
    live-lane compaction schedule when the scene's survival curve decays
    (None = the caller's explicit schedule wins; shallow scans aren't worth
    the pilot)."""
    bwd = cfg.replace(loop="scan", integrator="batch", remat=True)
    if compact and bwd.compact_schedule is None and cfg.max_depth >= 16:
        sched = tune_backward_schedule(scene, bwd)
        if sched is not None:
            bwd = bwd.replace(compact_schedule=sched)
    return bwd


def make_diff_render(scene: Scene, cfg: RenderConfig, sample_chunk: Optional[int] = None,
                     compact: bool = True, replay: bool = True):
    """Differentiable per-cell MEAN radiance with decoupled forward/backward.

    The production inverse-rendering estimator (BASELINE.json north star:
    "forward + backward intersection/shading kernels at speed-of-light"):

    * **forward** runs the fast early-exit path — the XLA wavefront or the
      fused GPU kernel (``cfg.integrator``, loop='while') — because the
      primal value never needs a tape;
    * **backward** exploits that the rendered mean is a sum of independent
      per-sample estimates, so the VJP is accumulated over ``sample_chunk``-
      sized slices of the sample range, each recomputed with the fixed-trip
      rematerialized scan (loop='scan', remat).  Peak activation memory is
      O(cells x sample_chunk x max_depth x |RayState|) instead of
      O(cells x spp x max_depth x all-intermediates).

    Both sides evaluate the identical estimator; on CPU / XLA integrators the
    wavefront and batch paths are bitwise-equal by test, so the returned
    gradients match end-to-end ``jax.grad`` of the scan path exactly.  With
    the fused kernel on the GPU, the primal (hence the loss cotangent fed to
    the VJP) matches the batch path only statistically at full depth —
    Triton/XLA fp-contraction differences decorrelate a small fraction of
    samples (see ops/pallas/gpu_kernel.py), well below MC noise.

    Returns ``render_mean(params, cell_ids) -> [B,3]`` (jit-compatible,
    reverse-differentiable w.r.t. ``params``).  ``cell_ids`` must be a
    contiguous span (wavefront contract, render.py).
    """
    S = cfg.spp
    render_sum = make_diff_render_span(scene, cfg, S, sample_chunk, compact=compact, replay=replay)

    def render_mean(params, cell_ids):
        return render_sum(params, cell_ids, 0) / S

    render_mean.bwd_cfg = render_sum.bwd_cfg
    return render_mean


def make_diff_render_span(scene: Scene, cfg: RenderConfig, spp_span: int,
                          sample_chunk: Optional[int] = None,
                          compact: bool = True, replay: bool = True):
    """Differentiable per-cell radiance SUM over the ``spp_span`` samples
    starting at a (traced) ``sample_start`` — the span-parameterized core of
    ``make_diff_render``, reusable per sample-axis shard (each mesh shard
    renders its own sample range; see ``make_sharded_accum_train_step``).

    Returns ``render_sum(params, cell_ids, sample_start) -> [B,3]`` with the
    decoupled forward (fast wavefront) / backward (sample-chunked remat scan)
    described in ``make_diff_render``.
    """
    chunk = sample_chunk or spp_span
    if spp_span % chunk:
        raise ValueError(f"sample_chunk={chunk} must divide span={spp_span}")
    fwd_cfg = cfg.replace(loop="while")
    bwd_cfg = _compact_bwd_cfg(scene, cfg, compact)

    @jax.custom_vjp
    def render_sum(params, cell_ids, sample_start):
        sc = merge_params(scene, params)
        return render_cells_range(sc, fwd_cfg, cell_ids, sample_start, spp_span)

    def fwd(params, cell_ids, sample_start):
        return render_sum(params, cell_ids, sample_start), (params, cell_ids, sample_start)

    def bwd(res, ct):
        params, cell_ids, sample_start = res

        if replay and set(params) <= set(OPTIMIZABLE_REPLAY):
            # Analytic wavefront replay: the whole sample span in ONE
            # regenerating early-exit pass — no tape, no transpose, no fixed
            # trip count, O(lanes) memory (ops/replay.py).  sample_chunk is
            # irrelevant here (no activation memory to bound).
            from .ops.replay import replay_param_grads_wavefront

            sc = merge_params(scene, params)
            g = replay_param_grads_wavefront(
                sc, bwd_cfg, cell_ids, sample_start, spp_span, ct)
            g = {k: g[k].astype(params[k].dtype) for k in params}
            return (
                g,
                np.zeros(ct.shape[:1], dtype=jax.dtypes.float0),
                np.zeros((), dtype=jax.dtypes.float0),
            )

        def chunk_grad(s0):
            if bwd_cfg.compact_schedule is not None:
                # Contracted form: grad of sum(render * ct) — mathematically
                # the identical VJP (linearity), but the compacted integrator
                # can then retire lanes by GATHERING ct rows instead of
                # scatter-adding an output image (ops/integrator docstring).
                def floss(p):
                    return _contracted_render_sum(
                        merge_params(scene, p), bwd_cfg, cell_ids, s0, chunk, ct)

                return jax.grad(floss)(params)

            def f(p):
                sc = merge_params(scene, p)
                return render_cells_range(sc, bwd_cfg, cell_ids, s0, chunk)

            _, vjp = jax.vjp(f, params)
            (g,) = vjp(ct)
            return g

        g0 = jax.tree.map(jnp.zeros_like, params)
        g = jax.lax.fori_loop(
            0, spp_span // chunk,
            lambda i, acc: jax.tree.map(jnp.add, acc, chunk_grad(sample_start + i * chunk)),
            g0,
        )
        # cell_ids / sample_start are integer-typed: cotangents are
        # symbolically zero.
        return (
            g,
            np.zeros(ct.shape[:1], dtype=jax.dtypes.float0),
            np.zeros((), dtype=jax.dtypes.float0),
        )

    render_sum.defvjp(fwd, bwd)
    render_sum.bwd_cfg = bwd_cfg  # for drop-check monitoring (step builders)
    return render_sum


def make_accum_train_step(scene: Scene, cfg: RenderConfig, optimizer, *,
                          cell_chunk: Optional[int] = None,
                          sample_chunk: Optional[int] = None,
                          compact: bool = True, replay: bool = True):
    """Single-chip inverse rendering at production scale (BASELINE config:
    box_scene 400x400@64spp, max_depth 100).

    One optimizer step sees the FULL image: the squared-error gradient is
    accumulated over ``cell_chunk``-sized contiguous cell spans (host loop —
    one compilation, chunk shapes are constant) with ``make_diff_render``
    handling sample chunking and rematerialization inside each chunk.

    Returns ``step(params, opt_state, targets) -> (params, opt_state, loss)``
    where ``targets`` is the [num_cells, 3] mean-radiance target and ``loss``
    is the exact full-image MSE (computed from the fast forward pass).
    """
    n = cfg.num_cells
    cc = min(cell_chunk or n, n)
    render_mean = make_diff_render(scene, cfg, sample_chunk, compact=compact, replay=replay)
    bwd_cfg = render_mean.bwd_cfg
    if bwd_cfg.compact_schedule is not None:
        # Validate the pilot-tuned compaction capacities at the REAL chunk
        # shape before trusting them (the pilot ran on a strided subset); if
        # any live lane would be truncated, fall back to the exact plain
        # scan rather than bias gradients.
        if backward_drop_count(scene, bwd_cfg, cc) > 0:
            import sys

            print("make_accum_train_step: compaction schedule dropped live "
                  "lanes at the production chunk shape; disabling compaction",
                  file=sys.stderr)
            render_mean = make_diff_render(scene, cfg, sample_chunk, compact=False, replay=replay)
            bwd_cfg = render_mean.bwd_cfg

    @jax.jit
    def chunk_loss_grad(params, cell_ids, target):
        def loss_fn(p):
            return jnp.sum((render_mean(p, cell_ids) - target) ** 2)

        return jax.value_and_grad(loss_fn)(params)

    @jax.jit
    def finalize(params, opt_state, sq_sum, grads):
        denom = jnp.asarray(3 * n, sq_sum.dtype)
        grads = jax.tree.map(lambda g: g / denom, grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, sq_sum / denom

    def step(params, opt_state, targets):
        sq_sum = None
        grads = None
        for start in range(0, n, cc):
            stop = min(start + cc, n)
            ids = jnp.arange(start, stop, dtype=jnp.int32)
            l, g = chunk_loss_grad(params, ids, targets[start:stop])
            sq_sum = l if sq_sum is None else sq_sum + l
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        return finalize(params, opt_state, sq_sum, grads)

    if bwd_cfg.compact_schedule is not None:
        # Periodic monitor for cmd_invert: parameter drift lengthens paths;
        # a nonzero count means the schedule needs re-tuning.
        step.drop_check = lambda params=None: backward_drop_count(
            scene, bwd_cfg, cc, params=params)
    return step


def make_sharded_accum_train_step(mesh, scene: Scene, cfg: RenderConfig, optimizer, *,
                                  cell_chunk: Optional[int] = None,
                                  sample_chunk: Optional[int] = None,
                                  compact: bool = True, replay: bool = True):
    """Mesh-parallel inverse rendering at production scale:
    the composition of ``make_accum_train_step``'s memory machinery (host
    loop over cell chunks; sample-chunked rematerialized backward) with the
    SURVEY §5.8 collective layout (cells sharded over 'tiles', sample range
    sharded over 'samples', scene/params replicated, grads psum-reduced).

    Per optimizer step, each device sees ``cell_chunk/n_tiles`` cells x
    ``spp/n_samples/sample_chunk`` recompute chunks — peak activation memory
    is O(cell_chunk/n_tiles x sample_chunk x max_depth x |RayState|)
    regardless of image size or total spp, so the BASELINE inverse config
    (box 400x400 @ 64spp, max_depth 100) fits any chip count.

    Returns ``step(params, opt_state, targets) -> (params, opt_state, loss)``
    with ``targets`` the full [num_cells,3] mean-radiance target and ``loss``
    the exact full-image MSE.  The update is identical to the single-chip
    ``make_accum_train_step`` up to f32 summation order (partial sums are
    psum'd across shards instead of sequentially accumulated).
    """
    n = cfg.num_cells
    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    if cfg.spp % n_samp:
        raise ValueError(f"spp={cfg.spp} not divisible by sample axis {n_samp}")
    spp_local = cfg.spp // n_samp
    # Each cell chunk is split evenly across the tile axis.
    cc = min(cell_chunk or n, n)
    cc = -(-cc // n_tiles) * n_tiles
    render_sum = make_diff_render_span(scene, cfg, spp_local, sample_chunk,
                                       compact=compact, replay=replay)
    if render_sum.bwd_cfg.compact_schedule is not None and backward_drop_count(
            scene, render_sum.bwd_cfg, cc // n_tiles) > 0:
        import sys

        print("make_sharded_accum_train_step: compaction schedule dropped "
              "live lanes at the per-shard chunk shape; disabling compaction",
              file=sys.stderr)
        render_sum = make_diff_render_span(scene, cfg, spp_local, sample_chunk,
                                           compact=False)

    def shard_fn(params, cell_ids, target, mask):
        cell_ids = jax.lax.pcast(cell_ids, SAMPLE_AXIS, to="varying")

        def local_loss(p):
            s0 = jax.lax.axis_index(SAMPLE_AXIS) * spp_local
            cells = render_sum(p, cell_ids, s0)
            cells = jax.lax.psum(cells, SAMPLE_AXIS) / cfg.spp
            return jnp.sum(mask[:, None] * (cells - target) ** 2)

        sq, grads = jax.value_and_grad(local_loss)(params)
        # Sum of squared errors decomposes over tile shards.
        sq = jax.lax.psum(sq, TILE_AXIS)
        if not vma:
            # Without vma tracking (fused kernel or replay) the per-shard grads are
            # partials: sum over tiles; every sample shard saw the full
            # sample psum, so pmean (not psum) there.
            grads = jax.lax.psum(grads, TILE_AXIS)
            grads = jax.lax.pmean(grads, SAMPLE_AXIS)
        # With vma tracking, AD's transpose of the params pbroadcast already
        # psum'd the grads over BOTH mesh axes (each sample shard contributes
        # its own sample range through the cells psum) — adding collectives
        # here would double-count (tests/test_parallel.py pins the scale).
        return sq, grads

    # vma checking stays on unless (a) the fast forward resolves to the
    # fused GPU kernel (pallas_call outputs carry no vma metadata), or (b) the
    # replay backward is active: its custom-vjp gradients are computed
    # outside AD, so the vma checker cannot see the replication the
    # pbroadcast transpose would otherwise provide — use the same
    # explicit-collectives path (psum tiles + pmean samples; the pmean
    # because the no-vma psum transpose scales the cotangent by n_samples,
    # the explicit-collectives semantics the mesh tests pin).
    vma = resolve_integrator(scene, cfg) != "pallas" and not replay
    sharded_chunk = jax.jit(jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS)),
        out_specs=(P(), P()),
        check_vma=vma,
    ))

    @jax.jit
    def finalize(params, opt_state, sq_sum, grads):
        denom = jnp.asarray(3 * n, sq_sum.dtype)
        grads = jax.tree.map(lambda g: g / denom, grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, sq_sum / denom

    def step(params, opt_state, targets):
        sq_sum = None
        grads = None
        targets = jnp.asarray(targets)
        for start in range(0, n, cc):
            # Pad the last chunk with ids CONTINUING past n: the wavefront
            # contract needs a contiguous span, and off-screen cells render
            # fine (rays past the viewport edge); the mask zeroes their loss
            # and gradient contribution.
            ids = np.arange(start, start + cc, dtype=np.int32)
            mask = (ids < n).astype(np.float32)
            tgt = targets[np.minimum(ids, n - 1)]
            l, g = sharded_chunk(params, jnp.asarray(ids), tgt, jnp.asarray(mask))
            sq_sum = l if sq_sum is None else sq_sum + l
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        return finalize(params, opt_state, sq_sum, grads)

    return step


@partial(jax.jit, static_argnames=("cfg",))
def _render_mean_chunk(scene: Scene, cfg: RenderConfig, cell_ids) -> jax.Array:
    # Module-level jit (not a per-call lambda) so repeated render_target
    # calls in one session hit the compile cache.
    return render_cells_range(scene, cfg, cell_ids, 0, cfg.spp) / cfg.spp


def render_target(scene: Scene, cfg: RenderConfig, cell_chunk: Optional[int] = None) -> jax.Array:
    """Fast-forward mean-radiance target [num_cells,3] for inverse rendering,
    rendered in cell chunks (bounds the wavefront item buffer)."""
    n = cfg.num_cells
    cc = min(cell_chunk or n, n)
    fwd_cfg = cfg.replace(loop="while")
    outs = []
    for start in range(0, n, cc):
        ids = jnp.arange(start, min(start + cc, n), dtype=jnp.int32)
        outs.append(_render_mean_chunk(scene, fwd_cfg, ids))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def make_sharded_train_step(mesh, cfg: RenderConfig, optimizer):
    """Mesh-parallel training step: cells sharded over 'tiles', samples over
    'samples', scene/optimizer state replicated, gradients psum-reduced over
    both axes (overlappable with the backward pass by XLA).  The inverse-mode
    collective layout of SURVEY.md §5.8.
    """
    cfg = _diff_cfg(cfg)
    n_samp = mesh.shape[SAMPLE_AXIS]
    if cfg.spp % n_samp:
        raise ValueError(f"spp={cfg.spp} not divisible by sample axis {n_samp}")
    spp_local = cfg.spp // n_samp

    n_tiles = mesh.shape[TILE_AXIS]

    def shard_fn(params, opt_state, scene, cell_ids, target_cells):
        # Varying over the sample axis too — see parallel/render.py.
        cell_ids = jax.lax.pcast(cell_ids, SAMPLE_AXIS, to="varying")

        def local_loss(p):
            s0 = jax.lax.axis_index(SAMPLE_AXIS) * spp_local
            sc = merge_params(scene, p)
            cells = render_cells_range(sc, cfg, cell_ids, s0, spp_local)
            cells = jax.lax.psum(cells, SAMPLE_AXIS) / cfg.spp
            # 1/n_tiles so the tile psum of this shard term IS the global
            # mean (equal shard sizes by construction, parallel/render.py).
            return jnp.mean((cells - target_cells) ** 2) / n_tiles

        loss, grads = jax.value_and_grad(local_loss)(params)
        loss = jax.lax.psum(loss, TILE_AXIS)
        # grads needs NO collective: under shard_map's vma tracking, AD's
        # transpose of the replicated-params pbroadcast already psums the
        # per-shard partials over both mesh axes.  (An explicit pmean here —
        # as this function had through round 2 — left grads n_tiles x too
        # large, invisible under Adam's scale invariance except at eps
        # level; caught by the exact-match test of the accum variant.)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(TILE_AXIS), P(TILE_AXIS)),
        out_specs=(P(), P(), P()),
    )
    return jax.jit(fn)
