"""Persistent wavefront integrator with generation-striped ray regeneration.

The performance core of the framework, and the structural opposite of the
reference's per-ray recursion: the reference traces each camera sample to
completion before starting the next (``render_subpixel``,
``src/main.cpp:184-193``), which on a SIMD machine would leave most lanes
idle — in the disco scene, paths that only ever hit the glass sphere or the
light (RR survival p >= 1, ``src/main.cpp:128-137``) die *only* at the
100-bounce depth limit, so a naive batched loop runs ~100 iterations at ~12%
mean occupancy.

Design:

* A fixed pool of B lanes is kept saturated: whenever a lane's path
  terminates it immediately pulls its next work item and generates the
  camera ray in-register.  Iterations ~= total_segments / B + one drain
  tail, instead of (#sample batches x max_depth).

* Work items are **generation-striped**: lane ``l`` processes items
  ``g*B + l`` for g = 0,1,2,...  This makes the output location of every
  result a *dense, lane-indexed* slot, so retirement needs no scatter with
  arbitrary indices.  Finished results go to a K-deep ring of [B,3] buffers
  (K masked dense updates per iteration); when every lane has passed
  generation g (a min-reduce watermark), that ring slot is flushed into the
  output with one dynamic-update-slice and recycled.  A lane stalls only if
  it runs K whole generations ahead of the slowest lane.

Determinism: item keys depend only on (seed, cell, sample) — ops/rng.py — so
per-item radiance is bit-identical to the batch integrator's, and the final
sample-major reduction makes the per-cell sums independent of lane schedule.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.scene import Scene
from . import rng as rng_ops
from .integrator import RayState, bounce_step


def _resolve_ring_depth(cfg: RenderConfig, ring_depth) -> int:
    """Ring depth K: explicit kwarg > cfg.wavefront_ring > default 8.

    K bounds how many generations a fast lane may run ahead of the slowest
    (see config.py wavefront_ring); per-iteration ring traffic is K*B*3
    floats read+write, so bigger K trades bandwidth for stall headroom.
    """
    if ring_depth is not None:
        return ring_depth
    if cfg.wavefront_ring is not None:
        return cfg.wavefront_ring
    return 8


class LaneState(NamedTuple):
    ray: RayState
    depth: jax.Array  # [B] int32 per-lane bounce depth
    gen: jax.Array  # [B] int32 generation of the lane's current/last item
    k0: jax.Array  # [B] uint32 item key
    k1: jax.Array  # [B] uint32


def render_wavefront(
    scene: Scene,
    cfg: RenderConfig,
    cell_ids,
    sample_start,
    num_samples: int,
    *,
    lanes: int | None = None,
    ring_depth: int | None = None,
    with_stats: bool = False,
    depth_hist: bool = False,
):
    """SUM of radiance over the sample range for each cell — the persistent
    replacement for the batch path in render.render_cells_range.

    Returns [n_cells, 3] sums (divide by num_samples for the mean), plus a
    stats dict when requested: ``segments`` (total path segments traced),
    ``iters`` (loop iterations) and ``lanes`` — occupancy is
    ``segments / (iters * lanes)``, the number that substantiates the
    persistent design's saturation claim (SURVEY.md §5.1/§5.5).  With
    ``depth_hist`` also ``depth_hist``: [max_depth] int32, count of items
    retired after exactly d+1 segments (costs a [B, max_depth] compare-reduce
    per iteration — enable for observability runs, not timed benchmarks).
    """
    from ..render import camera_rays_for_cells, check_contiguous_cells  # local import to avoid cycle

    check_contiguous_cells(cell_ids)
    dtype = scene.p0.dtype
    n_cells = cell_ids.shape[0]
    n_items = n_cells * num_samples
    B = int(min(lanes or cfg.wavefront_lanes, n_items))
    K = _resolve_ring_depth(cfg, ring_depth)
    n_gens = -(-n_items // B)
    seed_pair = rng_ops.master_key(cfg.seed)

    # Varying zeros (derived from cell_ids so shard_map vma typing holds).
    vzero = (cell_ids[0] * 0).astype(jnp.int32)
    lane_izero = jnp.zeros((B,), jnp.int32) + vzero
    lane_fzero3 = jnp.zeros((B, 3), dtype) + vzero.astype(dtype)

    state0 = LaneState(
        ray=RayState(
            origin=lane_fzero3,
            direction=lane_fzero3 + 1.0,
            throughput=lane_fzero3,
            emission=lane_fzero3,
            alive=lane_izero == 1,  # all idle
            result=lane_fzero3,
        ),
        depth=lane_izero,
        gen=lane_izero - 1,  # no item processed yet
        k0=lane_izero.astype(jnp.uint32),
        k1=lane_izero.astype(jnp.uint32),
    )
    ring0 = jnp.zeros((K, B, 3), dtype) + vzero.astype(dtype)
    out0 = jnp.zeros((n_gens * B, 3), dtype) + vzero.astype(dtype)
    g_flush0 = vzero  # next generation to flush
    nseg0 = vzero

    lane_iota = jnp.arange(B, dtype=jnp.int32)
    kw = dict(rr_depth=cfg.rr_depth, epsilon=cfg.epsilon, inf=cfg.inf)

    def regenerate(st: LaneState, g_flush):
        want_g = st.gen + 1
        can_start = (~st.ray.alive) & (want_g < n_gens) & (want_g < g_flush + K)
        item = want_g * B + lane_iota
        real = can_start & (item < n_items)

        c_idx = item % n_cells
        s_idx = (sample_start + item // n_cells).astype(jnp.uint32)
        # Contiguity assumption (documented in render_cells_range): cell_ids
        # is a contiguous span, so the global id is start + offset, with no
        # gather from a megapixel-sized id table.  The clamp keeps padded
        # tail lanes on a valid (duplicate) cell; their results land in
        # padding slots the caller discards.
        cells_g = jnp.minimum(cell_ids[0] + c_idx, cfg.width * cfg.height
                              * cfg.num_subpixels * cfg.num_subpixels - 1)
        a0, a1 = rng_ops.item_keys(seed_pair, cells_g, s_idx)
        u = rng_ops.camera_uniforms(a0, a1).astype(dtype)
        o_n, d_n = camera_rays_for_cells(scene, cfg, cells_g, u, dtype)

        tm = real[:, None]
        ray = RayState(
            origin=jnp.where(tm, o_n, st.ray.origin),
            direction=jnp.where(tm, d_n, st.ray.direction),
            throughput=jnp.where(tm, 1.0, st.ray.throughput),
            emission=jnp.where(tm, 0.0, st.ray.emission),
            alive=st.ray.alive | real,
            result=jnp.where(tm, 0.0, st.ray.result),
        )
        return LaneState(
            ray=ray,
            depth=jnp.where(real, 0, st.depth),
            gen=jnp.where(can_start, want_g, st.gen),  # pad items skip ahead
            k0=jnp.where(real, a0, st.k0),
            k1=jnp.where(real, a1, st.k1),
        )

    hist0 = jnp.zeros((cfg.max_depth,), jnp.int32) + vzero
    depth_bins = jnp.arange(1, cfg.max_depth + 1, dtype=jnp.int32)

    def cond(carry):
        st, ring, out, g_flush, nseg, iters, hist = carry
        return g_flush < n_gens

    def body(carry):
        st, ring, out, g_flush, nseg, iters, hist = carry
        with jax.named_scope("wf_regen"):
            st = regenerate(st, g_flush)
        was_alive = st.ray.alive
        nseg = nseg + jnp.sum(was_alive, dtype=jnp.int32)
        iters = iters + 1

        with jax.named_scope("wf_bounce"):
            u = rng_ops.bounce_uniforms(st.k0, st.k1, st.depth).astype(dtype)
            ray = bounce_step(scene, st.ray, u, st.depth, **kw)
        depth = jnp.where(was_alive, st.depth + 1, st.depth)

        # Depth-limit exhaustion: return accumulated emission (main.cpp:157).
        exhausted = ray.alive & (depth >= cfg.max_depth)
        result = jnp.where(exhausted[:, None], ray.emission, ray.result)
        alive = ray.alive & ~exhausted
        ray = ray._replace(alive=alive, result=result)
        st = LaneState(ray, depth, st.gen, st.k0, st.k1)

        # Retire finished results into the dense lane-indexed ring.
        with jax.named_scope("wf_retire"):
            finished = was_alive & ~alive
            if depth_hist:
                hist = hist + jnp.sum(
                    finished[:, None] & (depth[:, None] == depth_bins[None, :]),
                    axis=0, dtype=jnp.int32,
                )
            slot = st.gen % K  # [B]
            fr = jnp.where(finished[:, None], result, 0.0)
            onehot = (slot[None, :] == jnp.arange(K, dtype=jnp.int32)[:, None])
            ring = ring + onehot[:, :, None] * fr[None, :, :]

        # Watermark: generations every lane has fully passed.
        low = jnp.where(st.ray.alive, st.gen - 1, st.gen)
        watermark = jnp.min(low)

        # Flush at most one completed generation per iteration (retirement
        # rate is ~B/E[depth] items/iter, far below one generation/iter).
        with jax.named_scope("wf_flush"):
            do_flush = g_flush <= watermark
            gsafe = jnp.where(do_flush, g_flush, 0)
            row = ring[gsafe % K]
            out = jax.lax.cond(
                do_flush,
                lambda o: jax.lax.dynamic_update_slice(o, row, (gsafe * B, vzero)),
                lambda o: o,
                out,
            )
            # Clear the flushed slot with a single-slot write (rewrites the same
            # row when not flushing) — a full-ring masked select here would read
            # and write all K*B*3 ring floats every iteration.
            cleared = jnp.where(do_flush, 0.0, row)[None]
            ring = jax.lax.dynamic_update_slice(ring, cleared, (gsafe % K, vzero, vzero))
            g_flush = g_flush + do_flush.astype(jnp.int32)

        return st, ring, out, g_flush, nseg, iters, hist

    iters0 = nseg0 * 0  # same varying-zero provenance, own named initializer
    _, _, out, _, nseg, iters, hist = jax.lax.while_loop(
        cond, body, (state0, ring0, out0, g_flush0, nseg0, iters0, hist0)
    )

    # Sequential sample-major reduction — the same association order as the
    # batch integrator's fori accumulation, so the two paths are BITWISE
    # identical (jnp.sum's tree order would differ by ~1 ulp).
    per_sample = out[: n_items].reshape(num_samples, n_cells, 3)
    sums = jax.lax.fori_loop(
        1, num_samples, lambda i, acc: acc + per_sample[i], per_sample[0]
    )
    if with_stats:
        stats = {"segments": nseg, "iters": iters, "lanes": B}
        if depth_hist:
            stats["depth_hist"] = hist
        return sums, stats
    return sums
