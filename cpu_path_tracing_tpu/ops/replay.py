"""Replay backward: analytic parameter gradients in ONE forward-speed pass.

The production inverse-rendering fields (albedo, emission, background — the
BASELINE.json box inverse config) enter the path-tracing estimator
MULTILINEARLY: with detached discrete decisions a path's radiance is

    L = sum_k (prod_{j<k} f_j) * e_k  [+ (prod f_j) * sky on a miss],
    f_j = albedo[h_j] * colf_j,   colf_j = 1/p_j on a surviving roulette.

Reverse-mode AD of the bounce scan pays the full tape machinery (remat
recompute + transpose, at fixed trip count) to differentiate what is
analytically a log-derivative sum: since every bounce-k contribution
c_k = thr_k * e_k depends only on its PREFIX,

    dL/d a[m,c']  = sum_k c_k[c] * ( cnt_k[m] * delta_cc' / a[m,c]
                                     - rr_k[m] * tiemask[m,c'] / p_m ),
    dL/d e[m,c]   = sum_k [h_k = m] thr_k[c],
    dL/d bg       = thr_miss * (1-t, t),

where cnt_k[m] / rr_k[m] count (rouletted) prefix hits on sphere m and
tiemask[m] reproduces jax's even tie-split for p = max_c albedo[m,c].  All
of it accumulates FORWARD: two per-lane [B,N] counters plus per-bounce
[N,B]x[B,3] one-hot contractions — no tape, no transpose, no fixed trip
count (an early-exit while loop).  The replay runs the IDENTICAL bounce
math (ops/integrator.bounce_step with_aux), so decisions and prefixes match
the primal bitwise and the gradients equal the scan VJP up to fp
reassociation (tests/test_replay.py pins this against jax.grad in f64).

Every contraction carries ``precision=HIGHEST``: a float32 einsum may run in
TF32 on the GPU (a 10-bit mantissa), which would round each cotangent and
accumulated gradient term.

Scope/limitations (documented, enforced by grad.py's field gate):

* fields: albedo / emission / background only.  Geometry and camera
  gradients flow through the reparameterized direction chain, which needs
  reverse mode — those fall back to the rematerialized scan VJP.
* EXACT zero albedo channels: the log-derivative form loses the
  single-prefix-hit gradient of an exactly-zero albedo channel (AD gives
  the albedo-excluded product; the guarded division gives 0).  Any real
  optimization run starts from perturbed (a.s. nonzero) albedos; the
  dedicated test documents the deviation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.lax import Precision

from ..config import RenderConfig
from ..models.scene import Scene
from . import rng as rng_ops
from .integrator import bounce_step, init_state


def _einsum(spec, *operands):
    return jnp.einsum(spec, *operands, precision=Precision.HIGHEST)


def replay_param_grads(scene: Scene, cfg: RenderConfig, cell_ids,
                       sample_start, num_samples: int, ct):
    """Gradients of ``sum(ct * render_cells_range(scene, cfg, cell_ids,
    sample_start, num_samples))`` w.r.t. albedo/emission/background.

    Args:
      ct: [B,3] per-cell cotangent (B == len(cell_ids)).
    Returns:
      {'albedo': [N,3], 'emission': [N,3], 'background': [2,3]} in
      ``scene.p0.dtype``.
    """
    from ..render import camera_rays

    dt = scene.p0.dtype
    N = scene.num_spheres
    B = cell_ids.shape[0]
    root_key = rng_ops.master_key(cfg.seed)
    kw = dict(rr_depth=cfg.rr_depth, epsilon=cfg.epsilon, inf=cfg.inf)
    ctd = ct.astype(dt)

    albedo = scene.albedo.astype(dt)  # [N,3]
    p = jnp.max(albedo, axis=-1)  # [N]
    ties = jnp.sum(albedo == p[:, None], axis=-1).astype(dt)
    tiemask = (albedo == p[:, None]).astype(dt) / ties[:, None]  # [N,3]
    inv_albedo = jnp.where(albedo > 0, 1.0 / jnp.where(albedo > 0, albedo, 1.0), 0.0)
    inv_p = jnp.where(p > 0, 1.0 / jnp.where(p > 0, p, 1.0), 0.0)
    sphere_ids = jnp.arange(N, dtype=jnp.int32)

    def one_sample(sample_idx, grads):
        ga, ge, gbg = grads
        keys, o, d = camera_rays(scene, cfg, cell_ids, sample_idx, root_key, dt)
        st0 = init_state(o, d)
        cnt0 = jnp.zeros((B, N), dt)

        def cond(carry):
            depth, st, *_ = carry
            return (depth < cfg.max_depth) & jnp.any(st.alive)

        def body(carry):
            depth, st, cnt, cnt_rr, ga, ge, gbg = carry
            u = rng_ops.bounce_uniforms(keys[0], keys[1], depth).astype(dt)
            st2, aux = bounce_step(scene, st, u, depth, with_aux=True, **kw)

            onehot = ((aux["hid"][:, None] == sphere_ids[None, :])
                      & aux["was_alive"][:, None] & aux["hit"][:, None]).astype(dt)
            thr_ct = ctd * aux["thr_pre"]  # [B,3]

            # emission: dL/de[m,c] = sum over hits of thr_pre
            ge = ge + _einsum("ln,lc->nc", onehot, thr_ct)

            # this bounce's contributions, ct-weighted (hit emission pickup
            # + sky on a miss — disjoint events)
            q = (thr_ct * aux["em_h"]) * onehot.sum(-1, keepdims=True)
            q = q + jnp.where(aux["die_miss"][:, None], thr_ct * aux["sky"], 0.0)

            # albedo prefix terms via the two counters
            ga = ga + _einsum("ln,lc->nc", cnt, q) * inv_albedo
            s = jnp.sum(q, axis=-1)  # [B]
            rr_w = _einsum("ln,l->n", cnt_rr, s)  # [N]
            ga = ga - (rr_w * inv_p)[:, None] * tiemask

            # background: sky = bg0 + t*(bg1-bg0)
            mt = jnp.where(aux["die_miss"], aux["sky_t"], 0.0)
            m1 = jnp.where(aux["die_miss"], 1.0 - aux["sky_t"], 0.0)
            gbg = gbg.at[0].add(_einsum("l,lc->c", m1, thr_ct))
            gbg = gbg.at[1].add(_einsum("l,lc->c", mt, thr_ct))

            # counters AFTER accumulation: f_k multiplies continuing lanes
            inc = onehot * aux["cont"][:, None].astype(dt)
            cnt = cnt + inc
            cnt_rr = cnt_rr + inc * aux["rr_scaled"][:, None].astype(dt)
            return depth + 1, st2, cnt, cnt_rr, ga, ge, gbg

        _, _, _, _, ga, ge, gbg = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), st0, cnt0, cnt0, ga, ge, gbg))
        return ga, ge, gbg

    ga0 = jnp.zeros((N, 3), dt)
    gbg0 = jnp.zeros((2, 3), dt)
    ga, ge, gbg = jax.lax.fori_loop(
        0, num_samples,
        lambda i, g: one_sample(sample_start + i, g),
        (ga0, ga0, gbg0))
    return {"albedo": ga, "emission": ge, "background": gbg}


def replay_param_grads_wavefront(scene: Scene, cfg: RenderConfig, cell_ids,
                                 sample_start, num_samples: int, ct, *,
                                 lanes: int | None = None,
                                 ring_depth: int | None = None,
                                 with_stats: bool = False):
    """Wavefront form of :func:`replay_param_grads` — the production
    backward (grad.make_diff_render_span).

    The batch replay pays the XLA loop's fixed per-iteration cost for
    max-live-depth iterations PER SAMPLE (a few lanes of box survive to
    depth ~99).  Here dead lanes REGENERATE onto fresh items exactly like
    the forward wavefront (ops/wavefront.py), so the whole (cells x samples)
    item range retires in ~segments/(lanes x occupancy) iterations.

    Per-lane cotangents without a per-iteration gather: the cotangent table
    rides a K-slot RING of contiguous generation slabs
    (ct_items[g*B:(g+1)*B] — one dynamic_slice per flush, like the forward's
    result ring in reverse): a regenerating lane picks its row from the ring by a K-way
    one-hot select, and the ring admits generation g_flush+K when the
    watermark advances.  The wavefront invariant g in [g_flush, g_flush+K)
    guarantees the slab is resident.

    Gradient semantics are identical to the batch replay (same analytic
    accumulators, same bounce math); only the lane scheduling — hence fp
    summation order — differs.
    """
    from ..render import camera_rays_for_cells, check_contiguous_cells

    check_contiguous_cells(cell_ids)
    dt = scene.p0.dtype
    N = scene.num_spheres
    n_cells = cell_ids.shape[0]
    n_items = n_cells * num_samples
    B = int(min(lanes or cfg.wavefront_lanes, n_items))
    K = ring_depth or cfg.wavefront_ring or 8
    n_gens = -(-n_items // B)
    seed_pair = rng_ops.master_key(cfg.seed)
    kw = dict(rr_depth=cfg.rr_depth, epsilon=cfg.epsilon, inf=cfg.inf)

    albedo = scene.albedo.astype(dt)
    p = jnp.max(albedo, axis=-1)
    ties = jnp.sum(albedo == p[:, None], axis=-1).astype(dt)
    tiemask = (albedo == p[:, None]).astype(dt) / ties[:, None]
    inv_albedo = jnp.where(albedo > 0, 1.0 / jnp.where(albedo > 0, albedo, 1.0), 0.0)
    inv_p = jnp.where(p > 0, 1.0 / jnp.where(p > 0, p, 1.0), 0.0)
    sphere_ids = jnp.arange(N, dtype=jnp.int32)
    ring_ids = jnp.arange(K, dtype=jnp.int32)

    # Per-item cotangent table, padded to whole generations.
    ctd = ct.astype(dt)
    ct_items = jnp.concatenate(
        [jnp.tile(ctd, (num_samples, 1)),
         jnp.zeros((n_gens * B - n_items, 3), dt)], axis=0)

    vzero = (cell_ids[0] * 0).astype(jnp.int32)
    lane_izero = jnp.zeros((B,), jnp.int32) + vzero
    lane_fzero3 = jnp.zeros((B, 3), dt) + vzero.astype(dt)
    from .wavefront import LaneState

    state0 = LaneState(
        ray=init_state(lane_fzero3, lane_fzero3 + 1.0)._replace(
            alive=lane_izero == 1, throughput=lane_fzero3),
        depth=lane_izero,
        gen=lane_izero - 1,
        k0=lane_izero.astype(jnp.uint32),
        k1=lane_izero.astype(jnp.uint32),
    )
    # ct ring preloaded with generations 0..K-1 (static slices).
    ring0 = jnp.stack([
        jax.lax.dynamic_slice(ct_items, (min(g, n_gens - 1) * B, 0), (B, 3))
        for g in range(K)], axis=0)
    cnt0 = jnp.zeros((B, N), dt) + vzero.astype(dt)
    lane_iota = jnp.arange(B, dtype=jnp.int32)

    def regenerate(st, ct_lane, cnt, cnt_rr, ct_ring, g_flush):
        want_g = st.gen + 1
        can_start = (~st.ray.alive) & (want_g < n_gens) & (want_g < g_flush + K)
        item = want_g * B + lane_iota
        real = can_start & (item < n_items)

        c_idx = item % n_cells
        s_idx = (sample_start + item // n_cells).astype(jnp.uint32)
        cells_g = jnp.minimum(cell_ids[0] + c_idx, cfg.width * cfg.height
                              * cfg.num_subpixels * cfg.num_subpixels - 1)
        a0, a1 = rng_ops.item_keys(seed_pair, cells_g, s_idx)
        u = rng_ops.camera_uniforms(a0, a1).astype(dt)
        o_n, d_n = camera_rays_for_cells(scene, cfg, cells_g, u, dt)

        # K-way one-hot select of the lane's generation slab (no gather).
        slot_oh = (want_g[:, None] % K == ring_ids[None, :]).astype(dt)
        ct_sel = _einsum("bk,kbc->bc", slot_oh, ct_ring)

        tm = real[:, None]
        ray = st.ray._replace(
            origin=jnp.where(tm, o_n, st.ray.origin),
            direction=jnp.where(tm, d_n, st.ray.direction),
            throughput=jnp.where(tm, 1.0, st.ray.throughput),
            emission=jnp.where(tm, 0.0, st.ray.emission),
            alive=st.ray.alive | real,
            result=jnp.where(tm, 0.0, st.ray.result),
        )
        st = LaneState(
            ray=ray,
            depth=jnp.where(real, 0, st.depth),
            gen=jnp.where(can_start, want_g, st.gen),
            k0=jnp.where(real, a0, st.k0),
            k1=jnp.where(real, a1, st.k1),
        )
        ct_lane = jnp.where(tm, ct_sel, ct_lane)
        cnt = jnp.where(tm, 0.0, cnt)
        cnt_rr = jnp.where(tm, 0.0, cnt_rr)
        return st, ct_lane, cnt, cnt_rr

    def cond(carry):
        return carry[0] < n_gens

    def body(carry):
        (g_flush, st, ct_lane, cnt, cnt_rr, ct_ring, ga, ge, gbg,
         nseg, iters) = carry
        st, ct_lane, cnt, cnt_rr = regenerate(
            st, ct_lane, cnt, cnt_rr, ct_ring, g_flush)
        nseg = nseg + jnp.sum(st.ray.alive, dtype=jnp.int32)
        iters = iters + 1

        u = rng_ops.bounce_uniforms(st.k0, st.k1, st.depth).astype(dt)
        ray, aux = bounce_step(scene, st.ray, u, st.depth, with_aux=True, **kw)

        # ---- analytic accumulation (see replay_param_grads) --------------
        onehot = ((aux["hid"][:, None] == sphere_ids[None, :])
                  & aux["was_alive"][:, None] & aux["hit"][:, None]).astype(dt)
        thr_ct = ct_lane * aux["thr_pre"]
        ge = ge + _einsum("ln,lc->nc", onehot, thr_ct)
        q = (thr_ct * aux["em_h"]) * onehot.sum(-1, keepdims=True)
        q = q + jnp.where(aux["die_miss"][:, None], thr_ct * aux["sky"], 0.0)
        ga = ga + _einsum("ln,lc->nc", cnt, q) * inv_albedo
        rr_w = _einsum("ln,l->n", cnt_rr, jnp.sum(q, axis=-1))
        ga = ga - (rr_w * inv_p)[:, None] * tiemask
        mt = jnp.where(aux["die_miss"], aux["sky_t"], 0.0)
        m1 = jnp.where(aux["die_miss"], 1.0 - aux["sky_t"], 0.0)
        gbg = gbg.at[0].add(_einsum("l,lc->c", m1, thr_ct))
        gbg = gbg.at[1].add(_einsum("l,lc->c", mt, thr_ct))
        inc = onehot * aux["cont"][:, None].astype(dt)
        cnt = cnt + inc
        cnt_rr = cnt_rr + inc * aux["rr_scaled"][:, None].astype(dt)

        # ---- depth exhaustion + lane state ------------------------------
        depth = jnp.where(aux["was_alive"], st.depth + 1, st.depth)
        exhausted = ray.alive & (depth >= cfg.max_depth)
        ray = ray._replace(alive=ray.alive & ~exhausted)
        st = LaneState(ray, depth, st.gen, st.k0, st.k1)

        # ---- watermark + ct-ring admission ------------------------------
        low = jnp.where(st.ray.alive, st.gen - 1, st.gen)
        watermark = jnp.min(low)
        do_flush = g_flush <= watermark
        top = g_flush + K  # generation becoming accessible after the advance
        top_safe = jnp.minimum(top, n_gens - 1)
        slab = jax.lax.dynamic_slice(ct_items, (top_safe * B, vzero), (B, 3))
        ct_ring = jax.lax.cond(
            do_flush,
            lambda r: jax.lax.dynamic_update_slice(
                r, slab[None], (top_safe % K, vzero, vzero)),
            lambda r: r,
            ct_ring,
        )
        g_flush = g_flush + do_flush.astype(jnp.int32)
        return (g_flush, st, ct_lane, cnt, cnt_rr, ct_ring, ga, ge, gbg,
                nseg, iters)

    ga0 = jnp.zeros((N, 3), dt) + vzero.astype(dt)
    gbg0 = jnp.zeros((2, 3), dt) + vzero.astype(dt)
    carry = (vzero, state0, lane_fzero3, cnt0, cnt0, ring0, ga0, ga0 * 0, gbg0,
             vzero, vzero)
    out = jax.lax.while_loop(cond, body, carry)
    ga, ge, gbg, nseg, iters = out[6], out[7], out[8], out[9], out[10]
    grads = {"albedo": ga, "emission": ge, "background": gbg}
    if with_stats:
        return grads, {"segments": nseg, "iters": iters, "lanes": B}
    return grads
