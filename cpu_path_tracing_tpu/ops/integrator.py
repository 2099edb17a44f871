"""Wavefront radiance integrator.

Replacement for the reference's per-ray iterative bounce loop
(``radiance``, ``src/main.cpp:104-158``): a whole batch of rays advances one
bounce per step of a ``lax.while_loop`` (fast forward path, early exit when
every lane is dead) or a fixed-trip ``lax.scan`` (reverse-mode differentiable
path).  Dead lanes are masked; their state is frozen so they cost no extra
memory traffic and cannot poison gradients.

Estimator semantics match the reference bounce-for-bounce:

* accumulates ``emission_0 + refl_0*emission_1 + refl_0*refl_1*emission_2 ...``
  (``src/main.cpp:99-103``);
* on miss: + throughput * sky gradient ``(1-t)*(1,1,1) + t*(.5,.7,1)``,
  ``t = 0.5*(unit_dir.y + 1)`` (``src/main.cpp:115-120``);
* Russian roulette after depth > rr_depth with survival prob
  ``p = max(albedo)`` *uncapped* — for the disco light p = 1.92 > 1, so RR
  never kills there and only damps by 1/p (``src/main.cpp:128-137``,
  SURVEY.md fidelity #1);
* material dispatch per ``src/main.cpp:141-154``.

Differentiability: discrete decisions (hit id, RR survival, reflect/refract
branch, material id) are piecewise-constant in the scene parameters, so
gradients flow through the *continuous* quantities only (t, normals, Fresnel
weights, throughput) — the standard detached/reparameterized estimator.
Visibility discontinuities are not edge-sampled; those derivatives are biased
(documented, SURVEY.md §7 hard-part 2).

Structure of the geometry gradient (be precise about what is nonzero): a
path's contribution is ``sum_k (prod_j albedo_j / p_j) * emission_k`` —
constants per path topology — plus the sky term on a miss, whose value
``(1-t)*bg0 + t*bg1`` varies continuously with the final direction.  Every
bounce direction is reparameterized through the hit normal, so sphere
position/radius gradients flow hit -> normal -> scattered direction -> ... ->
sky.  Consequently geometry gradients are exact-and-nonzero wherever some
sample paths escape to the background (e.g. the ``simple`` scene), and are
exactly zero in closed scenes (``box``/``box_mirror``), where the true
gradient is carried entirely by visibility edges the detached estimator
drops.  Emission/albedo/background/camera gradients are informative in every
scene.  Finite differences of the same estimator agree in all cases (the
BASELINE.json parity target), since FD sees the same piecewise structure.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from . import rng as rng_ops
from .intersect import _rsqrt_safe, intersect_scene, hit_record, sphere_props
from .materials import scatter


class RayState(NamedTuple):
    origin: jax.Array  # [B,3]
    direction: jax.Array  # [B,3]
    throughput: jax.Array  # [B,3] "accumulated_reflectance" (main.cpp:108)
    emission: jax.Array  # [B,3] "accumulated_emission" (main.cpp:107)
    alive: jax.Array  # [B] bool
    result: jax.Array  # [B,3] radiance of finished lanes


def init_state(origins, directions) -> RayState:
    # Initializers are derived from `origins` (not fresh constants) so that
    # under shard_map the whole carry is "varying" over the mesh axes — JAX
    # 0.9 rejects while_loop carries that mix varying and unvarying parts.
    zero = origins * 0.0
    return RayState(
        origin=origins,
        direction=directions,
        throughput=zero + 1.0,
        emission=zero,
        alive=zero[:, 0] == 0.0,
        result=zero,
    )


def bounce_step(scene: Scene, state: RayState, uniforms, depth, *, rr_depth, epsilon, inf,
                with_aux: bool = False) -> RayState:
    """Advance every live ray one bounce.  ``uniforms``: [B,4] (see ops/rng.py).

    Expression structure mirrors the fused GPU kernel chain-for-chain (see
    ops/intersect.py docstring: identical structure is what keeps the two
    bitwise equal in interpret mode and close on the card).

    ``with_aux`` additionally returns the per-lane bounce internals the
    replay backward needs (ops/replay.py): hit flags/ids, the pre-bounce
    throughput, this bounce's emission pickup, the sky value and lerp t on a
    miss, and the Russian-roulette decision — all values already computed
    here, so replay sees the IDENTICAL discrete decisions and prefixes.
    """
    o, d, thr, emit, alive, result = state
    dt = o.dtype
    u_rr, u_a, u_b = uniforms[:, 0], uniforms[:, 1], uniforms[:, 2]

    t, hid, hit = intersect_scene(scene, o, d, epsilon=epsilon, inf=inf)

    # ---- miss: scene background gradient (src/main.cpp:115-120) ----
    # |d|^2 as the kernel's a_quad chain; sky from dy * rsqrt(a_quad).
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    a_quad = dx * dx + dy * dy + dz * dz
    dinv = _rsqrt_safe(a_quad)
    # Fusion-invariant form: see the fused kernel's sky block.
    sky_t = (dy * dinv) * 0.5 + 0.5
    bg = scene.background.astype(dt)
    # Lerp form (one product): the two-product (1-t)*bg0 + t*bg1 blend has
    # an ambiguous fma grouping that two compilers may resolve differently —
    # see the fused kernel's sky block.
    sky = bg[0] + sky_t[:, None] * (bg[1] - bg[0])
    die_miss = alive & ~hit
    result = jnp.where(die_miss[:, None], emit + thr * sky, result)

    # ---- hit record (grad-safe t for miss lanes; one-hot matmul gather) ----
    t_safe = jnp.where(hit, t, 1.0)
    props = sphere_props(scene, hid)
    hp, n_out, normal, front = hit_record(scene, o, d, t_safe, hid, props)
    em_h = props.emission  # [B,3]
    al_h = props.albedo  # [B,3]

    emit_new = emit + thr * em_h  # src/main.cpp:126 (before RR)

    # ---- Russian roulette (src/main.cpp:128-137) ----
    p = jnp.max(al_h, axis=-1)  # uncapped by design (fidelity #1)
    p_inv = 1.0 / jnp.where(p > 0, p, 1.0)
    do_rr = depth > rr_depth
    survive = u_rr < p
    killed = do_rr & ~survive
    die_rr = alive & hit & killed
    result = jnp.where(die_rr[:, None], emit_new, result)

    # throughput = (thr * albedo) * colf, colf = 1/p on a surviving roulette
    # round, else 1 — the kernel's exact product order.
    colf = jnp.where(do_rr & survive, p_inv, jnp.ones_like(p_inv))
    thr_new = thr * al_h * colf[:, None]  # src/main.cpp:139

    # ---- scatter (src/main.cpp:141-154) ----
    d_new = scatter(props.mat_mask, d, n_out, normal, front, u_a, u_b,
                    ior=scene.ior)

    cont = alive & hit & ~killed
    cm = cont[:, None]
    new_state = RayState(
        origin=jnp.where(cm, hp, o),
        direction=jnp.where(cm, d_new, d),
        throughput=jnp.where(cm, thr_new, thr),
        emission=jnp.where(alive[:, None] & hit[:, None], emit_new, emit),
        alive=cont,
        result=result,
    )
    if with_aux:
        aux = {
            "hit": hit, "hid": hid, "thr_pre": thr, "em_h": em_h,
            "sky": sky, "sky_t": sky_t, "die_miss": die_miss,
            "rr_scaled": do_rr & survive, "cont": cont, "was_alive": alive,
        }
        return new_state, aux
    return new_state


def radiance_compact(scene: Scene, origins, directions, keys, *, max_depth=100,
                     rr_depth=4, epsilon=1e-4, inf=1e20, schedule=None, remat=True,
                     ct=None):
    """Reverse-differentiable radiance with LIVE-LANE COMPACTION — the
    adaptive-depth backward.

    The fixed-trip ``loop='scan'`` estimator runs every lane for all
    ``max_depth`` bounces even though the live-lane count collapses
    geometrically under Russian roulette (box @ 131072 lanes: 64% live at
    depth 8, 6% at depth 24, 0.2% at depth 48 — counted by a pilot render).
    Here the depth range is split into *stages* with a static capacity
    ``schedule``: at each stage boundary, finished lanes retire their
    radiance and the surviving lanes are stream-compacted (cumsum positions
    + scatter, O(B) — no sort) into a smaller buffer for the remaining
    bounces.  All shapes stay static, so the whole thing jits and
    reverse-differentiates; per-lane math is untouched, so the primal equals
    the plain scan bitwise (up to +0/-0) and gradients match up to
    lane-summation order.

    Cost shaping: an XLA scatter or gather at this size is a costly
    operation of its own, so (a) the whole carry is packed into one
    float and one int matrix — TWO scatters per boundary regardless of field
    count; (b) in the gradient path (``ct`` given) retirement is contracted
    against the cotangent via a GATHER of ``ct`` rows (transpose-free: ct is
    constant) instead of scatter-adding an output image; (c) schedules worth
    using have <=3 boundaries (grad.tune_backward_schedule) — the survival
    tail is cheap once the first big drops are taken.

    Args:
      schedule: tuple of ``(n_steps, capacity_fraction)`` covering exactly
        ``max_depth`` steps; capacities are fractions of the input batch,
        nonincreasing.  Build with ``grad.tune_backward_schedule`` (pilot
        live-curve measurement + safety margin).  Capacities are rounded up
        to a multiple of 256 lanes.
      remat: wrap each stage in jax.checkpoint (stage-granular
        rematerialization — stores only stage-boundary states).
      ct: optional [B,3] cotangent weights.  When given, returns the SCALAR
        ``sum(out * ct)`` instead of ``out`` — the contraction the backward
        pass needs, computed without any scatter (see above).

    Returns:
      (out [B,3] or scalar, dropped int32) — ``dropped`` counts live lanes
      that exceeded a stage capacity and were truncated (depth-capped)
      there.  A correctly tuned schedule keeps it at 0; callers monitor it
      (``grad`` attaches a drop-check to production step functions) so the
      capacity is never a *silent* cap.
    """
    if schedule is None:
        schedule = ((max_depth, 1.0),)
    if sum(n for n, _ in schedule) != max_depth:
        raise ValueError(f"schedule {schedule} does not cover max_depth={max_depth}")
    B = origins.shape[0]
    dt = origins.dtype
    kw = dict(rr_depth=rr_depth, epsilon=epsilon, inf=inf)
    st = init_state(origins, directions)
    a0, a1 = keys
    orig = jnp.arange(B, dtype=jnp.int32)
    out = None if ct is not None else jnp.zeros((B, 3), dt)
    acc = jnp.zeros((), dt)  # contracted accumulator (ct mode)
    dropped = jnp.int32(0)

    def run_stage(st, a0, a1, d0, n_steps):
        def body(c, d):
            u = rng_ops.bounce_uniforms(a0, a1, d).astype(dt)
            return bounce_step(scene, c, u, d, **kw), None

        st, _ = jax.lax.scan(body, st, jnp.arange(d0, d0 + n_steps, dtype=jnp.int32))
        return st

    stage_fn = jax.checkpoint(run_stage, static_argnums=(3, 4)) if remat else run_stage

    def retire(st, orig, final: bool):
        """Contribution of lanes finishing now: dead lanes' result, plus (at
        depth exhaustion) live lanes' accumulated emission."""
        if final:
            vals = jnp.where(st.alive[:, None], st.emission, st.result)
        else:
            vals = jnp.where(st.alive[:, None], 0.0, st.result)
        if ct is not None:
            return jnp.sum(vals * ct[orig])
        return out.at[orig].add(vals)

    width = B
    d0 = 0
    for n_steps, frac in schedule:
        cap = min(width, -(-int(math.ceil(frac * B)) // 256) * 256)
        if cap < width:
            alive = st.alive
            live = jnp.cumsum(alive.astype(jnp.int32))
            dropped = dropped + jnp.maximum(live[-1] - cap, 0)
            # Retire finished lanes' radiance (alive lanes hold result==0
            # invariantly — bounce_step only writes result at death).
            if ct is not None:
                acc = acc + retire(st, orig, final=False)
            else:
                out = retire(st, orig, final=False)
            pos = jnp.where(alive, live - 1, cap)

            # ONE packed scatter for the float carry (+ occupancy indicator
            # column) and one for the int carry: boundary cost is two
            # scatters, not one per field.
            fpack = jnp.concatenate(
                [st.origin, st.direction, st.throughput, st.emission,
                 alive.astype(dt)[:, None], jnp.ones((width, 1), dt)], axis=1)
            ipack = jnp.stack([a0.astype(jnp.int32), a1.astype(jnp.int32), orig],
                              axis=1)
            fbuf = jnp.zeros((cap, fpack.shape[1]), dt).at[pos].set(fpack, mode="drop")
            ibuf = jnp.zeros((cap, 3), jnp.int32).at[pos].set(ipack, mode="drop")
            # Padding slots (beyond the live count, occ column 0) carry a
            # benign unit direction so masked-out math cannot generate NaNs
            # that would poison where-gradients.
            occ = fbuf[:, 13] > 0
            dirc = jnp.where(occ[:, None], fbuf[:, 3:6],
                             jnp.asarray([0.0, 0.0, 1.0], dt))
            st = RayState(
                origin=fbuf[:, 0:3],
                direction=dirc,
                throughput=fbuf[:, 6:9],
                emission=fbuf[:, 9:12],
                alive=fbuf[:, 12] > 0,
                result=jnp.zeros((cap, 3), dt),
            )
            a0 = ibuf[:, 0].astype(jnp.uint32)
            a1 = ibuf[:, 1].astype(jnp.uint32)
            orig = ibuf[:, 2]
            width = cap
        st = stage_fn(st, a0, a1, d0, n_steps)
        d0 += n_steps

    if ct is not None:
        return acc + retire(st, orig, final=True), dropped
    return retire(st, orig, final=True), dropped


def radiance(scene: Scene, origins, directions, keys, *, max_depth=100, rr_depth=4,
             epsilon=1e-4, inf=1e20, loop="while", with_stats=False, remat=False):
    """Estimate radiance for a ray batch.

    Args:
      keys: ([B],[B]) uint32 per-sample threefry key pair (ops/rng.py layout).
      loop: 'while' (early-exit; forward only) or 'scan' (differentiable).
      with_stats: also return {'segments': total rays traced (sum over
        bounces of live lanes), 'depth': iterations executed} — the
        observability counters of SURVEY.md §5.5.
      remat: wrap each scan step in jax.checkpoint so reverse-mode AD stores
        only the per-bounce RayState carry and recomputes intersection/shading
        intermediates (see RenderConfig.remat).  Ignored for loop='while'.
    Returns: [B,3] radiance (and the stats dict if requested).
    """
    state0 = init_state(origins, directions)
    kw = dict(rr_depth=rr_depth, epsilon=epsilon, inf=inf)

    if loop == "while":
        def cond(carry):
            depth, st, _ = carry
            return (depth < max_depth) & jnp.any(st.alive)

        def body(carry):
            depth, st, nseg = carry
            u = rng_ops.bounce_uniforms(keys[0], keys[1], depth).astype(origins.dtype)
            nseg = nseg + jnp.sum(st.alive, dtype=jnp.int32)
            return depth + 1, bounce_step(scene, st, u, depth, **kw), nseg

        nseg0 = jnp.sum(state0.alive, dtype=jnp.int32) * 0  # varying zero
        depth, state, nseg = jax.lax.while_loop(cond, body, (jnp.int32(0), state0, nseg0))
    elif loop == "scan":
        def body(st, depth):
            u = rng_ops.bounce_uniforms(keys[0], keys[1], depth).astype(origins.dtype)
            return bounce_step(scene, st, u, depth, **kw), jnp.sum(st.alive, dtype=jnp.int32)

        if remat:
            body = jax.checkpoint(body)
        state, counts = jax.lax.scan(body, state0, jnp.arange(max_depth, dtype=jnp.int32))
        nseg = jnp.sum(counts)
        depth = jnp.int32(max_depth)
    else:
        raise ValueError(f"unknown loop mode {loop!r}")

    # Depth-limit exhaustion returns accumulated emission (src/main.cpp:157).
    out = jnp.where(state.alive[:, None], state.emission, state.result)
    if with_stats:
        stats = {"segments": nseg, "depth": depth}
        if loop == "scan":
            # Live-lane count at each bounce depth — the survival curve
            # (SURVEY.md §5.5 bounce-depth observability), free from the scan.
            stats["live_per_depth"] = counts
        return out, stats
    return out
