"""Replay backward (ops/replay.py) vs reverse-mode AD.

The analytic forward-replay gradient must equal jax.grad of the scan
integrator to fp-reassociation precision for its covered fields
(albedo/emission/background) — including the RR log-derivative term, jax's
even tie-split of max(albedo), sky-miss background terms, and depth
exhaustion.  f64 end-to-end so 'equal' means ~1e-12 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.grad import (
    make_diff_render, merge_params, split_params)
from cpu_path_tracing_tpu.ops.replay import replay_param_grads
from cpu_path_tracing_tpu.render import render_cells_range

FIELDS = ("albedo", "emission", "background")


def _perturbed(name, cfg, seed=0):
    """Scene with strictly-positive albedos (the replay contract's domain)."""
    scene = pt.get_scene(name, cfg.width, cfg.height, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    return merge_params(scene, {
        "albedo": jnp.abs(scene.albedo
                          + rng.normal(0, 0.03, scene.albedo.shape)) + 1e-3,
        "emission": jnp.abs(scene.emission
                            + rng.normal(0, 0.03, scene.emission.shape)),
    })


@pytest.mark.parametrize("name", ["box", "simple"])
def test_replay_matches_autodiff(name):
    # max_depth 14: well past rr_depth (4) so the roulette log-derivative
    # term is exercised; the AD scan compile scales with depth.
    cfg = pt.RenderConfig(width=10, height=8, spp=2, max_depth=14,
                          loop="scan", integrator="batch")
    scene = _perturbed(name, cfg)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    rng = np.random.default_rng(1)
    ct = jnp.asarray(rng.normal(0, 1, (cfg.num_cells, 3)))
    params = split_params(scene, FIELDS)

    def loss(p):
        sc = merge_params(scene, p)
        return jnp.sum(render_cells_range(sc, cfg, ids, 0, cfg.spp) * ct)

    g_ad = jax.grad(loss)(params)
    g_rp = replay_param_grads(scene, cfg, ids, 0, cfg.spp, ct)
    for k in FIELDS:
        a, b = np.asarray(g_ad[k]), np.asarray(g_rp[k])
        np.testing.assert_allclose(b, a, rtol=1e-10,
                                   atol=1e-10 * (np.abs(a).max() + 1),
                                   err_msg=f"{name}/{k}")


@pytest.mark.slow
def test_replay_through_make_diff_render():
    """End-to-end: make_diff_render with replay-eligible fields must produce
    the same gradient as with replay disabled (scan VJP)."""
    cfg = pt.RenderConfig(width=8, height=6, spp=4, max_depth=16)
    scene = _perturbed("box", cfg)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    params = split_params(scene, ("albedo", "emission"))
    target = 0.3 * jnp.ones((cfg.num_cells, 3), jnp.float64)

    def loss_with(replay):
        rm = make_diff_render(scene, cfg, sample_chunk=2, replay=replay)
        return jax.grad(lambda p: jnp.mean((rm(p, ids) - target) ** 2))(params)

    g_rp = loss_with(True)
    g_ad = loss_with(False)
    for k in params:
        np.testing.assert_allclose(
            np.asarray(g_rp[k]), np.asarray(g_ad[k]), rtol=1e-9, atol=1e-12,
            err_msg=k)


def test_replay_zero_albedo_documented_deviation():
    """The log-derivative form zeroes the gradient of an EXACTLY-zero albedo
    channel (AD gives the albedo-excluded product) — the documented domain
    limit of ops/replay.py.  This test pins the behavior so a future 'fix'
    or regression is a conscious choice: gradients must be finite (no NaN
    from the guarded division) and exact for all strictly-positive
    channels."""
    cfg = pt.RenderConfig(width=8, height=6, spp=1, max_depth=12,
                          loop="scan", integrator="batch")
    # the unperturbed box scene HAS a zero-albedo emissive light sphere
    scene = pt.get_scene("box", cfg.width, cfg.height, dtype=jnp.float64)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    ct = jnp.ones((cfg.num_cells, 3), jnp.float64)
    g = replay_param_grads(scene, cfg, ids, 0, 1, ct)
    assert np.isfinite(np.asarray(g["albedo"])).all()
    # exactly-zero channels get zero gradient (the documented deviation)
    zero_mask = np.asarray(scene.albedo) == 0.0
    assert np.all(np.asarray(g["albedo"])[zero_mask] == 0.0)


def _dot_precisions(jaxpr):
    """precision of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_precisions(sub))
    return out


@pytest.mark.parametrize("fn", ["replay_param_grads", "replay_param_grads_wavefront"])
def test_replay_contractions_run_at_highest_precision(fn):
    """A float32 contraction may run in TF32 on a GPU; every dot_general of
    the replay must ask for HIGHEST (the one-hot cotangent select included)."""
    from cpu_path_tracing_tpu.ops import replay

    cfg = pt.RenderConfig(width=4, height=4, spp=1, max_depth=4)
    scene = pt.get_scene("box", 4, 4, dtype=jnp.float32)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    ct = jnp.ones((cfg.num_cells, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda s, c: getattr(replay, fn)(s, cfg, ids, 0, 1, c))(scene, ct)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert precisions, "no contraction found"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), precisions
