"""Sharding tests on the 8-virtual-device CPU mesh (SURVEY.md §4e)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpu_path_tracing_tpu import RenderConfig, get_scene, render_image
from cpu_path_tracing_tpu.parallel.mesh import make_mesh
from cpu_path_tracing_tpu.parallel.render import render_image_sharded

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

KW = dict(width=32, height=24, spp=4, max_depth=16)


def _single(name):
    return np.asarray(render_image(get_scene(name, KW["width"], KW["height"]), RenderConfig(**KW)))


def test_mesh_shapes():
    m = make_mesh()
    assert m.shape == {"tiles": 8, "samples": 1}
    m2 = make_mesh(n_tiles=4, n_samples=2)
    assert m2.shape == {"tiles": 4, "samples": 2}
    with pytest.raises(ValueError):
        make_mesh(n_tiles=3, n_samples=3)


def test_tile_sharded_matches_single_device():
    """8-way cell sharding must be bit-identical to the single-device render
    (keys depend only on (seed, cell, sample))."""
    cfg = RenderConfig(**KW)
    scene = get_scene("box", cfg.width, cfg.height)
    img_s = np.asarray(render_image_sharded(scene, cfg, make_mesh(n_tiles=8)))
    np.testing.assert_array_equal(img_s, _single("box"))


def test_sample_sharded_matches_single_device():
    """4x2 tilesxsamples mesh: sample-axis psum reorders the f32 sum, so
    allow one-ulp-scale differences but nothing more."""
    cfg = RenderConfig(**KW)
    scene = get_scene("box", cfg.width, cfg.height)
    img_s = np.asarray(render_image_sharded(scene, cfg, make_mesh(n_tiles=4, n_samples=2)))
    np.testing.assert_allclose(img_s, _single("box"), atol=1e-6)


def test_mesh_shape_invariance():
    """2x4 and 8x1 meshes agree (determinism across mesh shapes)."""
    cfg = RenderConfig(**KW)
    scene = get_scene("box_mirror", cfg.width, cfg.height)
    a = np.asarray(render_image_sharded(scene, cfg, make_mesh(n_tiles=8, n_samples=1)))
    b = np.asarray(render_image_sharded(scene, cfg, make_mesh(n_tiles=2, n_samples=4)))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_spp_not_divisible_raises():
    cfg = RenderConfig(width=8, height=8, spp=3)
    scene = get_scene("box", 8, 8)
    with pytest.raises(ValueError):
        render_image_sharded(scene, cfg, make_mesh(n_tiles=4, n_samples=2))


@pytest.mark.slow
def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@pytest.mark.slow
def test_sharded_accum_train_step_matches_single_chip():
    """Production-scale mesh-parallel inverse step: the
    composition of the remat/sample-chunked backward with the tiles x samples
    mesh must reproduce the single-chip accumulation step — same loss, same
    params after one Adam update (f64 scene: psum reorder noise ~1e-15)."""
    import optax

    from cpu_path_tracing_tpu.grad import (
        make_accum_train_step,
        make_sharded_accum_train_step,
        render_target,
        split_params,
    )

    cfg = RenderConfig(width=10, height=8, spp=4, max_depth=8)
    scene = get_scene("box", cfg.width, cfg.height, dtype=jnp.float64)
    target = render_target(scene, cfg) * 0.9
    params0 = split_params(scene, ("albedo", "emission"))
    optimizer = optax.adam(1e-2)

    ref_step = make_accum_train_step(scene, cfg, optimizer, cell_chunk=77, sample_chunk=2)
    p_ref, _, l_ref = ref_step(params0, optimizer.init(params0), target)

    for mesh, cc, sc_ in (
        (make_mesh(n_tiles=8, n_samples=1), None, None),
        (make_mesh(n_tiles=4, n_samples=2), 100, 1),
        (make_mesh(n_tiles=2, n_samples=4), 64, None),
    ):
        step = make_sharded_accum_train_step(mesh, scene, cfg, optimizer,
                                             cell_chunk=cc, sample_chunk=sc_)
        p, _, l = step(params0, optimizer.init(params0), target)
        assert abs(float(l) - float(l_ref)) < 1e-12, (dict(mesh.shape), float(l), float(l_ref))
        for k in p_ref:
            np.testing.assert_allclose(
                np.asarray(p[k]), np.asarray(p_ref[k]), rtol=1e-9, atol=1e-12,
                err_msg=f"mesh={dict(mesh.shape)} chunk=({cc},{sc_}) leaf={k}")


@pytest.mark.slow
def test_sharded_train_step_matches_single_device():
    """make_sharded_train_step must reproduce the single-device train_step
    exactly (not just up to Adam's scale invariance — the r2 version left
    grads n_tiles x too large via a redundant pmean on top of vma-AD's
    implicit psum)."""
    import optax

    from cpu_path_tracing_tpu.grad import (
        make_sharded_train_step,
        render_target,
        split_params,
        train_step,
    )

    cfg = RenderConfig(width=8, height=8, spp=4, max_depth=6, loop="scan")
    scene = get_scene("box", cfg.width, cfg.height, dtype=jnp.float64)
    target = render_target(scene, cfg) * 0.9
    params0 = split_params(scene, ("albedo", "p0"))
    optimizer = optax.adam(1e-2)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)

    p_ref, _, l_ref = train_step(params0, optimizer.init(params0), scene, cfg,
                                 optimizer, ids, target)

    for mesh in (make_mesh(n_tiles=8, n_samples=1), make_mesh(n_tiles=4, n_samples=2)):
        step = make_sharded_train_step(mesh, cfg, optimizer)
        p, _, l = step(params0, optimizer.init(params0), scene, ids, target)
        assert abs(float(l) - float(l_ref)) < 1e-12, (dict(mesh.shape), float(l), float(l_ref))
        for k in p_ref:
            np.testing.assert_allclose(
                np.asarray(p[k]), np.asarray(p_ref[k]), rtol=1e-9, atol=1e-12,
                err_msg=f"mesh={dict(mesh.shape)} leaf={k}")
