"""Persistent wavefront integrator vs the batch integrator (ops/wavefront.py).

The wavefront path must be a drop-in: identical threefry draws, identical
estimator.  Comparisons against the batch integrator allow ~1-ulp noise —
different XLA program shapes may fuse multiply-adds differently — while
same-program determinism is tested bitwise in test_render.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.ops.wavefront import render_wavefront
from cpu_path_tracing_tpu.render import render_cells_range

W, H = 24, 16
SCENES = ["simple", "box", "box_mirror", "smallpt"]


def _cells(cfg):
    return jnp.arange(cfg.num_cells, dtype=jnp.int32)


def _batch(scene, cfg, spp):
    return np.asarray(
        render_cells_range(scene, cfg.replace(integrator="batch"), _cells(cfg), 0, spp)
    )


@pytest.mark.parametrize("name", SCENES)
def test_matches_batch(name):
    cfg = pt.RenderConfig(width=W, height=H, spp=3, max_depth=24, wavefront_lanes=501)
    scene = pt.get_scene(name, W, H)
    w = np.asarray(render_wavefront(scene, cfg, _cells(cfg), 0, 3))
    np.testing.assert_allclose(w, _batch(scene, cfg, 3), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("lanes", [1, 7, 100, 10**9])
def test_lane_count_invariance(lanes):
    cfg = pt.RenderConfig(width=8, height=6, spp=2, max_depth=16, wavefront_lanes=lanes)
    scene = pt.get_scene("box", 8, 6)
    w = np.asarray(render_wavefront(scene, cfg, _cells(cfg), 0, 2))
    np.testing.assert_allclose(w, _batch(scene, cfg, 2), atol=1e-6, rtol=1e-6)


@pytest.mark.slow
def test_ring_depth_invariance():
    cfg = pt.RenderConfig(width=8, height=6, spp=4, max_depth=32, wavefront_lanes=64)
    scene = pt.get_scene("box_mirror", 8, 6)
    ref = _batch(scene, cfg, 4)
    for K in (1, 2, 8):
        w = np.asarray(render_wavefront(scene, cfg, _cells(cfg), 0, 4, ring_depth=K))
        np.testing.assert_allclose(w, ref, atol=1e-6, rtol=1e-6)


def test_sample_range_split():
    cfg = pt.RenderConfig(width=8, height=6, spp=4, max_depth=16, wavefront_lanes=64)
    scene = pt.get_scene("box", 8, 6)
    full = np.asarray(render_wavefront(scene, cfg, _cells(cfg), 0, 4))
    a = np.asarray(render_wavefront(scene, cfg, _cells(cfg), 0, 2))
    b = np.asarray(render_wavefront(scene, cfg, _cells(cfg), 2, 2))
    np.testing.assert_allclose(a + b, full, atol=1e-6)


@pytest.mark.slow
def test_stats_segments_match_batch():
    from cpu_path_tracing_tpu.ops.integrator import radiance
    from cpu_path_tracing_tpu.ops import rng as rng_ops
    from cpu_path_tracing_tpu.render import camera_rays

    cfg = pt.RenderConfig(width=8, height=6, spp=1, max_depth=32)
    scene = pt.get_scene("box", 8, 6)
    ids = _cells(cfg)
    _, stats_w = render_wavefront(scene, cfg, ids, 0, 1, with_stats=True)
    keys, o, d = camera_rays(scene, cfg, ids, 0, rng_ops.master_key(cfg.seed), scene.p0.dtype)
    _, stats_b = radiance(scene, o, d, keys, max_depth=cfg.max_depth, with_stats=True)
    assert int(stats_w["segments"]) == int(stats_b["segments"])


def test_noncontiguous_cells_rejected():
    """Wavefront paths raise on a non-contiguous concrete id set (the silent
    wrong-pixels hazard of the cell_ids[0]+offset regeneration contract)."""
    cfg = pt.RenderConfig(width=W, height=H, spp=1, max_depth=4)
    scene = pt.get_scene("simple", W, H)
    bad = jnp.asarray([0, 2, 4, 6], dtype=jnp.int32)
    with pytest.raises(ValueError, match="contiguous"):
        render_wavefront(scene, cfg, bad, 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        render_cells_range(scene, cfg.replace(integrator="wavefront"), bad, 0, 1)
    # The batch integrator accepts arbitrary id sets.
    out = render_cells_range(scene, cfg.replace(integrator="batch"), bad, 0, 1)
    assert out.shape == (4, 3)


def test_observability_stats():
    """Occupancy counters and the retirement depth histogram (SURVEY.md
    §5.1/§5.5): segments == histogram mass weighted by depth, histogram mass
    == item count, occupancy in (0, 1]."""
    cfg = pt.RenderConfig(width=12, height=8, spp=2, max_depth=24)
    scene = pt.get_scene("box", cfg.width, cfg.height)
    out, stats = render_wavefront(scene, cfg, _cells(cfg), 0, 2, with_stats=True,
                                  depth_hist=True, lanes=256)
    segments = int(stats["segments"])
    iters = int(stats["iters"])
    lanes = int(stats["lanes"])
    hist = np.asarray(stats["depth_hist"])
    n_items = cfg.num_cells * 2
    assert hist.sum() == n_items
    # Each item retired at depth d contributed exactly d segments.
    assert (hist * np.arange(1, cfg.max_depth + 1)).sum() == segments
    occ = segments / (iters * lanes)
    assert 0.0 < occ <= 1.0


@pytest.mark.slow
def test_deep_ring_and_config_ring():
    """Deep rings (stall-headroom for short-path scenes, config.py
    wavefront_ring) keep exact parity on the XLA wavefront."""
    cfg = pt.RenderConfig(width=8, height=6, spp=4, max_depth=32, wavefront_lanes=64)
    scene = pt.get_scene("simple", 8, 6)
    ref = _batch(scene, cfg, 4)
    for K in (16, 64):
        w = np.asarray(render_wavefront(scene, cfg, _cells(cfg), 0, 4, ring_depth=K))
        np.testing.assert_allclose(w, ref, atol=1e-6, rtol=1e-6)
    # via config instead of kwarg
    cfg_k = cfg.replace(wavefront_ring=32)
    w = np.asarray(render_wavefront(scene, cfg_k, _cells(cfg), 0, 4))
    np.testing.assert_allclose(w, ref, atol=1e-6, rtol=1e-6)
