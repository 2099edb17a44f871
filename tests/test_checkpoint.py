"""Progressive checkpoint/resume (utils/checkpoint.py, SURVEY.md §5.4)."""

import os

import jax
import numpy as np
import pytest

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.utils.checkpoint import ProgressiveState, render_progressive

CFG = pt.RenderConfig(width=16, height=12, spp=4, max_depth=12)


def test_resume_is_bit_exact(tmp_path):
    scene = pt.get_scene("box", CFG.width, CFG.height)
    full = np.asarray(render_progressive(scene, CFG))

    ck = str(tmp_path / "ck.npz")
    render_progressive(scene, CFG.replace(spp=2), ck, flush_every=1)  # "interrupted"
    assert ProgressiveState.load(ck).spp_done == 2
    resumed = np.asarray(render_progressive(scene, CFG, ck, flush_every=1))
    assert ProgressiveState.load(ck).spp_done == 4
    np.testing.assert_array_equal(resumed, full)


def test_fingerprint_mismatch_rejected(tmp_path):
    scene = pt.get_scene("box", CFG.width, CFG.height)
    ck = str(tmp_path / "ck.npz")
    render_progressive(scene, CFG.replace(spp=1), ck, flush_every=1)
    other = pt.get_scene("simple", CFG.width, CFG.height)
    with pytest.raises(ValueError, match="different"):
        render_progressive(other, CFG, ck)
    with pytest.raises(ValueError, match="different"):
        render_progressive(scene, CFG.replace(seed=7), ck)


def test_progress_callback(tmp_path):
    scene = pt.get_scene("box", CFG.width, CFG.height)
    seen = []
    render_progressive(scene, CFG, progress=lambda d, t: seen.append((d, t)), flush_every=2)
    assert seen == [(2, 4), (4, 4)]


def test_checkpoint_file_is_atomic(tmp_path):
    scene = pt.get_scene("box", CFG.width, CFG.height)
    ck = str(tmp_path / "ck.npz")
    render_progressive(scene, CFG.replace(spp=2), ck, flush_every=1)
    assert os.path.exists(ck)
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(tmp_path))


@pytest.mark.slow
def test_invert_checkpoint_resume_is_exact(tmp_path):
    """Inverse-mode optimizer-state checkpoint (SURVEY.md §5.4): save at
    step k, reload, continue — params/opt state must be
    identical to the uninterrupted run."""
    import optax

    from cpu_path_tracing_tpu.grad import make_accum_train_step, render_target, split_params
    from cpu_path_tracing_tpu.utils.checkpoint import (
        InvertState,
        invert_fingerprint,
        load_or_init_invert,
    )

    cfg = pt.RenderConfig(width=10, height=8, spp=2, max_depth=6)
    scene = pt.get_scene("box", cfg.width, cfg.height)
    target = render_target(scene, cfg)
    params0 = jax.tree_util.tree_map(lambda x: x + 0.03, split_params(scene, ("albedo",)))
    optimizer = optax.adam(1e-2)
    step = make_accum_train_step(scene, cfg, optimizer, cell_chunk=200)
    fp = invert_fingerprint(scene, cfg, ("albedo",), 1e-2)
    ck = str(tmp_path / "inv.npz")

    # Uninterrupted: 4 steps.
    p, o = params0, optimizer.init(params0)
    for _ in range(4):
        p, o, _ = step(p, o, target)

    # Interrupted: 2 steps, save, "crash", reload, 2 more.
    p2, o2 = params0, optimizer.init(params0)
    for _ in range(2):
        p2, o2, _ = step(p2, o2, target)
    InvertState(p2, o2, 2, fp).save(ck)
    st = load_or_init_invert(ck, fp, params0, optimizer.init(params0))
    assert st.step == 2
    p3, o3 = st.params, st.opt_state
    for _ in range(2):
        p3, o3, _ = step(p3, o3, target)

    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(p3)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(o), jax.tree_util.tree_leaves(o3)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_invert_checkpoint_fingerprint_mismatch(tmp_path):
    import optax

    from cpu_path_tracing_tpu.grad import split_params
    from cpu_path_tracing_tpu.utils.checkpoint import (
        InvertState,
        invert_fingerprint,
        load_or_init_invert,
    )

    cfg = pt.RenderConfig(width=10, height=8, spp=2, max_depth=6)
    scene = pt.get_scene("box", cfg.width, cfg.height)
    params = split_params(scene, ("albedo",))
    opt = optax.adam(1e-2).init(params)
    fp = invert_fingerprint(scene, cfg, ("albedo",), 1e-2)
    ck = str(tmp_path / "inv.npz")
    InvertState(params, opt, 3, fp).save(ck)

    other = invert_fingerprint(scene, cfg, ("albedo",), 5e-3)  # different lr
    with pytest.raises(ValueError, match="different"):
        load_or_init_invert(ck, other, params, opt)
