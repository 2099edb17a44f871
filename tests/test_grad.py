"""Gradient correctness: jax.grad vs central finite differences
(SURVEY.md §4d; BASELINE.json pixel-gradient parity target).

FD oracles run in float64 through the *same* code path; discrete decisions
(hit ids, RR, dielectric branch) are locally constant at the tested points,
so grad and FD must agree tightly away from visibility edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.grad import cell_loss, merge_params, split_params, train_step

CFG = pt.RenderConfig(width=12, height=8, spp=2, max_depth=8, loop="scan")


def _setup(name="box", fields=("p0", "radius", "albedo")):
    scene = pt.get_scene(name, CFG.width, CFG.height, dtype=jnp.float64)
    cell_ids = jnp.arange(CFG.num_cells, dtype=jnp.int32)
    from cpu_path_tracing_tpu.render import render_cells

    # Same seed as the render inside the loss: common random numbers — the
    # loss is exactly 0 at the true parameters (no Monte-Carlo noise floor).
    target = render_cells(scene, CFG, cell_ids)
    params = split_params(scene, fields)
    return scene, cell_ids, target, params


def _fd(fn, params, leaf, idx, eps):
    flat = params[leaf].reshape(-1)
    up = flat.at[idx].add(eps).reshape(params[leaf].shape)
    dn = flat.at[idx].add(-eps).reshape(params[leaf].shape)
    fp = fn({**params, leaf: up})
    fm = fn({**params, leaf: dn})
    return (fp - fm) / (2 * eps)


@pytest.mark.slow
def test_grad_camera_position():
    """FD parity for camera position on the open scene with a mismatched
    target (nonzero gradients; see _setup_open)."""
    import dataclasses

    from cpu_path_tracing_tpu.render import render_cells_range

    scene, cell_ids, target, _ = _setup_open(fields=("albedo",))

    def loss_cam(pos):
        cam = dataclasses.replace(scene.camera, position=pos)
        sc = dataclasses.replace(scene, camera=cam)
        cells = render_cells_range(sc, CFG, cell_ids, 0, CFG.spp) / CFG.spp
        return jnp.mean((cells - target) ** 2)

    pos = scene.camera.position
    g = np.asarray(jax.grad(loss_cam)(pos))
    assert np.max(np.abs(g)) > 0
    eps = 1e-6
    for axis in range(3):
        fp = float(loss_cam(pos.at[axis].add(eps)))
        fm = float(loss_cam(pos.at[axis].add(-eps)))
        fd = (fp - fm) / (2 * eps)
        scale = max(abs(fd), abs(g[axis]), 1e-3)
        assert abs(fd - g[axis]) / scale < 5e-3, (axis, fd, g[axis])


def _setup_open(fields=("p0", "radius", "albedo"), cfg=None):
    """Open-sky setup with a MISMATCHED target: the simple scene's rays escape
    to the sky gradient, which is the continuous path geometry gradients flow
    through (ops/integrator.py docstring), and target != render keeps the loss
    away from its minimum so gradients are non-trivially nonzero — the round-1
    FD tests compared grad=0 to FD=0 at the optimum, which verified nothing."""
    cfg = cfg or CFG
    scene = pt.get_scene("simple", cfg.width, cfg.height, dtype=jnp.float64)
    cell_ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    from cpu_path_tracing_tpu.render import render_cells

    target = render_cells(scene, cfg, cell_ids) * 0.9
    params = split_params(scene, fields)
    return scene, cell_ids, target, params


@pytest.mark.parametrize("leaf,eps", [("p0", 1e-6), ("radius", 1e-6), ("albedo", 1e-6),
                                      ("emission", 1e-6), ("background", 1e-6)])
@pytest.mark.slow
def test_grad_matches_fd_nonzero(leaf, eps):
    """grad vs FD on the open scene where the gradient is genuinely nonzero."""
    scene, cell_ids, target, params = _setup_open(
        fields=("p0", "radius", "albedo", "emission", "background"))

    def loss(p):
        return cell_loss(p, scene, CFG, cell_ids, target)

    g = np.asarray(jax.grad(loss)(params)[leaf]).reshape(-1)
    assert np.max(np.abs(g)) > 0, f"{leaf} gradient identically zero"

    rng = np.random.default_rng(1)
    idxs = rng.choice(g.size, size=min(4, g.size), replace=False)
    # Also probe the largest-magnitude entry.
    idxs = np.unique(np.concatenate([idxs, [np.argmax(np.abs(g))]]))
    for i in idxs:
        fd = float(_fd(loss, params, leaf, int(i), eps))
        scale = max(abs(fd), abs(g[i]), 1e-3)
        assert abs(fd - g[i]) / scale < 5e-3, (leaf, i, fd, g[i])


@pytest.mark.slow
def test_geometry_grad_zero_in_closed_scene():
    """Pin the documented estimator structure: in the closed box scene no
    sample path reaches the background, so the detached estimator's geometry
    gradient is exactly zero (visibility edges are not sampled)."""
    scene, cell_ids, target, params = _setup()

    g = jax.grad(lambda p: cell_loss(p, scene, CFG, cell_ids, target * 0.9))(params)
    assert float(jnp.max(jnp.abs(g["p0"]))) == 0.0
    assert float(jnp.max(jnp.abs(g["radius"]))) == 0.0
    assert float(jnp.max(jnp.abs(g["albedo"]))) > 0.0


@pytest.mark.slow
def test_grad_camera_scalars():
    """FD parity for the camera scalars declared optimizable: vfov, aperture,
    focus_distance, and look_at."""
    import dataclasses

    from cpu_path_tracing_tpu.render import render_cells_range

    scene, cell_ids, target, _ = _setup_open(fields=("albedo",))

    def loss_with_cam(**kw):
        cam = dataclasses.replace(scene.camera, **kw)
        sc = dataclasses.replace(scene, camera=cam)
        cells = render_cells_range(sc, CFG, cell_ids, 0, CFG.spp) / CFG.spp
        return jnp.mean((cells - target) ** 2)

    eps = 1e-6
    for field in ("vertical_fov_radians", "aperture", "focus_distance"):
        v0 = getattr(scene.camera, field)
        g = float(jax.grad(lambda v: loss_with_cam(**{field: v}))(v0))
        fd = (float(loss_with_cam(**{field: v0 + eps}))
              - float(loss_with_cam(**{field: v0 - eps}))) / (2 * eps)
        scale = max(abs(fd), abs(g), 1e-3)
        assert abs(fd - g) / scale < 5e-3, (field, fd, g)
        assert abs(g) > 0, f"{field} gradient identically zero"

    la = scene.camera.look_at
    g = np.asarray(jax.grad(lambda v: loss_with_cam(look_at=v))(la))
    for axis in range(3):
        fd = (float(loss_with_cam(look_at=la.at[axis].add(eps)))
              - float(loss_with_cam(look_at=la.at[axis].add(-eps)))) / (2 * eps)
        scale = max(abs(fd), abs(g[axis]), 1e-3)
        assert abs(fd - g[axis]) / scale < 5e-3, (axis, fd, g[axis])


@pytest.mark.slow
def test_diff_render_matches_direct_autodiff():
    """make_diff_render (fast wavefront forward + chunked remat backward)
    must produce the identical value and gradient as plain jax.grad through
    the scan integrator."""
    from cpu_path_tracing_tpu.grad import make_diff_render
    from cpu_path_tracing_tpu.render import render_cells_range

    cfg = pt.RenderConfig(width=10, height=6, spp=4, max_depth=10)
    scene = pt.get_scene("simple", cfg.width, cfg.height, dtype=jnp.float64)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    params = split_params(scene, ("p0", "radius", "albedo", "emission", "background"))
    target = 0.5 * jnp.ones((cfg.num_cells, 3), jnp.float64)

    rm = make_diff_render(scene, cfg, sample_chunk=2)
    lc, gc = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean((rm(p, ids) - target) ** 2)))(params)

    scan_cfg = cfg.replace(loop="scan", integrator="batch")

    def direct(p):
        sc = merge_params(scene, p)
        out = render_cells_range(sc, scan_cfg, ids, 0, cfg.spp) / cfg.spp
        return jnp.mean((out - target) ** 2)

    ld, gd = jax.jit(jax.value_and_grad(direct))(params)
    assert abs(float(lc) - float(ld)) < 1e-12
    for k in gc:
        np.testing.assert_allclose(np.asarray(gc[k]), np.asarray(gd[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.slow
def test_remat_grad_identical():
    """jax.checkpoint on the bounce scan must not change gradients."""
    from cpu_path_tracing_tpu.render import render_cells_range

    cfg = pt.RenderConfig(width=8, height=6, spp=2, max_depth=12,
                          loop="scan", integrator="batch")
    scene = pt.get_scene("simple", cfg.width, cfg.height, dtype=jnp.float64)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    params = split_params(scene, ("p0", "albedo"))

    def loss(p, c):
        sc = merge_params(scene, p)
        return jnp.sum(render_cells_range(sc, c, ids, 0, cfg.spp))

    g0 = jax.grad(lambda p: loss(p, cfg))(params)
    g1 = jax.grad(lambda p: loss(p, cfg.replace(remat=True)))(params)
    for k in g0:
        # ~1-ulp tolerance: remat changes XLA's fusion choices, not the math.
        np.testing.assert_allclose(np.asarray(g0[k]), np.asarray(g1[k]),
                                    rtol=1e-13, atol=0, err_msg=k)


@pytest.mark.slow
def test_grad_full_depth_100():
    """FD parity at the production max_depth=100 — the rematerialized scan
    all the way down."""
    cfg = pt.RenderConfig(width=6, height=4, spp=2, max_depth=100,
                          loop="scan", integrator="batch", remat=True)
    scene, cell_ids, target, params = _setup_open(fields=("p0", "albedo"), cfg=cfg)

    def loss(p):
        return cell_loss(p, scene, cfg, cell_ids, target)

    g = jax.grad(loss)(params)
    gp = np.asarray(g["p0"]).reshape(-1)
    ga = np.asarray(g["albedo"]).reshape(-1)
    assert np.max(np.abs(gp)) > 0 and np.max(np.abs(ga)) > 0
    for leaf, vec in (("p0", gp), ("albedo", ga)):
        i = int(np.argmax(np.abs(vec)))
        fd = float(_fd(loss, params, leaf, i, 1e-6))
        scale = max(abs(fd), abs(vec[i]), 1e-3)
        assert abs(fd - vec[i]) / scale < 5e-3, (leaf, i, fd, vec[i])


@pytest.mark.slow
def test_accum_train_step_matches_monolithic():
    """Chunked gradient accumulation (cells x samples) must reproduce the
    monolithic train step: same loss, same params after one Adam update."""
    import optax

    from cpu_path_tracing_tpu.grad import make_accum_train_step, render_target

    cfg = pt.RenderConfig(width=10, height=8, spp=4, max_depth=8)
    scene = pt.get_scene("box", cfg.width, cfg.height, dtype=jnp.float64)
    target = render_target(scene, cfg) * 0.9
    params0 = split_params(scene, ("albedo", "emission"))

    optimizer = optax.adam(1e-2)
    p_mono, o_mono, l_mono = None, None, None
    results = []
    for cc, sc_ in ((None, None), (77, 2), (320, 1)):
        step = make_accum_train_step(scene, cfg, optimizer, cell_chunk=cc,
                                     sample_chunk=sc_)
        p, o, l = step(params0, optimizer.init(params0), target)
        results.append((cc, sc_, p, float(l)))
    _, _, p_ref, l_ref = results[0]
    for cc, sc_, p, l in results[1:]:
        assert abs(l - l_ref) < 1e-12, (cc, sc_, l, l_ref)
        for k in p_ref:
            np.testing.assert_allclose(np.asarray(p[k]), np.asarray(p_ref[k]),
                                       rtol=1e-9, atol=1e-12,
                                       err_msg=f"chunk=({cc},{sc_}) leaf={k}")


def test_inverse_rendering_recovers_albedo():
    """Perturb the box-scene albedos; Adam on pixel MSE must drive both the
    loss and the albedo error down (the BASELINE.json inverse config, shrunk)."""
    import optax

    scene, cell_ids, target, _ = _setup(fields=("albedo",))
    true_albedo = scene.albedo
    params = {"albedo": jnp.clip(true_albedo + 0.15, 0.05, None)}
    optimizer = optax.adam(3e-2)
    opt_state = optimizer.init(params)

    def loss_of(p):
        return float(cell_loss(p, scene, CFG, cell_ids, target))

    l0 = loss_of(params)
    err0 = float(jnp.abs(params["albedo"] - true_albedo).mean())
    for _ in range(30):
        params, opt_state, loss = train_step(
            params, opt_state, scene, CFG, optimizer, cell_ids, target
        )
    l1 = float(loss)
    err1 = float(jnp.abs(params["albedo"] - true_albedo).mean())
    assert l1 < 0.3 * l0, (l0, l1)
    assert err1 < 0.5 * err0, (err0, err1)


def test_compact_scan_primal_and_grad_exact():
    """Live-lane compaction (ops/integrator.radiance_compact — the
    adaptive-depth backward) must be invisible: bitwise
    primal, no truncated lanes, and gradients equal to the plain fixed-width
    scan up to lane-summation order.  FAST tier by design (the default
    gate must exercise gradient correctness)."""
    from cpu_path_tracing_tpu.ops import rng as rng_ops
    from cpu_path_tracing_tpu.ops.integrator import radiance, radiance_compact
    from cpu_path_tracing_tpu.grad import tune_backward_schedule
    from cpu_path_tracing_tpu.render import camera_rays, render_cells_range

    cfg = pt.RenderConfig(width=12, height=8, spp=1, max_depth=24)
    scene = pt.get_scene("box", cfg.width, cfg.height, dtype=jnp.float64)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    keys, o, d = camera_rays(scene, cfg, ids, jnp.uint32(0),
                             rng_ops.master_key(cfg.seed), jnp.float64)
    ref = radiance(scene, o, d, keys, max_depth=cfg.max_depth, loop="scan")
    sched = tune_backward_schedule(scene, cfg.replace(loop="scan"), probe_cells=256)
    assert sched is not None and len(sched) >= 2  # box decays -> real stages
    out, dropped = radiance_compact(scene, o, d, keys, max_depth=cfg.max_depth,
                                    schedule=sched)
    assert int(dropped) == 0
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    # p0 exercises the geometry chain THROUGH the compaction gather
    # transpose; albedo the throughput chain.  (emission dropped for tier
    # budget — it shares albedo's transpose path.)
    params = split_params(scene, ("p0", "albedo"))

    def loss(p, schedule):
        sc = merge_params(scene, p)
        c = cfg.replace(loop="scan", integrator="batch", compact_schedule=schedule)
        return jnp.sum(render_cells_range(sc, c, ids, 0, cfg.spp))

    g0 = jax.grad(lambda p: loss(p, None))(params)
    g1 = jax.grad(lambda p: loss(p, sched))(params)
    for k in g0:
        np.testing.assert_allclose(np.asarray(g0[k]), np.asarray(g1[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def test_compact_scan_fd_smoke():
    """Cheap FD smoke THROUGH the compacted remat backward in the fast tier
    (a grad regression must not pass precommit)."""
    from cpu_path_tracing_tpu.grad import make_diff_render

    cfg = pt.RenderConfig(width=6, height=4, spp=2, max_depth=16)
    scene = pt.get_scene("simple", cfg.width, cfg.height, dtype=jnp.float64)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    rm = make_diff_render(scene, cfg, sample_chunk=1)
    assert rm.bwd_cfg.compact_schedule is not None
    params = split_params(scene, ("albedo",))
    target = 0.4 * jnp.ones((cfg.num_cells, 3), jnp.float64)

    def loss(p):
        return jnp.mean((rm(p, ids) - target) ** 2)

    g = np.asarray(jax.grad(loss)(params)["albedo"]).reshape(-1)
    i = int(np.argmax(np.abs(g)))
    fd = float(_fd(lambda p: loss(p), params, "albedo", i, 1e-6))
    scale = max(abs(fd), abs(g[i]), 1e-3)
    assert abs(fd - g[i]) / scale < 5e-3, (fd, g[i])


def test_compact_capacity_overflow_is_counted():
    """A too-tight schedule must REPORT truncation (dropped > 0), never
    silently cap — the no-silent-caps contract of radiance_compact."""
    from cpu_path_tracing_tpu.ops import rng as rng_ops
    from cpu_path_tracing_tpu.ops.integrator import radiance_compact
    from cpu_path_tracing_tpu.render import camera_rays

    cfg = pt.RenderConfig(width=16, height=16, spp=1, max_depth=12)
    scene = pt.get_scene("box", cfg.width, cfg.height, dtype=jnp.float64)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    keys, o, d = camera_rays(scene, cfg, ids, jnp.uint32(0),
                             rng_ops.master_key(cfg.seed), jnp.float64)
    # box paths are all still alive at depth 4; a 256-lane capacity there
    # (1024 cells) must overflow and be counted.
    _, dropped = radiance_compact(scene, o, d, keys, max_depth=cfg.max_depth,
                                  schedule=((4, 1.0), (8, 0.25)))
    assert int(dropped) > 0
