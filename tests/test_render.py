"""End-to-end render tests: determinism and f32-vs-f64 oracle parity.

The parity oracle is this framework's own float64 CPU rendering of the same
algorithm with the same threefry draws (SURVEY.md §4c — the C++ binary is
non-deterministic, src/random_state.cpp:5, so it cannot be a golden oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cpu_path_tracing_tpu import RenderConfig, get_scene, render_image


def _render(name, dtype, **kw):
    cfg = RenderConfig(**kw)
    scene = get_scene(name, kw["width"], kw["height"], dtype=dtype)
    return np.asarray(render_image(scene, cfg))


BASE = dict(width=48, height=36, spp=4, max_depth=32)


def test_same_seed_bitwise_identical():
    a = _render("box", jnp.float32, **BASE)
    b = _render("box", jnp.float32, **BASE)
    np.testing.assert_array_equal(a, b)


def test_different_seed_differs():
    a = _render("box", jnp.float32, **BASE)
    b = _render("box", jnp.float32, seed=1, **BASE)
    assert np.abs(a - b).max() > 1e-4


@pytest.mark.slow
def test_chunked_matches_oneshot():
    a = _render("box", jnp.float32, **BASE)
    b = _render("box", jnp.float32, ray_chunk=500, **BASE)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["simple", "box", "box_mirror"])
def test_f32_matches_f64_oracle(name):
    """f32 production render vs f64 oracle, identical draw streams.

    Pixels whose paths flip a discrete branch under fp rounding can differ
    arbitrarily; those are rare.  Check the bulk: >=97% of pixels within 2e-2
    and mean abs diff < 4e-3.
    """
    kw = dict(width=40, height=30, spp=4, max_depth=24)
    a32 = _render(name, jnp.float32, **kw)
    a64 = _render(name, jnp.float64, **kw)
    diff = np.abs(a32 - a64)
    frac_close = (diff < 2e-2).mean()
    assert frac_close >= 0.97, (name, frac_close, diff.mean())
    assert diff.mean() < 4e-3, (name, diff.mean())


def test_image_orientation_simple_scene():
    """Sky is up: in the simple scene the top image rows are sky-blue-ish
    (blue channel > red), the bottom rows are the yellow ground (red+green >>
    blue).  Guards the vertical flip (src/main.cpp:181)."""
    img = _render("simple", jnp.float32, width=32, height=24, spp=2, max_depth=8)
    top = img[:4].mean(axis=(0, 1))
    bottom = img[-4:].mean(axis=(0, 1))
    assert top[2] > top[0]  # blue-ish sky
    assert bottom[0] > bottom[2] and bottom[1] > bottom[2]  # yellow ground


def test_subpixel_clamp_before_average():
    """Cell means > 1 must clamp per subpixel before the 2x2 average
    (src/main.cpp:195-196)."""
    from cpu_path_tracing_tpu import finalize_image

    cfg = RenderConfig(width=1, height=1, spp=1)
    cells = jnp.array(
        [[5.0, 0.5, 0.0], [0.0, 0.5, 0.0], [0.0, 0.5, 0.0], [0.0, 0.5, 0.0]]
    )
    img = np.asarray(finalize_image(cells, cfg))
    # red: clamp(5)=1 then mean(1,0,0,0) = 0.25 (unclamped mean would be 1.25)
    np.testing.assert_allclose(img[0, 0], [0.25, 0.5, 0.0], atol=1e-7)


def test_tune_wavefront_regimes():
    """Pilot-based wavefront auto-tuner: long-path scenes keep the maximal
    pool; short-path scenes get a shrunken pool + deep ring (a shorter
    drain tail)."""
    from cpu_path_tracing_tpu.render import tune_wavefront

    cfg = RenderConfig(width=32, height=24, spp=16, max_depth=40)
    box = get_scene("box", 32, 24)
    assert tune_wavefront(box, cfg) == cfg  # E[depth] ~ 12: unchanged

    simple = get_scene("simple", 32, 24)
    tuned = tune_wavefront(simple, cfg)
    assert 1 << 16 <= tuned.wavefront_lanes <= cfg.wavefront_lanes
    assert tuned.wavefront_ring == 32
    # explicit ring settings are respected
    assert tune_wavefront(simple, cfg.replace(wavefront_ring=16)).wavefront_ring == 16


def test_render_image_sample_chunking_capped_and_equivalent(monkeypatch):
    """render_image must cap per-launch wavefront items (plain `render` at
    production spp could otherwise allocate a ~10 GB item buffer)
    and the chunked image must match the unchunked one to f32 summation
    association (~1 ulp of the sample sum)."""
    import cpu_path_tracing_tpu.render as render_mod

    kw = dict(width=32, height=24, spp=8, max_depth=16)
    ref = _render("box", jnp.float32, **kw)

    cfg = RenderConfig(**kw)
    scene = get_scene("box", kw["width"], kw["height"], dtype=jnp.float32)
    seen = []
    orig = render_mod.render_cells_range

    def spy(sc, c, ids, start, num, *a, **k):
        # ids may be a tracer here (inside the jitted span) — shapes are
        # static either way.
        seen.append((int(ids.shape[0]), int(num)))
        return orig(sc, c, ids, start, num, *a, **k)

    monkeypatch.setattr(render_mod, "render_cells_range", spy)
    cap = cfg.num_cells * 2  # forces spp chunks of 2
    monkeypatch.setattr(render_mod, "sample_chunk_for",
                        lambda spp, n, items_cap=64 << 20: 2)
    img = np.asarray(render_mod.render_image(scene, cfg))
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6)
    assert seen, "spy never saw a launch"
    assert all(b * s <= cap for b, s in seen), seen
    assert any(s < cfg.spp for b, s in seen), "sample chunking never engaged"


def test_tent_filter_statistics_and_dispatch():
    """jitter='tent' must (a) reproduce the smallpt tent distribution —
    mean 0.5 subpixel units, wider-than-uniform spread, support [-0.5,1.5]
    — (b) refuse the fused GPU kernel (no in-kernel tent camera), (c)
    resolve 'auto' away from it."""
    import jax.numpy as jnp_
    from cpu_path_tracing_tpu.render import (
        camera_rays_for_cells, resolve_integrator)

    cfg_u = RenderConfig(width=64, height=1, spp=1, num_subpixels=1)
    cfg_t = cfg_u.replace(jitter="tent")
    scene = get_scene("smallpt_exact", 64, 1)
    ids = jnp_.arange(64, dtype=jnp_.int32)
    rng = np.random.default_rng(0)
    u = jnp_.asarray(rng.uniform(size=(64, 4)), jnp_.float32)
    # x_in = x + jitter; recover the jitter by subtracting the cell x
    _, d_u = camera_rays_for_cells(scene, cfg_u, ids, u, jnp_.float32)
    _, d_t = camera_rays_for_cells(scene, cfg_t, ids, u, jnp_.float32)
    # directions differ (the filter changed the sample positions)
    assert np.abs(np.asarray(d_u) - np.asarray(d_t)).max() > 0

    # distribution check on the raw tent transform
    r = rng.uniform(size=200000)
    tent = np.where(2 * r < 1, np.sqrt(2 * r) - 1, 1 - np.sqrt(2 - 2 * r))
    j = 0.5 + tent
    assert abs(j.mean() - 0.5) < 5e-3
    assert j.min() >= -0.5 and j.max() <= 1.5
    assert j.std() > np.sqrt(1 / 12) + 0.05  # wider than uniform

    assert resolve_integrator(scene, cfg_t.replace(integrator="auto")) == "wavefront"
    with pytest.raises(ValueError, match="fused GPU kernel"):
        resolve_integrator(scene, cfg_t.replace(integrator="pallas"))
