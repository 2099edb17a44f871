"""The fused GPU kernel (ops/pallas/gpu_kernel.py) on the CPU, and how the
program chooses it.

The kernel runs here in the Pallas interpreter.  Its math mirrors the XLA
wavefront expression for expression (ops/intersect.py), so the two are
bitwise equal on every lane except sky-miss lanes, whose sky chain sits in
different fusion contexts in the two separately compiled programs (the fma
grouping is the compiler's choice: ~1 ulp on a few lanes).  On the card the
two-tier gate of chip_smoke.py holds the compiled kernel to the same
reference.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpu_path_tracing_tpu as pt
import cpu_path_tracing_tpu.render as render_mod
from cpu_path_tracing_tpu.ops.pallas.gpu_kernel import render_kernel
from cpu_path_tracing_tpu.ops.wavefront import render_wavefront

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cells(cfg):
    return jnp.arange(cfg.num_cells, dtype=jnp.int32)


@pytest.mark.parametrize("name, bitwise", [
    ("box", True), ("box_mirror", True), ("depth_of_field", True), ("simple", False),
])
def test_kernel_matches_wavefront(name, bitwise):
    cfg = pt.RenderConfig(width=12, height=8, spp=2, max_depth=8)
    scene = pt.get_scene(name, cfg.width, cfg.height)
    ids = _cells(cfg)
    got, st = render_kernel(scene, cfg, ids, 0, 2, interpret=True, with_stats=True)
    ref, st_ref = render_wavefront(scene, cfg, ids, 0, 2, with_stats=True)
    got, ref = np.asarray(got), np.asarray(ref)
    if bitwise:
        np.testing.assert_array_equal(got, ref, err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg=name)
    # Same paths, same decisions: the segment counts agree exactly.
    assert int(st["segments"]) == int(st_ref["segments"])


@pytest.mark.parametrize("backend, dtype, jitter, expected", [
    ("gpu", jnp.float32, "uniform", "pallas"),
    ("cpu", jnp.float32, "uniform", "wavefront"),
    ("gpu", jnp.float64, "uniform", "wavefront"),
    ("gpu", jnp.float32, "tent", "wavefront"),
])
def test_auto_picks_kernel_only_on_gpu(monkeypatch, backend, dtype, jitter, expected):
    monkeypatch.setattr(render_mod.jax, "default_backend", lambda: backend)
    scene = pt.get_scene("box", 8, 6, dtype=dtype)
    cfg = pt.RenderConfig(width=8, height=6, jitter=jitter)
    assert render_mod.resolve_integrator(scene, cfg) == expected


def test_kernel_raises_off_gpu_without_interpret():
    cfg = pt.RenderConfig(width=8, height=6, spp=1, max_depth=4)
    scene = pt.get_scene("box", 8, 6)
    with pytest.raises(RuntimeError, match="gpu backend"):
        render_kernel(scene, cfg, _cells(cfg), 0, 1)
    # The explicit integrator reaches the same refusal: no quiet fallback.
    with pytest.raises(RuntimeError, match="gpu backend"):
        render_mod.render_cells_range(scene, cfg.replace(integrator="pallas"),
                                      _cells(cfg), 0, 1)


def test_pallas_integrator_dispatch(monkeypatch):
    """integrator='pallas' routes render_cells_range to the fused kernel."""
    from cpu_path_tracing_tpu.ops.pallas import gpu_kernel

    calls = []
    monkeypatch.setattr(gpu_kernel, "render_kernel",
                        lambda *a, **k: calls.append(a[3:5]) or a[2])
    cfg = pt.RenderConfig(width=8, height=6, spp=1, max_depth=8, integrator="pallas")
    scene = pt.get_scene("box", 8, 6)
    render_mod.render_cells_range(scene, cfg, _cells(cfg), 3, 1)
    assert calls == [(3, 1)]
    assert render_mod.span_renderer(scene, cfg) is gpu_kernel.render_kernel


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero and prints no result without a GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_rule(monkeypatch, tmp_path, env_dir):
    """The variable wins when set; otherwise one fixed path in the checkout."""
    from cpu_path_tracing_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert compile_cache.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
            jax.config.update("jax_compilation_cache_dir", before)
            assert compile_cache.enable_compile_cache() == path
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
