"""Pinned-render regression tests.

The committed ``tests/data/pin_*.npz`` files are fixed-seed renders of three
registered scenes at 64x48 @ 8 total spp (batch integrator, CPU f32).  The
counter-based RNG makes every render a pure function of (scene, config,
seed), so any unintended change to the estimator — RNG layout, material
math, camera quirks, intersection — shifts these images and fails here.

DELIBERATE estimator changes (a new RNG layout, a lockstep expression-
structure change across the integrators) are allowed but must regenerate
the pins in the same commit; the looser tolerance absorbs pure ulp-lottery
noise from compiler/version drift while catching anything semantic (a
material or camera bug moves pixels by whole radiance units, ~1e5 times
the tolerance).
"""

import os

import numpy as np
import pytest

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.render import render_image

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.mark.parametrize("name", ["box", "box_mirror", "simple"])
def test_pinned_render_regression(name):
    cfg = pt.RenderConfig(width=64, height=48, spp=2, max_depth=16,
                          integrator="batch")
    scene = pt.get_scene(name, 64, 48)
    img = np.asarray(render_image(scene, cfg), np.float32)
    ref = np.load(os.path.join(DATA, f"pin_{name}_64x48.npz"))["img"]
    # scale-aware: |a-b| / max(1, |b|); 1e-4 >> ulp noise, << any real bug
    dev = np.abs(img - ref) / np.maximum(1.0, np.abs(ref))
    assert float(dev.max()) < 1e-4, (name, float(dev.max()))
