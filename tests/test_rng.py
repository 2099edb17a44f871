"""Known-answer tests for the Threefry-2x32 cipher.

Every integrator shares ops/rng.threefry2x32, so the image-parity tests
cannot catch a cipher regression — they would all drift together.  These
tests pin the cipher itself:

* the 20-round output against the published Random123 KAT vectors (the same
  vectors jax's own random tests use), which validates the rotation
  schedule, key-injection cadence and parity constant that the 13-round
  production variant shares (rounds-not-multiple-of-4 skip the trailing
  injection, exactly like Random123's Threefry2x32_R(13));
* a bulk cross-check against jax's internal Random123-validated
  implementation at 20 rounds;
* pinned 13-round outputs (generated by this implementation once the
  20-round structure was validated) so any refactor of ROUNDS or the
  injection schedule fails loudly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cpu_path_tracing_tpu.ops.rng import ROUNDS, threefry2x32

# Random123 kat_vectors: Threefry2x32 R=20 — (key, counter, expected).
KAT_R20 = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]

# Pinned production outputs at ROUNDS=13 (generated by this implementation,
# structure validated by the R=20 KATs above + the jax cross-check below).
KAT_R13 = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x9D1C5EC6, 0x8BD50731)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0xFD36D048, 0x2D17272C)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xBA3E4725, 0xF27D669E)),
]


@pytest.mark.parametrize("key,ctr,expect", KAT_R20)
def test_threefry_20round_random123_kat(key, ctr, expect):
    y0, y1 = threefry2x32(key[0], key[1], ctr[0], ctr[1], rounds=20)
    assert (int(y0), int(y1)) == expect


@pytest.mark.parametrize("key,ctr,expect", KAT_R13)
def test_threefry_13round_pinned(key, ctr, expect):
    assert ROUNDS == 13  # the BigCrush-validated production round count
    y0, y1 = threefry2x32(key[0], key[1], ctr[0], ctr[1])
    assert (int(y0), int(y1)) == expect


def test_threefry_20round_matches_jax_bulk():
    """Bulk agreement with jax's own Random123-derived threefry (private
    API — skip gracefully if a future jax moves it)."""
    try:
        from jax._src.prng import threefry_2x32
    except ImportError:
        pytest.skip("jax._src.prng.threefry_2x32 not available")
    rng = np.random.default_rng(0)
    ks = rng.integers(0, 2**32, size=2, dtype=np.uint32)
    cs = rng.integers(0, 2**32, size=(2, 256), dtype=np.uint32)
    ours = threefry2x32(ks[0], ks[1], cs[0], cs[1], rounds=20)
    theirs = threefry_2x32(jnp.asarray(ks), jnp.asarray(cs.reshape(-1))).reshape(2, 256)
    assert bool(jnp.all(ours[0] == theirs[0]) and jnp.all(ours[1] == theirs[1]))
