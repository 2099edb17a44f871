"""Counter-based RNG: explicit Threefry-2x32.

Replacement for the reference's per-row mutable ``std::mt19937``
stream (``src/random_state.cpp:3-17``), which is (a) sequential — forcing
row-granular parallelism — and (b) non-deterministic across runs (the seed
mixes ``std::random_device``, ``src/random_state.cpp:5``).

Every draw is a pure function of ``(seed, cell, sample, purpose)``:

    item key   (a0,a1) = threefry2x32((s0,s1), (cell, sample))
    draw block (y0,y1) = threefry2x32((a0,a1), (purpose, block))

so any tiling / chunking / sharding / mesh shape / lane schedule produces the
*same* numbers; the f64 oracle and the f32 fast paths consume bit-identical
uniforms (uniforms are always materialized in f32 from the high 24 bits).

The block cipher is implemented directly with public jnp ops (Threefry-2x32,
Salmon et al. 2011 — the PRF family behind jax.random) instead of via typed
key plumbing: two blocks per bounce instead of three (fold_in costs a full
block), and the identical integer math runs inside the fused GPU kernel
without breaking image parity (it imports THIS function).

Round count: 13, the Crush-resistant minimum from Salmon et al. Table 2
(jax.random uses 20 for extra safety margin).  The cipher is a sizeable
share of a bounce's arithmetic, and rendering consumes uniforms — not
cryptographic margin — so the validated minimum is the right default.  Rounds that are not a multiple of 4 skip
the trailing key injection, exactly like Random123's reference
implementation, whose 13-round variant is what BigCrush validated.

Draw layout per (cell, sample):
  item key words       -> [jitter_x, jitter_y]  (the key doubles as draws)
  purpose 0            -> [disk_u1, disk_u2]                      (camera)
  purpose 1 + depth    -> [u_rr, u_a, u_b, u_c]                   (bounce)
      diffuse:    u_a = phi draw, u_b = sin^2(theta) draw
      dielectric: u_a = reflect/refract choice
      (the reference's draw counts are data-dependent, src/main.cpp:44-97;
      a fixed 4-draw block replaces them — SURVEY.md §3.3)

u_c is RESERVED, deliberately: a bounce consumes 3 words
and Threefry-2x32 mints 2 per block, so 2 blocks/bounce is the counter-pure
minimum; reclaiming the 4th word means carrying the previous bounce's spare
block across iterations (an extra persistent state word) for a small
forward win, at the price of an RNG-layout change that invalidates
every pinned render and refit scene.  It is kept as the slot for a future
4-draw feature (e.g. a roughness/fuzz draw, whose no-op quirk
ops/materials.py already documents).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_PARITY = np.uint32(0x1BD11BDA)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# 13 = the BigCrush-passing minimum for Threefry-2x32 (module docstring).
ROUNDS = 13


def threefry2x32(k0, k1, c0, c1, rounds: int = ROUNDS) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Threefry-2x32 block (``rounds`` rounds, default ROUNDS): keys (k0,k1),
    counter (c0,c1) -> 2 words.  All inputs broadcast; uint32 in, uint32 out.
    Random123 semantics: key injection after every 4th round only.
    (``rounds`` is a test seam: tests/test_rng.py pins the 20-round output
    against the published Random123/jax KAT vectors, which validates the
    rotation schedule and key-injection structure the 13-round production
    variant shares.)
    """
    k0 = jnp.asarray(k0, _U32)
    k1 = jnp.asarray(k1, _U32)
    ks2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, ks2)

    x0 = jnp.asarray(c0, _U32) + k0
    x1 = jnp.asarray(c1, _U32) + k1

    done = 0
    group = 0
    while done < rounds:
        for r in _ROTATIONS[group % 2]:
            if done == rounds:
                break
            x0 = x0 + x1
            x1 = (x1 << r) | (x1 >> (32 - r))
            x1 = x1 ^ x0
            done += 1
        if done % 4 == 0:
            x0 = x0 + ks[(group + 1) % 3]
            x1 = x1 + ks[(group + 2) % 3] + _U32(group + 1)
        group += 1
    return x0, x1


def master_key(seed: int) -> Tuple[np.uint32, np.uint32]:
    """Split a python seed into the (s0, s1) cipher key."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32)


def item_keys(seed, cell_ids, sample_idx) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-(cell, sample) key pair [B] (one cipher block)."""
    s0, s1 = master_key(seed) if isinstance(seed, int) else seed
    return threefry2x32(s0, s1, jnp.asarray(cell_ids, _U32), jnp.asarray(sample_idx, _U32))


def _to_uniform(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> f32 uniform in [0,1) from the top 24 bits."""
    return (bits >> np.uint32(8)).astype(jnp.float32) * np.float32(2.0**-24)


def uniforms4(a0, a1, purpose) -> jnp.ndarray:
    """[B,4] f32 uniforms for draw purpose ``purpose`` (two cipher blocks)."""
    p = jnp.asarray(purpose, _U32)
    y0, y1 = threefry2x32(a0, a1, p, p * _U32(0))
    y2, y3 = threefry2x32(a0, a1, p, p * _U32(0) + _U32(1))
    return jnp.stack([_to_uniform(y0), _to_uniform(y1), _to_uniform(y2), _to_uniform(y3)], axis=-1)


def camera_uniforms(a0, a1) -> jnp.ndarray:
    """[B,4]: [jitter_x, jitter_y, disk_u1, disk_u2].

    The subpixel jitter comes from the item-key words THEMSELVES (a0, a1
    are Threefry outputs, i.e. uniform words) and only the lens-disk pair
    costs a cipher block — one block per regeneration instead of two.  Reusing PRF output words
    both as the bounce-block subkey and as two uniforms is sound for Monte
    Carlo: correlating (jitter, bounce draws) would amount to
    distinguishing threefry outputs from random given a related key."""
    y0, y1 = threefry2x32(a0, a1, jnp.zeros_like(a0), jnp.zeros_like(a0))
    return jnp.stack(
        [_to_uniform(a0), _to_uniform(a1), _to_uniform(y0), _to_uniform(y1)],
        axis=-1)


def bounce_uniforms(a0, a1, depth) -> jnp.ndarray:
    """[B,4]: [u_rr, u_a, u_b, u_c] for bounce ``depth`` (scalar or [B])."""
    p = (jnp.asarray(depth).astype(_U32) + _U32(1)) * jnp.ones_like(a0)
    return uniforms4(a0, a1, p)
