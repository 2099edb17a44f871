"""Sharded rendering: shard_map over the ('tiles', 'samples') mesh.

The SPMD replacement for the reference's shared-memory row tasks
(``src/main.cpp:214-236``): each device renders a contiguous shard of
subpixel cells for its shard of the sample range; the only collective in the
forward path is one ``psum`` over the sample axis (and none at all when the
sample axis is trivial).  Determinism: keys depend only on (seed, cell,
sample) — see ops/rng.py — so every mesh shape produces the bit-identical
image modulo f32 summation order across the sample axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..models.scene import Scene
from ..render import finalize_image, render_cells_range, resolve_integrator
from .mesh import SAMPLE_AXIS, TILE_AXIS, make_mesh


def _pad_cells(cfg: RenderConfig, n_shards: int):
    """Cell ids padded so every shard gets the same count.  Padding repeats
    cell 0; padded results are discarded before finalize."""
    n = cfg.num_cells
    per = -(-n // n_shards)
    padded = per * n_shards
    ids = jnp.arange(padded, dtype=jnp.int32)
    return jnp.where(ids < n, ids, 0), n


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_cells_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> jax.Array:
    """Mean radiance per cell [num_cells, 3], computed over the mesh."""
    n_tiles = mesh.shape[TILE_AXIS]
    n_samp_shards = mesh.shape[SAMPLE_AXIS]
    if cfg.spp % n_samp_shards:
        raise ValueError(f"spp={cfg.spp} not divisible by sample-axis size {n_samp_shards}")
    spp_local = cfg.spp // n_samp_shards

    cell_ids, n = _pad_cells(cfg, n_tiles)

    def shard_fn(scene_rep, ids):
        # Mark ids as varying over the sample axis too (each sample shard
        # renders a different sample range), so loop carries inside
        # render_cells_range type-check under JAX's vma rules.
        ids = jax.lax.pcast(ids, SAMPLE_AXIS, to="varying")
        s0 = jax.lax.axis_index(SAMPLE_AXIS) * spp_local
        acc = render_cells_range(scene_rep, cfg, ids, s0, spp_local)
        acc = jax.lax.psum(acc, SAMPLE_AXIS)  # the only forward collective
        return acc / cfg.spp

    # check_vma only off for the fused GPU kernel: pallas_call outputs carry
    # no varying-axes metadata, so the vma type-checker cannot see through
    # the kernel (chip_smoke.py --chips 4 checks the sharded kernel against
    # the one-card render); the XLA integrators keep full static vma
    # checking.
    out = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(TILE_AXIS)),
        out_specs=P(TILE_AXIS),
        check_vma=resolve_integrator(scene, cfg) != "pallas",
    )(scene, cell_ids)
    return out[:n]


def render_image_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh | None = None) -> jax.Array:
    """Full sharded render -> linear image [H,W,3] (top row first)."""
    if mesh is None:
        mesh = make_mesh()
    cell_means = render_cells_sharded(scene, cfg, mesh)
    return finalize_image(cell_means, cfg)


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Place scene parameters replicated over the mesh (explicit, for callers
    that manage device placement themselves)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(scene, sharding)
