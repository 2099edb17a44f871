"""Fault-tolerant tile orchestrator (SURVEY.md §5.3).

The reference has **no** failure handling: a failed row task would crash the
process and lose the whole render (``src/main.cpp:214-236`` — the Taskflow
executor has no retry path, and the image lives only in RAM until the final
PPM write, ``src/main.cpp:240-247``).

Here failure detection and elastic recovery are first-class, built on two
properties of the batched design:

* **Idempotence** — a tile's radiance sums are a pure function of
  ``(scene, config, tile cell span, seed)``; the counter-based RNG
  (ops/rng.py) keys every draw by ``(seed, cell, sample)``, so re-rendering a
  tile after any failure produces the bit-identical result.  Retrying is
  always safe.
* **Durability** — per-tile completion is recorded in the progressive
  checkpoint, so a preempted/killed job resumes with only its *missing*
  tiles (preemption of a shared accelerator is the realistic failure mode
  this targets).

Failure detection is exception-based: any error raised while rendering a tile
(XLA runtime error, device loss surfaced by jax, or an injected fault) marks
the tile failed; the orchestrator retries it up to ``max_retries`` times
before giving up.  A :class:`FaultInjector` provides the deterministic
fault-injection hook SURVEY.md §5.3 calls for, used by tests/test_faults.py
to exercise the retry and resume paths.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import RenderConfig
from .models.scene import Scene
from .render import finalize_image, render_cells_range
from .utils.checkpoint import _fingerprint


class InjectedFault(RuntimeError):
    """Raised by FaultInjector to simulate a lost tile."""


class TileRenderError(RuntimeError):
    """A tile kept failing past ``max_retries`` attempts."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministically fail chosen tiles for their first ``times`` attempts.

    ``fail_tiles`` maps tile index -> number of attempts to fail.  Parsed from
    the CLI as ``TILE[:TIMES][,TILE[:TIMES]...]`` (``--inject-fault 3:2,7``).
    """

    fail_tiles: dict[int, int] = dataclasses.field(default_factory=dict)
    attempts: dict[int, int] = dataclasses.field(default_factory=dict)

    @staticmethod
    def parse(spec: str) -> "FaultInjector":
        fail: dict[int, int] = {}
        for part in spec.split(","):
            if not part:
                continue
            tile, _, times = part.partition(":")
            fail[int(tile)] = int(times) if times else 1
        return FaultInjector(fail)

    def __call__(self, tile: int) -> None:
        n = self.attempts.get(tile, 0)
        self.attempts[tile] = n + 1
        if n < self.fail_tiles.get(tile, 0):
            raise InjectedFault(f"injected fault: tile {tile}, attempt {n}")


@dataclasses.dataclass
class TileState:
    """Durable orchestrator state: per-tile sums + completion bitmap."""

    sums: np.ndarray  # [num_cells, 3] radiance sums (completed tiles only)
    done: np.ndarray  # [n_tiles] bool
    fingerprint: str
    tile_cells: int

    def save(self, path: str) -> None:
        tmp = path + ".tmp.npz"
        np.savez(tmp, sums=self.sums, done=self.done,
                 fingerprint=self.fingerprint, tile_cells=self.tile_cells)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "TileState":
        z = np.load(path, allow_pickle=False)
        return TileState(
            sums=z["sums"], done=z["done"].astype(bool),
            fingerprint=str(z["fingerprint"]), tile_cells=int(z["tile_cells"]),
        )


def tile_spans(cfg: RenderConfig, tile_cells: int):
    """Contiguous [start, end) cell spans, aligned to whole pixels.

    Contiguity is required by the wavefront integrator (see
    render.render_cells_range); pixel alignment keeps every subpixel of a
    pixel in one tile so per-tile results compose into finalize_image.
    """
    ns2 = cfg.num_subpixels * cfg.num_subpixels
    tile_cells = max(ns2, tile_cells - tile_cells % ns2)
    return [(s, min(s + tile_cells, cfg.num_cells))
            for s in range(0, cfg.num_cells, tile_cells)], tile_cells


def render_tiled(
    scene: Scene,
    cfg: RenderConfig,
    *,
    tile_cells: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    max_retries: int = 2,
    fault_injector: Optional[Callable[[int], None]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    render_fn: Optional[Callable] = None,
) -> jax.Array:
    """Render the image as independent retried tiles; returns [H,W,3] linear.

    The image is bit-identical to the un-tiled render for every
    ``tile_cells`` (per-cell sums are independent; tested in
    tests/test_faults.py).  ``render_fn(scene, ids, start, n)`` defaults to
    the production jitted tile renderer and exists for test instrumentation.
    """
    spans, tile_cells = tile_spans(cfg, tile_cells or cfg.num_cells)
    n_tiles = len(spans)
    fp = _fingerprint(scene, cfg) + f"/spp{cfg.spp}/tc{tile_cells}"

    state = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = TileState.load(checkpoint_path)
        if state.fingerprint != fp:
            raise ValueError(
                f"checkpoint {checkpoint_path} was written for a different "
                f"scene/config/tiling ({state.fingerprint} != {fp})"
            )
    if state is None:
        state = TileState(
            sums=np.zeros((cfg.num_cells, 3), np.float32),
            done=np.zeros(n_tiles, bool), fingerprint=fp, tile_cells=tile_cells,
        )

    if render_fn is None:
        jitted = jax.jit(
            lambda sc, ids, start, n: render_cells_range(sc, cfg, ids, start, n),
            static_argnames=("n",),
        )
        render_fn = lambda sc, ids, start, n: jitted(sc, ids, start, n)  # noqa: E731

    n_done = int(state.done.sum())
    for tile, (s, e) in enumerate(spans):
        if state.done[tile]:
            continue
        ids = jnp.arange(s, e, dtype=jnp.int32)
        last_err: Optional[Exception] = None
        for _attempt in range(max_retries + 1):
            try:
                if fault_injector is not None:
                    fault_injector(tile)
                out = np.asarray(render_fn(scene, ids, 0, cfg.spp))
                break
            except Exception as err:  # noqa: BLE001 — any tile loss retries
                last_err = err
        else:
            raise TileRenderError(
                f"tile {tile} (cells [{s},{e})) failed {max_retries + 1} times"
            ) from last_err
        state.sums[s:e] = out
        state.done[tile] = True
        n_done += 1
        if checkpoint_path:
            state.save(checkpoint_path)
        if progress:
            progress(n_done, n_tiles)

    means = jnp.asarray(state.sums) / cfg.spp
    return finalize_image(means, cfg)
