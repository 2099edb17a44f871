"""Multi-host distributed rendering (SURVEY.md §5.8).

The reference is a single process with a shared-memory thread pool
(``src/main.cpp:214-236``); it has no communication backend at all.  This
module is the distributed layer:

* ``init_distributed`` — ``jax.distributed.initialize()`` over the process
  group (coordinator service); on the CPU backend it enables Gloo
  collectives so the full multi-process path runs (and is tested) on one
  machine — tests/test_distributed.py launches real 2-process jobs.
* a global ``('tiles', 'samples')`` mesh over every device of every host; scene
  parameters replicated, image cells sharded.  Forward rendering needs ZERO
  cross-host collectives until the final image gather — and none at all in
  shard-output mode, where each host writes only its own tile shard.
* determinism: keys depend only on (seed, cell, sample) (ops/rng.py), so the
  1-process and N-process renders are bit-identical images (modulo f32
  summation order when the sample axis is sharded).

Launch: one process per host, e.g.

    python -m cpu_path_tracing_tpu.cli render --scene box_mirror \\
        --coordinator HOST0:12345 --num-processes 2 --process-id $RANK ...

or use scripts/launch_multihost.sh for a local N-process CPU run.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..models.scene import Scene
from ..render import finalize_image
from .mesh import SAMPLE_AXIS, TILE_AXIS
from .render import render_cells_sharded


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group.  Arguments fall back to the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) and then
    to whatever cluster autodetection jax.distributed.initialize has.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    # CPU backend: cross-process collectives need the Gloo implementation
    # (no effect on accelerators, whose collectives XLA runs natively).
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # older/newer jax without the option: accelerators only
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_samples: int = 1) -> Mesh:
    """('tiles', 'samples') mesh over every device of every host."""
    devices = np.asarray(jax.devices())
    if devices.size % n_samples:
        raise ValueError(f"{devices.size} devices not divisible by samples={n_samples}")
    return Mesh(devices.reshape(-1, n_samples), (TILE_AXIS, SAMPLE_AXIS))


def render_image_multihost(scene: Scene, cfg: RenderConfig, mesh: Optional[Mesh] = None):
    """Full-image multi-host render; returns the [H,W,3] image fully
    replicated on every process (one all-gather at the end — the only
    cross-host communication of the whole forward render)."""
    if mesh is None:
        mesh = global_mesh()
    cells = render_cells_sharded(scene, cfg, mesh)  # [num_cells,3], tile-sharded
    img = jax.jit(
        lambda c: finalize_image(c, cfg),
        out_shardings=NamedSharding(mesh, P()),
    )(cells)
    return img


def render_shard_multihost(scene: Scene, cfg: RenderConfig, mesh: Optional[Mesh] = None):
    """Zero-collective mode: render and return only this process's tile
    shards as [(cell_start, cell_stop, sums[np]), ...] for per-host shard
    output (assemble with :func:`assemble_shards`)."""
    if mesh is None:
        mesh = global_mesh()
    cells = render_cells_sharded(scene, cfg, mesh)
    out = []
    for s in cells.addressable_shards:
        (sl,) = s.index[:1]
        start = sl.start or 0
        if start >= cfg.num_cells:
            continue  # pure padding shard
        data = np.asarray(s.data)
        stop = min(start + data.shape[0], cfg.num_cells)
        out.append((start, stop, data[: stop - start]))
    return out


def render_fingerprint(scene: Scene, cfg: RenderConfig) -> str:
    """Identity of one shard-mode render: the per-sample computation
    fingerprint (scene bytes + numerics, utils/checkpoint._fingerprint) plus
    the sample count.  Embedded in every shard file so stale shards from a
    previous run (or a different scene/config) in the same --shard-dir are
    rejected instead of silently assembled into a corrupt image."""
    from ..utils.checkpoint import _fingerprint
    import hashlib

    h = hashlib.sha256()
    h.update(_fingerprint(scene, cfg).encode())
    h.update(str(cfg.spp).encode())
    return h.hexdigest()[:16]


def _shard_fingerprint_of(path: str) -> Optional[str]:
    """Fingerprint stored in a shard file (None for pre-fingerprint files)."""
    try:
        with np.load(path) as z:
            if "fingerprint" in z.files:
                return str(z["fingerprint"])
    except Exception:
        return None  # partially-visible or foreign file: not a valid shard
    return None


def write_shards(out_dir: str, shards, cfg: RenderConfig, process_id: int,
                 fingerprint: Optional[str] = None) -> str:
    """Persist this process's shards as one .npz (idempotent, keyed by pid)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"shard_{process_id:05d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        starts=np.asarray([s for s, _, _ in shards], np.int64),
        stops=np.asarray([e for _, e, _ in shards], np.int64),
        means=np.concatenate([d for _, _, d in shards], axis=0),
        fingerprint=np.asarray(fingerprint or ""),
    )
    os.replace(tmp, path)
    return path


def _matching_shards(out_dir: str, fingerprint: Optional[str]) -> list[str]:
    names = sorted(
        n for n in (os.listdir(out_dir) if os.path.isdir(out_dir) else [])
        if n.startswith("shard_") and n.endswith(".npz")
    )
    if fingerprint is None:
        return names
    return [n for n in names
            if _shard_fingerprint_of(os.path.join(out_dir, n)) == fingerprint]


def wait_for_shards(out_dir: str, num_processes: int, timeout: float = 300.0,
                    poll: float = 0.25, fingerprint: Optional[str] = None) -> list[str]:
    """Elastic replacement for the cross-process sync barrier in shard mode:
    process 0 polls for the other hosts' shard files instead of entering a
    collective that would HANG FOREVER if a host died (shard writes are
    atomic os.replace, so a present file is a complete file).  With
    ``fingerprint``, only shards from THIS render count — stale files from a
    previous run cannot satisfy the wait.  Returns the shard files found; on
    timeout returns whatever exists — the assembler re-renders the rest
    (:func:`assemble_shards`)."""
    import time

    deadline = time.monotonic() + timeout
    while True:
        names = _matching_shards(out_dir, fingerprint)
        if len(names) >= num_processes or time.monotonic() >= deadline:
            return names
        time.sleep(poll)


# Sentinel protocol for surviving non-zero processes:
# jax.distributed's atexit shutdown barrier fatally aborts every survivor
# once the coordinator marks a dead task ERROR, so after a detected host
# loss ALL survivors must skip it via os._exit(0) — not just process 0.
# Process 0 (the only one that can detect the loss, via its shard wait)
# broadcasts the decision through a sentinel file in the shared shard dir.
_LOST_SENTINEL = "LOST_HOSTS"


def signal_lost_hosts(out_dir: str) -> None:
    """Atomically publish 'a host died; survivors must clean-exit'."""
    tmp = os.path.join(out_dir, _LOST_SENTINEL + ".tmp")
    with open(tmp, "w") as fh:
        fh.write("1\n")
    os.replace(tmp, os.path.join(out_dir, _LOST_SENTINEL))


def wait_all_or_lost(out_dir: str, num_processes: int, timeout: float,
                     poll: float = 0.25, fingerprint: Optional[str] = None) -> str:
    """Non-zero-process side of the elastic exit protocol.  Polls until
    either every process's shard landed ('complete' — all hosts alive, the
    normal shutdown barrier is safe) or process 0 signalled a host loss
    ('lost' — skip the barrier).  'timeout' covers the pathological case of
    process 0 itself dying mid-wait."""
    import time

    deadline = time.monotonic() + timeout
    while True:
        if os.path.exists(os.path.join(out_dir, _LOST_SENTINEL)):
            return "lost"
        if len(_matching_shards(out_dir, fingerprint)) >= num_processes:
            return "complete"
        if time.monotonic() >= deadline:
            return "timeout"
        time.sleep(poll)


def recover_missing_cells(cells: np.ndarray, scene: Scene, cfg: RenderConfig):
    """Re-render every missing (NaN) cell span locally — SURVEY §5.3's
    lost-tile recovery at the multi-host level.  Keys depend only on
    (seed, cell, sample), so the recovered spans are bit-identical to what
    the lost host would have written on the same backend (for sample-sharded
    meshes the psum order differs from the sequential local accumulation —
    agreement is then ~1 ulp, same caveat as the mesh-shape tests).
    Returns the list of recovered (start, stop) spans."""
    from ..render import render_cells_range

    missing = np.flatnonzero(np.isnan(cells[:, 0]))
    spans: list[tuple[int, int]] = []
    if missing.size == 0:
        return spans
    # contiguous spans (the wavefront contract wants contiguous ids anyway)
    breaks = np.flatnonzero(np.diff(missing) > 1)
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks, [missing.size - 1]])
    for a, b in zip(missing[starts], missing[stops]):
        ids = jnp.arange(int(a), int(b) + 1, dtype=jnp.int32)
        means = render_cells_range(scene, cfg, ids, 0, cfg.spp) / cfg.spp
        cells[int(a) : int(b) + 1] = np.asarray(means, np.float32)
        spans.append((int(a), int(b) + 1))
    return spans


def assemble_shards(out_dir: str, cfg: RenderConfig, scene: Scene | None = None,
                    fingerprint: Optional[str] = None):
    """Combine shard files from all hosts into the final [H,W,3] image.

    With ``scene`` given, missing cells (a lost host) are automatically
    re-rendered locally (:func:`recover_missing_cells`) — elastic recovery
    instead of a crash; without it, raises so the caller can re-run.  With
    ``fingerprint``, shards from a different render are skipped (warned) —
    they would otherwise assemble into a silently corrupt image."""
    import sys

    cells = np.full((cfg.num_cells, 3), np.nan, np.float32)
    for name in sorted(os.listdir(out_dir)):
        if not (name.startswith("shard_") and name.endswith(".npz")):
            continue
        if fingerprint is not None:
            got = _shard_fingerprint_of(os.path.join(out_dir, name))
            if got != fingerprint:
                print(f"assemble_shards: skipping stale shard {name} "
                      f"(fingerprint {got!r} != {fingerprint!r})", file=sys.stderr)
                continue
        z = np.load(os.path.join(out_dir, name))
        off = 0
        for start, stop in zip(z["starts"], z["stops"]):
            n = int(stop - start)
            cells[start:stop] = z["means"][off : off + n]
            off += n
    if scene is not None:
        spans = recover_missing_cells(cells, scene, cfg)
        if spans:
            lost = sum(b - a for a, b in spans)
            print(f"recovered {lost} lost cells in {len(spans)} span(s): "
                  f"{spans[:4]}{'...' if len(spans) > 4 else ''}",
                  file=__import__('sys').stderr)
    missing = np.flatnonzero(np.isnan(cells[:, 0]))
    if missing.size:
        raise ValueError(
            f"{missing.size} cells missing (first: {missing[0]}) — a host's "
            f"shard file was not written; re-render that shard"
        )
    return finalize_image(jnp.asarray(cells), cfg)
