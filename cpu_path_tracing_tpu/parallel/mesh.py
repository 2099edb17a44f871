"""Device-mesh construction.

Replacement for the reference's Taskflow thread pool
(``src/main.cpp:214-236``, one task per image row) — parallelism is a
``jax.sharding.Mesh`` with two axes:

* ``tiles``:   image subpixel-cells sharded across devices (the analog of the
  reference's row decomposition, but at cell granularity and deterministic —
  the counter RNG makes the image independent of the mesh shape);
* ``samples``: samples-per-pixel sharded across devices (the second data-
  parallel axis the reference only has as a sequential loop,
  ``src/main.cpp:184-193``).

Scene parameters are replicated (SURVEY.md §2.3: ~10 spheres — TP is
pointless); forward rendering needs zero collectives until the final sample
``psum``; inverse rendering adds a gradient ``psum`` over both axes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(
    n_tiles: Optional[int] = None,
    n_samples: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('tiles', 'samples') mesh.

    Defaults to all visible devices on the tiles axis.  ``n_tiles *
    n_samples`` must equal the device count.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_tiles is None:
        n_tiles = len(devices) // n_samples
    if n_tiles * n_samples != len(devices):
        raise ValueError(
            f"mesh {n_tiles}x{n_samples} != {len(devices)} devices"
        )
    arr = np.asarray(devices).reshape(n_tiles, n_samples)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))
