"""Headline benchmark: path segments/s on the disco_sphere (box_mirror) scene.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
``vs_baseline`` is value / 100 Mrays/s — the BASELINE.md north-star target
(the reference publishes no numbers of its own; see BASELINE.md).

"Rays" counts traced path segments (live lanes summed over bounce
iterations), not just camera rays — the honest denominator for a path
tracer's throughput.  The forward renderer is the one
``render.resolve_integrator`` picks for the device (the CLI's choice too).

Timing: one warm-up render (compilation), then the median wall time of
three renders, each waited for with ``block_until_ready``.  The script
measures a GPU only: it exits non-zero, printing no result, when JAX finds
none.

Usage: python bench.py
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.render import span_renderer
from cpu_path_tracing_tpu.utils.compile_cache import enable_compile_cache
from cpu_path_tracing_tpu.utils.metrics import device_record, median_seconds

BASELINE_MRAYS = 100.0


def bench_disco(width=1024, height=768, spp=8, repeats=3):
    cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=100)
    scene = pt.get_scene("box_mirror", width, height)
    ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    wf = span_renderer(scene, cfg)

    def run(s, i):
        out, stats = wf(s, cfg, i, 0, cfg.spp, with_stats=True)
        return jnp.sum(out), stats["segments"]

    f = jax.jit(run)
    _, seg = f(scene, ids)  # warm-up: compile + one render
    segments = int(seg)
    seconds = median_seconds(lambda: f(scene, ids)[0], repeats)
    return segments / seconds / 1e6, segments, seconds, wf.__name__


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {jax.devices()[0].platform!r}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    mrays, segments, secs, renderer = bench_disco()
    print(json.dumps({
        "metric": "disco_sphere render throughput (1 card, 1024x768, 32 total spp, max_depth 100)",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / BASELINE_MRAYS,
        "detail": {"segments": segments, "seconds_median_of_3": secs,
                   "renderer": renderer, "device": device_record()},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
