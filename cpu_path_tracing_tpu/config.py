"""Render configuration.

Replacement for the reference's compile-time constants and its
single positional CLI argument (reference: ``src/main.cpp:199-206`` hardcodes
1024x768, 2x2 subpixels; ``src/constants.hpp:7-10`` pins epsilon/inf/depth
limit; scene choice is a compile-time ``#include`` swap at
``src/main.cpp:23-25``).  Here everything is data: a frozen dataclass that is
hashable (usable as a static jit argument) and overridable from the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable; safe to close over in jit).

    Defaults mirror the reference binary: 1024x768, 2x2 subpixels, 1 sample
    per subpixel (== 4 spp total), max depth 100, Russian roulette after
    depth 4 (``src/main.cpp:106,202-206``, ``src/constants.hpp:10``).
    """

    width: int = 1024
    height: int = 768
    # Samples per subpixel cell ("samps" in src/main.cpp:206; total spp is
    # spp * num_subpixels**2).
    spp: int = 1
    num_subpixels: int = 2
    max_depth: int = 100
    rr_depth: int = 4  # roulette kicks in when depth > rr_depth (main.cpp:130)
    seed: int = 0
    # Numerics ---------------------------------------------------------------
    # Intersection epsilon (src/constants.hpp:7) and "infinity" miss sentinel
    # (src/constants.hpp:9).
    epsilon: float = 1e-4
    inf: float = 1e20
    # Execution --------------------------------------------------------------
    # Rays processed per device invocation; the cell grid is chunked to this
    # size.  None = whole image in one batch.
    ray_chunk: Optional[int] = None
    # 'while' = early-exit lax.while_loop (fast forward rendering);
    # 'scan'  = fixed-trip lax.scan (reverse-mode differentiable).
    loop: str = "while"
    # Rematerialize the bounce loop under reverse-mode AD: each lax.scan step
    # is wrapped in jax.checkpoint, so the backward pass stores only the
    # [B]-sized per-bounce carries (not every intersection intermediate) and
    # recomputes the rest.  Cuts activation memory by ~the live-intermediate
    # factor, which is what lets the BASELINE inverse config (box_scene
    # 400x400@64spp, max_depth 100) fit on one chip.  Only affects loop='scan'.
    remat: bool = False
    # 'auto' = render.resolve_integrator decides (the fused GPU kernel on the
    # gpu backend for f32 scenes, the XLA wavefront elsewhere);
    # 'wavefront' = persistent integrator with ray regeneration, XLA loop
    # body (ops/wavefront.py); 'pallas' = the whole render in one fused
    # Pallas kernel for NVIDIA GPUs (ops/pallas/gpu_kernel.py, f32 and
    # uniform jitter only); 'batch' = one launch per sample batch
    # (required for reverse-mode gradients, i.e. loop='scan').
    integrator: str = "auto"
    # Lane-pool width for the wavefront integrator.
    wavefront_lanes: int = 1 << 19
    # Retirement-ring depth K of the wavefront integrators: a lane may run at
    # most K generations ahead of the slowest lane before stalling, so K
    # bounds the tolerable path-length VARIANCE within a generation; the cost
    # is the K x lanes x 3 ring read+write per iteration.  Short-path scenes
    # with long straggler tails (sky-escape scenes: most paths die in 2-3
    # bounces, RR tails run to 60+) want a deep ring; closed boxes with long
    # mean paths are insensitive.  None = auto (see ops/wavefront.py).
    wavefront_ring: Optional[int] = None
    # Progressive checkpointing: flush accumulators every N sample batches
    # (0 = disabled).  See utils/checkpoint.py.
    checkpoint_every: int = 0
    # Subpixel jitter filter: 'uniform' (the reference binary's
    # src/main.cpp:186-190) or 'tent' (the vendored sandbox smallpt's
    # tent filter, sandbox/main.cpp:253-256 — used by the exact-estimator
    # race of scripts/refmatch.py).  'tent' is implemented on the XLA
    # integrators only; integrator='auto' resolves away from the fused
    # kernel for it.
    jitter: str = "uniform"
    # Live-lane compaction schedule for the reverse-differentiable scan
    # (loop='scan' + integrator='batch' only): tuple of (n_steps,
    # capacity_fraction) stages covering max_depth, or None for the plain
    # fixed-width scan.  Built by grad.tune_backward_schedule from a pilot
    # live-curve measurement; cuts the backward pass's dead-lane work ~5x on
    # RR-dominated scenes (ops/integrator.radiance_compact, PERF.md §8).
    compact_schedule: Optional[tuple] = None

    @property
    def total_spp(self) -> int:
        return self.spp * self.num_subpixels * self.num_subpixels

    @property
    def num_cells(self) -> int:
        """Subpixel cells in the image (pixels x subpixels^2)."""
        return self.width * self.height * self.num_subpixels * self.num_subpixels

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
