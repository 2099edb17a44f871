"""Persistent XLA compilation cache for the program's entry points.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and this
module leaves it alone.  Otherwise the cache goes to one fixed directory
inside the checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): the
path is part of what a cache entry is found by, so it must not move between
runs.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
