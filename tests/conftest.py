"""Test configuration.

Tests run on CPU with 8 virtual devices (the standard way to exercise
shard_map/mesh code without a pod — SURVEY.md §4e) and with x64 enabled so
the float64 oracle path is available alongside the float32 production path.
Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the fast tier is compile-bound (pallas
# interpret kernels, f64 AD scans), and entries are keyed by HLO hash, so
# warm `scripts/precommit.sh` runs skip straight to execution.  Shared
# across xdist workers; safe to delete at any time.  JAX_COMPILATION_CACHE_DIR
# wins when set; the entry points this suite calls then defer to it as well.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), ".jax_cache"))
jax.config.update("jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def f32():
    return jnp.float32


@pytest.fixture(scope="session")
def f64():
    return jnp.float64
