"""Multi-host distributed rendering (SURVEY.md §5.8, parallel/distributed.py).

Real 2-process integration tests: each test launches two OS processes that
join a jax.distributed process group over a local coordinator (Gloo CPU
collectives — the single-machine rehearsal of a multi-host launch) and
render a global tile-sharded image.  Verifies both communication modes:

* replicated mode — one final all-gather, process 0 writes the PNG;
* shard mode     — ZERO cross-host collectives; every process writes its own
  tile shard, process 0 assembles.

Both must be bit-identical to the single-process render.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.render import render_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, DEPTH = 32, 24, 2, 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nprocs: int, extra, tmp_path, expect_rc=None):
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
    )
    base = [
        sys.executable, "-m", "cpu_path_tracing_tpu.cli", "render",
        "--scene", "box", "--width", str(W), "--height", str(H),
        "--spp", str(SPP), "--max-depth", str(DEPTH), "--integrator", "batch",
        "--num-processes", str(nprocs), "--coordinator", f"127.0.0.1:{port}",
        "-o", str(tmp_path / "image.png"),
    ] + extra
    procs = [
        subprocess.Popen(
            base + ["--process-id", str(p)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for p in range(nprocs)
    ]
    expect_rc = expect_rc or {}
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=420)
        want = expect_rc.get(i, 0)
        assert p.returncode == want, f"proc {i} rc={p.returncode} (want {want}):\n{out}\n{err}"


@pytest.fixture(scope="module")
def single_png(tmp_path_factory):
    cfg = pt.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH, integrator="batch")
    scene = pt.get_scene("box", W, H)
    img = render_image(scene, cfg)
    path = tmp_path_factory.mktemp("single") / "image.png"
    pt.write_png(str(path), np.asarray(img))
    return path.read_bytes()


@pytest.mark.slow
def test_two_process_replicated_matches_single(single_png, tmp_path):
    _launch(2, [], tmp_path)
    assert (tmp_path / "image.png").read_bytes() == single_png


@pytest.mark.slow
def test_two_process_shard_mode_matches_single(single_png, tmp_path):
    shard_dir = tmp_path / "shards"
    _launch(2, ["--shard-dir", str(shard_dir)], tmp_path)
    assert (tmp_path / "image.png").read_bytes() == single_png
    names = sorted(os.listdir(shard_dir))
    assert names == ["shard_00000.npz", "shard_00001.npz"]


@pytest.mark.slow
def test_killed_process_recovered_bit_identical(single_png, tmp_path):
    """Elastic recovery (SURVEY §5.3 at the multi-host level): process 1 is
    killed after rendering but BEFORE writing its shard (--inject-shard-loss),
    so its half of the image never reaches disk.  Process 0's file-based wait
    times out, re-renders the missing span locally (keys depend only on
    (seed, cell, sample) — bit-identical on the same backend), and the final
    image must equal the single-process render byte-for-byte."""
    shard_dir = tmp_path / "shards"
    _launch(
        2,
        ["--shard-dir", str(shard_dir), "--inject-shard-loss", "1",
         "--shard-timeout", "3"],
        tmp_path,
        expect_rc={1: 3},
    )
    assert (tmp_path / "image.png").read_bytes() == single_png
    # only process 0's shard ever hit the disk, and process 0 broadcast the
    # host-loss sentinel so other survivors (none here) would clean-exit
    # (the >2-process abort fix).
    assert sorted(os.listdir(shard_dir)) == ["LOST_HOSTS", "shard_00000.npz"]


def test_assemble_recovers_deleted_shard(tmp_path):
    """Unit-level recovery: assemble_shards with scene= re-renders a missing
    span bit-identically (no process launch; covers recover_missing_cells)."""
    from cpu_path_tracing_tpu.parallel.distributed import (
        assemble_shards,
        write_shards,
    )
    from cpu_path_tracing_tpu.render import finalize_image, render_cells_range

    import jax.numpy as jnp

    cfg = pt.RenderConfig(width=8, height=6, spp=2, max_depth=6, integrator="batch")
    scene = pt.get_scene("box", 8, 6)
    n = cfg.num_cells
    ids = jnp.arange(n, dtype=jnp.int32)
    means = np.asarray(render_cells_range(scene, cfg, ids, 0, cfg.spp) / cfg.spp,
                       np.float32)
    ref = np.asarray(finalize_image(jnp.asarray(means), cfg))
    # write only the first half; the second "host" is lost
    write_shards(str(tmp_path), [(0, n // 2, means[: n // 2])], cfg, 0)
    img = np.asarray(assemble_shards(str(tmp_path), cfg, scene=scene))
    np.testing.assert_array_equal(img, ref)


def test_assemble_detects_missing_shard(tmp_path):
    from cpu_path_tracing_tpu.parallel.distributed import assemble_shards, write_shards

    cfg = pt.RenderConfig(width=4, height=2, spp=1)
    n = cfg.num_cells
    half = np.zeros((n // 2, 3), np.float32)
    write_shards(str(tmp_path), [(0, n // 2, half)], cfg, 0)
    with pytest.raises(ValueError, match="missing"):
        assemble_shards(str(tmp_path), cfg)
    write_shards(str(tmp_path), [(n // 2, n, half)], cfg, 1)
    img = assemble_shards(str(tmp_path), cfg)
    assert img.shape == (2, 4, 3)


def test_stale_shards_rejected_by_fingerprint(tmp_path):
    """A stale shard from a previous run (different scene/cfg) in the same
    --shard-dir must neither satisfy the wait nor be assembled:
    before fingerprinting it silently produced a corrupt image."""
    from cpu_path_tracing_tpu.parallel.distributed import (
        assemble_shards, render_fingerprint, wait_for_shards, write_shards)
    from cpu_path_tracing_tpu.render import finalize_image, render_cells_range

    import jax.numpy as jnp

    cfg = pt.RenderConfig(width=8, height=6, spp=2, max_depth=6, integrator="batch")
    scene = pt.get_scene("box", 8, 6)
    fp = render_fingerprint(scene, cfg)
    stale_fp = render_fingerprint(scene, cfg.replace(seed=99))
    assert fp != stale_fp
    n = cfg.num_cells
    ids = jnp.arange(n, dtype=jnp.int32)
    means = np.asarray(render_cells_range(scene, cfg, ids, 0, cfg.spp) / cfg.spp,
                       np.float32)
    ref = np.asarray(finalize_image(jnp.asarray(means), cfg))

    # "host 1" left a stale shard with WRONG data from a previous run
    write_shards(str(tmp_path), [(n // 2, n, np.ones((n - n // 2, 3), np.float32))],
                 cfg, 1, fingerprint=stale_fp)
    write_shards(str(tmp_path), [(0, n // 2, means[: n // 2])], cfg, 0,
                 fingerprint=fp)

    # the wait must see only ONE valid shard (timeout path)
    names = wait_for_shards(str(tmp_path), 2, timeout=0.5, fingerprint=fp)
    assert names == ["shard_00000.npz"]

    # assembly must skip the stale shard and recover the lost span locally
    img = np.asarray(assemble_shards(str(tmp_path), cfg, scene=scene,
                                     fingerprint=fp))
    np.testing.assert_array_equal(img, ref)

    # without a scene, the skipped stale shard surfaces as missing cells
    with pytest.raises(ValueError, match="missing"):
        assemble_shards(str(tmp_path), cfg, fingerprint=fp)


def test_lost_hosts_sentinel_roundtrip(tmp_path):
    from cpu_path_tracing_tpu.parallel.distributed import (
        signal_lost_hosts, wait_all_or_lost)

    assert wait_all_or_lost(str(tmp_path), 2, timeout=0.3) == "timeout"
    signal_lost_hosts(str(tmp_path))
    assert wait_all_or_lost(str(tmp_path), 2, timeout=0.3) == "lost"
