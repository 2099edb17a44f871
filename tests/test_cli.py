"""CLI tests (cli.py): the user-facing surface replacing the reference's
single positional arg + recompile workflow (src/main.cpp:199-248)."""

import json

import numpy as np
import pytest

from cpu_path_tracing_tpu.cli import main
from cpu_path_tracing_tpu.utils.image import read_ppm


SMALL = ["--width", "24", "--height", "16", "--spp", "1", "--max-depth", "8"]


def test_render_png(tmp_path, capsys):
    out = str(tmp_path / "img.png")
    assert main(["render", "--scene", "box", *SMALL, "-o", out]) == 0
    data = open(out, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_render_ppm_and_total_spp(tmp_path):
    out = str(tmp_path / "img.ppm")
    # reference semantics: --total-spp 8 -> 2 samples per 2x2 subpixel
    rc = main(
        ["render", "--scene", "box", "--width", "16", "--height", "12",
         "--total-spp", "8", "--max-depth", "8", "-o", out]
    )
    assert rc == 0
    img = read_ppm(out)
    assert img.shape == (12, 16, 3)


def test_render_checkpointed(tmp_path):
    out = str(tmp_path / "img.png")
    ck = str(tmp_path / "ck.npz")
    rc = main(
        ["render", "--scene", "box", *SMALL, "-o", out, "--checkpoint", ck,
         "--flush-every", "1"]
    )
    assert rc == 0
    import numpy as np

    z = np.load(ck)
    assert int(z["spp_done"]) == 1


def test_invert_reports_progress(capsys):
    rc = main(
        ["invert", "--scene", "box", "--width", "8", "--height", "6",
         "--spp", "1", "--max-depth", "6", "--steps", "3",
         "--fields", "albedo", "--perturb", "0.05"]
    )
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    recs = [json.loads(l) for l in lines]
    assert recs and "loss" in recs[0] and "albedo" in recs[0]["mean_abs_err"]


def test_bench_json(capsys):
    rc = main(
        ["bench", "--scene", "box", "--width", "16", "--height", "12",
         "--spp", "1", "--max-depth", "8", "--repeats", "1"]
    )
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["segments"] > 0 and rec["mrays_per_s"] > 0


def test_unknown_scene_rejected():
    with pytest.raises(SystemExit):
        main(["render", "--scene", "nope"])


def test_bench_scaling(tmp_path, capsys):
    """The strong-scaling harness runs on the virtual mesh and writes the
    artifact (a test so it can't rot)."""
    out = str(tmp_path / "scaling.md")
    rc = main(
        ["bench", "--scaling", "--scene", "box", "--width", "16", "--height", "12",
         "--spp", "1", "--max-depth", "6", "--repeats", "1", "--suite-out", out]
    )
    assert rc == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert recs[0]["devices"] == 1 and recs[0]["efficiency_vs_linear"] == 1.0
    assert len(recs) >= 2  # at least 1 and 2 devices on the 8-device mesh
    text = open(out).read()
    assert "efficiency vs linear" in text
    assert "virtual" in text  # cpu-backend caveat present


@pytest.mark.slow
def test_invert_sharded_mesh(capsys):
    """invert --mesh runs the mesh-parallel accumulation step."""
    rc = main(
        ["invert", "--scene", "box", "--width", "8", "--height", "6",
         "--spp", "2", "--max-depth", "6", "--steps", "2", "--mesh", "4x2",
         "--fields", "albedo", "--perturb", "0.05",
         "--cell-chunk", "96", "--sample-chunk", "1"]
    )
    assert rc == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert recs and np.isfinite(recs[-1]["loss"])
