"""Golden-image reconstruction search.

The reference ships six golden renders (``/root/reference/samples``) but only
three scene sources survive — the scene headers were edited in place over the
project's history (SURVEY.md §4), so ``depth_of_field.png``,
``new_camera.png``, ``clear_light.png`` and ``greenish_party.png`` have no
source.  This tool parameterizes a candidate scene per golden (forensics in
each builder's docstring) and grid-sweeps the unknown knobs, scoring with
``reconstruct.score`` (tonemapped, pooled MAD/255).

IMPORTANT: the reference's per-subpixel clamp (``src/main.cpp:195-196``)
makes rendered brightness spp-DEPENDENT for surfaces lit by small bright
lights (a 1-sample cell that hits a 30-emitter clamps to 1; a converged cell
doesn't) — honest scoring therefore needs high spp (>=256), which is cheap on
an accelerator and prohibitive on CPU.  Run sweeps on a GPU.

Usage:
    python scripts/recon_search.py --target dof --sweep        # grid sweep
    python scripts/recon_search.py --target dof \
        --params '{"aperture":0.6}' --spp 512 --out /tmp/c.png # single eval
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

import numpy as np

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.models.camera import CameraConfig
from cpu_path_tracing_tpu.models.scene import (
    BLACK_BACKGROUND,
    DIELECTRIC,
    DIFFUSE,
    SPECULAR,
    scene_from_spheres,
)
from reconstruct import score

GOLDEN_DIR = "/root/reference/samples"

# The surviving simple_scene sphere data (src/simple_scene.hpp:18-42).
SIMPLE_SPHERES = [
    (100.0, (0.0, -100.5, -1.0), (0.0, 0.0, 0.0), (0.8, 0.8, 0.0), DIFFUSE),
    (0.5, (1.0, 0.0, -1.0), (0.0, 0.0, 0.0), (0.999, 0.999, 0.999), SPECULAR),
    (0.5, (-1.0, 0.0, -1.0), (0.0, 0.0, 0.0), (0.999, 0.999, 0.999), DIELECTRIC),
    (0.5, (0.0, 0.0, -1.0), (0.1, 0.1, 0.9), (0.0, 0.7, 0.1), DIFFUSE),
    (1.0, (1.0, 3.1, -1.0), (30.0, 30.0, 30.0), (0.0, 0.0, 0.0), DIFFUSE),
]

BIG, OFF, Z = 1e6, 0.4, -1.0


def _box_walls(albedos):
    """Five giant wall spheres in the box_scene layout
    (src/box_scene.hpp:23-47); ``albedos`` = (left, right, back, top, bottom)."""
    la, ra, ba, ta, fa = albedos
    return [
        (BIG, (-BIG - OFF, 0.0, Z), (0, 0, 0), la, DIFFUSE),
        (BIG, (BIG + OFF, 0.0, Z), (0, 0, 0), ra, DIFFUSE),
        (BIG, (0.0, 0.0, Z - BIG), (0, 0, 0), ba, DIFFUSE),
        (BIG, (0.0, BIG + OFF, Z), (0, 0, 0), ta, DIFFUSE),
        (BIG, (0.0, -BIG - OFF, Z), (0, 0, 0), fa, DIFFUSE),
    ]


def build_new_camera(width, height, *, aperture=0.2, vfov=1.2):
    """new_camera.png: the surviving simple_scene data rendered with a BLACK
    background (the golden's sky is pure black — it predates the sky
    gradient of src/main.cpp:116-119).  Camera == src/simple_scene.hpp:44-49.
    """
    cam = CameraConfig.make(position=(-2.0, 2.0, 1.0), look_at=(0.0, 0.0, -1.0),
                            aspect_ratio=width / height,
                            vertical_fov_radians=vfov, aperture=aperture)
    return scene_from_spheres(SIMPLE_SPHERES, cam, background=BLACK_BACKGROUND)


def build_dof(width, height, *, aperture=0.6, focus_scale=1.0, vfov=1.2):
    """depth_of_field.png: the same scene as new_camera.png with a wide
    aperture (the foreground glass sphere is strongly defocused, the emitter
    nearly in focus).  focus_scale multiplies the default focus distance
    |position - look_at| = 3.46."""
    pos, look = np.array([-2.0, 2.0, 1.0]), np.array([0.0, 0.0, -1.0])
    cam = CameraConfig.make(position=tuple(pos), look_at=tuple(look),
                            aspect_ratio=width / height,
                            vertical_fov_radians=vfov, aperture=aperture,
                            focus_distance=float(np.linalg.norm(pos - look)) * focus_scale)
    return scene_from_spheres(SIMPLE_SPHERES, cam, background=BLACK_BACKGROUND)


def build_clear_light(width, height, *, light_r=0.2, light_y=0.05, light_z=-1.15,
                      light_e=6.0, vfov=0.55, mag=(0.85, 0.2, 0.85),
                      mirror_x=-0.18, mag_x=0.1, glass_x=0.25, glass_r=0.2,
                      ceiling=(0.1, 0.7, 0.2), side_sat=1.0,
                      mr=0.15, mirror_z=0.45, mag_z=0.2, glass_z=0.65, cam_z=2.0):
    """clear_light.png: box geometry with WHITE back+floor, GREEN ceiling,
    red/blue side walls; a big white emitter ball floating mid-room before
    the back wall; mirror / magenta-specular / glass balls on the floor.
    ``side_sat`` blends the side-wall albedos toward white (the golden's
    walls are pastel — either heavily cross-lit or intrinsically desaturated)."""
    def desat(c):
        return tuple(s * x + (1.0 - s) * 0.8 for x, s in zip(c, (side_sat,) * 3))
    walls = _box_walls((
        desat((0.9, 0.1, 0.2)), desat((0.3, 0.1, 0.9)), (0.9, 0.9, 0.9),
        tuple(ceiling), (0.9, 0.9, 0.9),
    ))
    spheres = walls + [
        (light_r, (0.0, light_y, light_z), (light_e,) * 3, (1.0, 1.0, 1.0), DIFFUSE),
        (mr, (mirror_x, -OFF + mr, Z + mirror_z), (0, 0, 0), (1.0, 1.0, 1.0), SPECULAR),
        (mr, (mag_x, -OFF + mr, Z + mag_z), (0, 0, 0), mag, SPECULAR),
        (glass_r, (glass_x, -OFF + glass_r, Z + glass_z), (0, 0, 0), (1.0, 1.0, 1.0), DIELECTRIC),
    ]
    cam = CameraConfig.make(position=(0.0, 0.0, cam_z), look_at=(0.0, 0.0, Z + OFF * 1.5),
                            aspect_ratio=width / height,
                            vertical_fov_radians=vfov, aperture=0.0)
    return scene_from_spheres(spheres, cam, anchor_toward=(0.0, 0.0, Z + OFF * 1.5),
                              background=BLACK_BACKGROUND)


def build_greenish_party(width, height, *, light_r=6.0, cap=0.04, light_e=8.0,
                         vfov=0.55, mirror_x=-0.15, glass_x=0.2, ball_r=0.18,
                         light_z=Z, tint=(1.0, 1.0, 1.0),
                         ceiling=(0.3, 0.7, 0.2), ceiling_e=(0.0, 0.0, 0.0)):
    """greenish_party.png: the box_scene wall albedos (red left, blue right,
    green back, green top, white floor — src/box_scene.hpp:23-47) with a
    huge white emitter sphere ABOVE the ceiling poking a shallow cap through
    it (the elliptical white patch), which floods the room green via the
    bright-lit green ceiling; mirror + glass balls on the floor."""
    walls = _box_walls((
        (0.9, 0.1, 0.2), (0.3, 0.1, 0.9), (0.1, 0.7, 0.2),
        tuple(ceiling), (0.9, 0.9, 0.9),
    ))
    if any(ceiling_e):
        # emissive-ceiling hypothesis: the golden's green flood may come from
        # the ceiling itself glowing (a seed here unlocks the fit_golden
        # emission mask for the ceiling wall)
        r, c, _, alb, m = walls[3]
        walls[3] = (r, c, tuple(ceiling_e), alb, m)
    emission = tuple(light_e * t for t in tint)
    spheres = walls + [
        (light_r, (0.0, OFF + light_r - cap, light_z), emission, (1.0, 1.0, 1.0), DIFFUSE),
        (ball_r, (mirror_x, -OFF + ball_r, Z + 0.35), (0, 0, 0), (1.0, 1.0, 1.0), SPECULAR),
        (ball_r, (glass_x, -OFF + ball_r, Z + 0.6), (0, 0, 0), (1.0, 1.0, 1.0), DIELECTRIC),
    ]
    cam = CameraConfig.make(position=(0.0, 0.0, 2.0), look_at=(0.0, 0.0, Z + OFF * 1.5),
                            aspect_ratio=width / height,
                            vertical_fov_radians=vfov, aperture=0.0)
    return scene_from_spheres(spheres, cam, anchor_toward=(0.0, 0.0, Z + OFF * 1.5),
                              background=BLACK_BACKGROUND)


TARGETS = {
    "new_camera": (build_new_camera, "new_camera.png"),
    "dof": (build_dof, "depth_of_field.png"),
    "clear_light": (build_clear_light, "clear_light.png"),
    "greenish_party": (build_greenish_party, "greenish_party.png"),
}

# Coarse sweep grids per target (refine by hand from the JSON output).
SWEEPS = {
    "new_camera": {"aperture": [0.2], "vfov": [1.2]},
    # stage-2 refinement around the stage-1 winners (run history in git:
    # stage-1 best dof 3.23 @ (0.6, 1.0); cl 27.1 @ (30, 0.2, 0.5);
    # gp 56.6 @ (0.004, 20, 0.5) — both cl/gp show a green deficit.)
    "dof2": {"aperture": [0.45, 0.55, 0.6, 0.65, 0.75],
             "focus_scale": [0.95, 1.0, 1.05]},
    "cl2": {"light_y": [0.05, 0.15, 0.25], "light_z": [-1.3, -1.15, -1.0],
            "ceiling": [[0.1, 0.7, 0.2], [0.3, 0.7, 0.2]]},
    "gp2": {"cap": [0.003, 0.004, 0.006], "light_e": [15.0, 20.0, 30.0],
            "tint": [[1.0, 1.0, 1.0], [0.85, 1.0, 0.7], [0.7, 1.0, 0.5]]},
    "dof": {"aperture": [0.3, 0.6, 0.9, 1.2], "focus_scale": [0.85, 1.0, 1.15]},
    # cl: golden walls are BRIGHT pastels (mean ~103/255) — wall flux scales
    # ~light_e*r^2; CPU probe at e=6,r=0.2 gave mean ~37 -> need ~6-10x.
    "clear_light": {"light_e": [15.0, 30.0, 60.0], "light_r": [0.2, 0.25, 0.3],
                    "vfov": [0.5, 0.55, 0.62]},
    # gp: the ceiling patch is a sphere cap of radius a=sqrt(2*R*cap); the
    # golden patch is ~0.22 half-width (1/4 of the 0.8 ceiling) -> cap ~
    # a^2/(2R) ~ 0.004 at R=6, NOT the 0.02-0.1 the CPU probe ruled out
    # (cap=0.04 floods the whole ceiling white).
    "greenish_party": {"light_e": [10.0, 20.0, 40.0], "cap": [0.002, 0.004, 0.008],
                       "vfov": [0.5, 0.55, 0.62]},
}


def render(scene, width, height, spp, max_depth):
    cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=max_depth)
    return np.asarray(jax.block_until_ready(pt.render_image(scene, cfg)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True, choices=sorted(TARGETS))
    ap.add_argument("--params", default="{}", help="JSON kwargs for the builder")
    ap.add_argument("--sweep", action="store_true", help="run the coarse grid")
    ap.add_argument("--grid", default=None,
                    help="SWEEPS key to use (default: the target name); "
                         "e.g. --target dof --grid dof2 for stage-2 refinement")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--max-depth", type=int, default=100)
    ap.add_argument("--out", default=None, help="write the candidate PNG here")
    a = ap.parse_args()

    build, golden = TARGETS[a.target]
    golden = os.path.join(GOLDEN_DIR, golden)
    base = json.loads(a.params)

    if a.sweep:
        grid = SWEEPS[a.grid or a.target]
        keys = sorted(grid)
        best = None
        for combo in itertools.product(*(grid[k] for k in keys)):
            p = dict(base, **dict(zip(keys, combo)))
            t0 = time.perf_counter()
            img = render(build(a.width, a.height, **p), a.width, a.height,
                         a.spp, a.max_depth)
            s = score(img, golden)
            rec = {"target": a.target, **p, **s,
                   "seconds": round(time.perf_counter() - t0, 1)}
            print(json.dumps(rec), flush=True)
            if best is None or s["mad255"] < best[0]:
                best = (s["mad255"], p)
        print(f"# best: mad255={best[0]} params={json.dumps(best[1])}",
              file=sys.stderr)
        return 0

    img = render(build(a.width, a.height, **base), a.width, a.height,
                 a.spp, a.max_depth)
    s = score(img, golden)
    print(json.dumps({"target": a.target, **base, **s}))
    if a.out:
        pt.write_png(a.out, img)
        print(f"wrote {a.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
