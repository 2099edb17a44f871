"""Emitter-TOPOLOGY outer search for the two weak goldens.

docs/RECONSTRUCTION.md's residual analysis attributes the remaining
clear_light (MAD 15.6) / greenish_party (21.4) gaps to smooth low-frequency
lighting disagreement and names the one unexplored lever: the NUMBER and
PLACEMENT of emitters, including lights OUTSIDE the visible frustum (behind
the camera, above the ceiling plane) that the image shows only through
indirect transport.  This script pulls that lever: a discrete outer loop
over emitter topologies, each fitted with the round-4 inner coordinate
search (scripts/direct_recon.py: every evaluation is the OFFICIAL
tonemapped-MAD through the full pipeline at >=1024 total spp — the only
objective measured to rank candidates truthfully; see
docs/RECONSTRUCTION.md "what fails").

Topology grammar: the base parametrization of direct_recon.TARGETS plus K
auxiliary emitters, each contributing 5 searchable coordinates
(x, y, z, radius, emission scale) with placement PRIORS seeding them
outside the frustum:

    behind   — behind the camera plane (z ~ camz + 0.5)
    above    — above the ceiling plane (y ~ 0.9), centered
    above2   — a PAIR above the ceiling at +-x (two emitters)
    side     — high side wall pocket (x ~ +-0.55, y ~ 0.3)
    front    — between camera and box mouth, off-axis high

Every topology runs the same budgeted inner search from the same committed
x0 (plus the prior's emitter seed), so the comparison is apples-to-apples;
per-topology JSON state files make the whole sweep resumable after an
interruption.  The winner gets a longer refinement run.

Usage:
  python scripts/topology_recon.py --target greenish_party --rounds 5 \
      --state-dir /tmp/topo_gp [--final-rounds 8] [--out fitted.json]
  python scripts/topology_recon.py --target clear_light ... --report
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.models.io import load_scene
from cpu_path_tracing_tpu.utils.image import tonemap
from direct_recon import GOLDEN_DIR, TARGETS
from reconstruct import load_golden, mad255, pool

# Each auxiliary emitter: (x, y, z, radius, emission) with per-prior seeds.
# z is in scene units (camera ~ +1.5..+2, box mouth ~ +0.1, back wall ~ -1).
# Two measured constraints from the round-5 first sweep (traces in
# /tmp/topo_cl, summarized in docs/RECONSTRUCTION.md):
#  * seeds start NEARLY DARK (e ~ 0.4): a bright seed started ~20 MAD
#    underwater and a 4-round budget never clawed back;
#  * the box walls are SOLID r=1e6 spheres — an emitter past a wall plane
#    (|x|,|y| > 0.4 or z < -1) is entombed and contributes exactly nothing
#    (the 'above'/'side' priors of the first sweep reproduced the base
#    score bit-for-bit).  Usable out-of-frustum space is the box interior
#    near/above the frustum's top edge and the open region behind the
#    camera (the parametrization has no front wall).
AUX_PRIORS = {
    "behind": [(0.0, 0.2, 2.4, 0.4, 0.4)],
    "topnear": [(0.0, 0.33, 1.3, 0.12, 0.4)],
    "toppair": [(-0.28, 0.32, 1.2, 0.1, 0.4), (0.28, 0.32, 1.2, 0.1, 0.4)],
    "ceilmid": [(0.0, 0.36, 0.0, 0.1, 0.4)],
}
AUX_STEP = (0.06, 0.04, 0.12, 0.04, 1.0)
AUX_LO = (-0.38, -0.38, -0.95, 0.03, 0.0)
AUX_HI = (0.38, 0.385, 3.2, 0.6, 120.0)
TOPOLOGIES = ("base", "behind", "topnear", "toppair", "ceilmid")


def build(target: dict, topo: str, x: np.ndarray) -> dict:
    """Scene dict for base params + the topology's auxiliary emitters."""
    nb = len(target["x0"])
    d = target["make"](x[:nb])
    aux = x[nb:].reshape(-1, 5)
    for (ex, ey, ez, er, ee) in aux:
        d["spheres"].append({
            "radius": float(max(er, 0.05)),
            "center": [float(ex), float(ey), float(ez)],
            "emission": [float(max(ee, 0.0))] * 3,
            "albedo": [1.8] * 3, "material": "diffuse",
        })
    return d


def vectors(target: dict, topo: str):
    """(x0, step, lo, hi) for base params + this topology's emitters."""
    x0 = list(target["x0"])
    st = list(target["step"])
    lo = list(target["lo"])
    hi = list(target["hi"])
    for seed in AUX_PRIORS.get(topo, []):
        x0 += list(seed)
        st += list(AUX_STEP)
        lo += list(AUX_LO)
        hi += list(AUX_HI)
    return (np.asarray(x0, np.float64), np.asarray(st, np.float64),
            np.asarray(lo, np.float64), np.asarray(hi, np.float64))


def coordinate_search(evaluate, x, st, lo, hi, rounds, state_path, tag):
    """The direct_recon inner loop, factored for reuse; resumable."""
    if state_path and os.path.exists(state_path):
        d = json.load(open(state_path))
        x, st, best = np.asarray(d["x"]), np.asarray(d["st"]), d["best"]
        done = d.get("rounds_done", 0)
        print(f"[{tag}] resume best {best:.2f} (round {done})", flush=True)
    else:
        best = evaluate(x)
        done = 0
        print(f"[{tag}] init MAD {best:.2f}", flush=True)

    def save():
        if state_path:
            tmp = state_path + ".tmp"
            json.dump({"x": x.tolist(), "st": st.tolist(), "best": best,
                       "rounds_done": done}, open(tmp, "w"))
            os.replace(tmp, state_path)

    save()
    for rnd in range(done, rounds):
        improved = False
        for i in range(len(x)):
            for sgn in (+1, -1):
                xx = x.copy()
                xx[i] = np.clip(x[i] + sgn * st[i], lo[i], hi[i])
                if xx[i] == x[i]:
                    continue
                m = evaluate(xx)
                if m < best - 0.03:
                    best, x, improved = m, xx, True
                    print(f"[{tag}] r{rnd} p{i}{'+' if sgn > 0 else '-'} -> {m:.2f}",
                          flush=True)
                    save()
                    break
        if not improved:
            st = st * 0.6
        done = rnd + 1
        save()
    return x, st, best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True, choices=sorted(TARGETS))
    ap.add_argument("--rounds", type=int, default=5,
                    help="inner-search rounds per topology")
    ap.add_argument("--final-rounds", type=int, default=8,
                    help="extra refinement rounds for the winner")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--total-spp", type=int, default=1024)
    ap.add_argument("--state-dir", required=True)
    ap.add_argument("--topologies", default=",".join(TOPOLOGIES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--report", action="store_true",
                    help="print the per-topology table from state and exit")
    a = ap.parse_args()

    t = TARGETS[a.target]
    os.makedirs(a.state_dir, exist_ok=True)
    topo_list = [s for s in a.topologies.split(",") if s]

    if a.report:
        for topo in topo_list:
            sp = os.path.join(a.state_dir, f"{a.target}_{topo}.json")
            if os.path.exists(sp):
                d = json.load(open(sp))
                print(f"{topo:8s} best={d['best']:.2f} rounds={d.get('rounds_done', 0)}")
        return 0

    gold = pool(load_golden(os.path.join(GOLDEN_DIR, t["golden"])),
                a.height, a.width)
    cfg = pt.RenderConfig(width=a.width, height=a.height,
                          spp=a.total_spp // 4, max_depth=100)
    # PID-unique: two searches sharing a target name must not race on the
    # scratch scene file (observed: concurrent JSON writes -> parse error).
    tmp = f"/tmp/topology_recon_{a.target}_{os.getpid()}.json"

    def make_eval(topo):
        def evaluate(x):
            d = build(t, topo, x)
            json.dump(d, open(tmp, "w"))
            scene = load_scene(tmp, a.width, a.height)
            img = np.asarray(jax.block_until_ready(pt.render_image(scene, cfg)))
            return mad255(tonemap(img).astype(np.float32) / 255.0, gold)
        return evaluate

    results = {}
    for topo in topo_list:
        x0, st, lo, hi = vectors(t, topo)
        sp = os.path.join(a.state_dir, f"{a.target}_{topo}.json")
        _, _, best = coordinate_search(make_eval(topo), x0, st, lo, hi,
                                       a.rounds, sp, f"{a.target}/{topo}")
        results[topo] = best
        print(f"== {a.target}/{topo}: {best:.2f}", flush=True)

    winner = min(results, key=results.get)
    print(f"WINNER {winner} @ {results[winner]:.2f}; refining "
          f"{a.final_rounds} more rounds", flush=True)
    sp = os.path.join(a.state_dir, f"{a.target}_{winner}.json")
    d = json.load(open(sp))
    x, st = np.asarray(d["x"]), np.asarray(d["st"])
    lo, hi = vectors(t, winner)[2:]
    x, st, best = coordinate_search(
        make_eval(winner), x, st, lo, hi,
        d.get("rounds_done", 0) + a.final_rounds, sp, f"{a.target}/{winner}+")
    print(json.dumps({"target": a.target, "results": results,
                      "winner": winner, "final_best": best}), flush=True)
    if a.out:
        json.dump(build(t, winner, x), open(a.out, "w"), indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
