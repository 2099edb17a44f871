"""Fused path-tracing kernel for NVIDIA GPUs (Pallas, Triton route).

The whole forward render of a cell span runs inside one ``pallas_call``:
one lane per thread, the lane's path state in registers, and the
regeneration / bounce loop inside the kernel.  Per bounce a lane does

  regeneration (next item + Threefry item keys + thin-lens camera ray)
  -> bounce RNG (Threefry-2x32, the exact ops/rng.py cipher, so the
     uniforms are bit-identical to the XLA integrators')
  -> unrolled sphere intersection (anchor-point stable quadratic, running
     min with lowest-index ties; the hit sphere's properties are selected
     sphere by sphere, so there is no [B,N] array and no gather)
  -> shading: sky miss, emission, Russian roulette and the three material
     samplers blended by one-hot masks
  -> on retirement, a masked store of the item's radiance at its item index.

Work assignment: a 1-D grid of P programs, each holding a tile of L lanes.
Program p at generation g takes items ``(g*P + p)*L + lane``, so programs
share nothing and each loops until its own item stripe is done.  Per-program
segment counts go out as a [P] array.

The math matches ops/integrator.bounce_step + ops/wavefront.py expression
for expression (component chains, hoisted reciprocals, one-product lerps —
see ops/intersect.py), so in interpret mode on the CPU the kernel is bitwise
equal to ``render_wavefront`` except on sky-miss lanes, whose fma grouping is
the compiler's choice (tests/test_gpu_kernel.py).  On the GPU, Triton and
XLA contract floating-point operations differently, so a small share of
paths takes the other side of a discrete decision and decorrelates; the
two-tier gate in chip_smoke.py holds the kernel to the XLA wavefront.

Reference semantics cited inline map to src/main.cpp:104-158 (radiance loop),
src/camera.cpp:32-38 (thin lens), src/sphere.cpp:6-30 (roots).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...config import RenderConfig
from ...models.camera import build_camera
from ...models.scene import Scene
from ..rng import master_key, threefry2x32

_INF = 1e20
# Lanes per program: one lane per thread of NUM_WARPS warps.  Programs in
# the grid (at most): 16 per SM of an H100's 132, so every SM keeps several
# lane tiles in flight while others wait on memory.  Chosen on the H100 from
# a sweep of (lanes, warps, programs) on disco_sphere and random_spheres at
# 1024x768 (PERF.md): this shape had the lowest summed time.
LANES = 128
NUM_WARPS = 4
PROGRAMS = 132 * 16
# Spheres per unrolled block of the intersect.  Scenes with fewer than
# 2*SPHERE_BLOCK spheres are unrolled in full; larger ones loop over blocks,
# because Triton's compile time grows with the unrolled code (minutes for
# the 531-sphere scene unrolled in full, measured on the H100).
SPHERE_BLOCK = 8

# Per-lane float state; the int state is alive/depth/gen and the uint32
# item key k0/k1.
F32_STATE = (
    "ox", "oy", "oz",        # origin
    "dx", "dy", "dz",        # direction
    "thx", "thy", "thz",     # throughput
    "emx", "emy", "emz",     # accumulated emission
    "rsx", "rsy", "rsz",     # result
)


def pack_scene(scene: Scene):
    """Scene -> [N,17] f32 table read by the kernel as scalars.

    Columns 0..6 feed the intersect loop: p0(3) anchor(3) radius(1)
    (anchor-point stable quadratic).  Columns 7..16 are the running-select
    payload: center(3) emission(3) albedo(3) mat_code(1) (center-form normal
    and material code; see ops/intersect.py sphere_props)."""
    ad = jax.lax.stop_gradient(scene.anchor_dir)
    p0 = scene.p0.astype(jnp.float32)
    rad = scene.radius.astype(jnp.float32)
    adf = ad.astype(jnp.float32)
    center = p0 - rad[:, None] * adf  # identical chain to sphere_props
    return jnp.concatenate(
        [
            p0,
            adf,
            rad[:, None],
            center,
            scene.emission.astype(jnp.float32),
            scene.albedo.astype(jnp.float32),
            scene.material.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )


def pack_camera(scene: Scene):
    """Camera frame + background -> [20] f32: pos(3) llc(3) cam_x(3)
    cam_y(3) lens_radius(1) bg_bottom(3) bg_top(3) origin_advance(1)."""
    cam = build_camera(scene.camera)
    return jnp.concatenate(
        [
            cam.position.astype(jnp.float32),
            cam.lower_left.astype(jnp.float32),
            cam.cam_x.astype(jnp.float32),
            cam.cam_y.astype(jnp.float32),
            cam.lens_radius.astype(jnp.float32)[None],
            scene.background.astype(jnp.float32).reshape(6),
            cam.origin_advance.astype(jnp.float32)[None],
        ]
    )


def _u01(bits):
    # The top-24-bit value fits int32 exactly: reinterpret and convert from
    # there (a signed convert; bit-identical to ops/rng.py's uniforms).
    i32 = jax.lax.bitcast_convert_type(bits >> jnp.uint32(8), jnp.int32)
    return i32.astype(jnp.float32) * np.float32(2.0**-24)


def _rsqrt_safe(x):
    return jax.lax.rsqrt(jnp.where(x > 0, x, 1.0))


def _sqrt_safe(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def make_step(cfg: RenderConfig, *, n_spheres: int, n_cells: int,
              n_items: int, stride: int, ior: float = 2.0):
    """One bounce of every lane of a tile as pure array math over the SoA
    state dict: regeneration -> bounce RNG -> unrolled intersect -> shade ->
    alive/result update.

    ``stride`` is the number of lanes in the whole grid (P*L): a lane whose
    global index is ``lane_global`` takes item ``gen*stride + lane_global``
    at generation ``gen``.

    Returns ``step(s, table_ref, cam_ref, cell_start, sample_start,
    lane_global) -> (s', was_alive, finished)``."""
    W, H, ns = cfg.width, cfg.height, cfg.num_subpixels
    total_cells = W * H * ns * ns
    sub_len = np.float32(1.0 / ns)
    eps = np.float32(cfg.epsilon)
    s0_key, s1_key = master_key(cfg.seed)
    max_depth = cfg.max_depth
    rr_depth = cfg.rr_depth

    def step(s, table_ref, cam_ref, cell_start, sample_start, lane_global):
        alive = s["alive"] != 0

        # ---------------- regeneration (next item + camera) ----------------
        want_g = s["gen"] + 1
        item = want_g * stride + lane_global
        real = (~alive) & (item < n_items)

        c_idx = item % n_cells
        smp = jax.lax.bitcast_convert_type(sample_start + item // n_cells, jnp.uint32)
        cell = jnp.minimum(cell_start + c_idx, total_cells - 1)

        a0, a1 = threefry2x32(jnp.uint32(s0_key), jnp.uint32(s1_key),
                              jax.lax.bitcast_convert_type(cell, jnp.uint32), smp)
        # Jitter from the item-key words themselves; one cipher block for the
        # lens-disk pair (rng.camera_uniforms — must stay in lockstep).
        c0, c1 = threefry2x32(a0, a1, jnp.uint32(0) * a0, jnp.uint32(0) * a0)
        jx, jy, du1, du2 = _u01(a0), _u01(a1), _u01(c0), _u01(c1)

        # decode cell -> (x, y, sx, sy); src/main.cpp:186-190 jitter
        sub = cell % (ns * ns)
        pix = cell // (ns * ns)
        px = (pix % W).astype(jnp.float32)
        py = (pix // W).astype(jnp.float32)
        sxf = (sub % ns).astype(jnp.float32)
        syf = (sub // ns).astype(jnp.float32)
        scr_s = (px + sxf * sub_len + jx * sub_len) * np.float32(1.0 / W)
        scr_t = (py + syf * sub_len + jy * sub_len) * np.float32(1.0 / H)

        # thin lens (src/camera.cpp:32-38; polar disk sample)
        lens_r = cam_ref[12]
        rr_ = jnp.sqrt(du1) * lens_r
        th_ = np.float32(2.0 * math.pi) * du2
        rdx = rr_ * jnp.cos(th_)
        rdy = rr_ * jnp.sin(th_)
        st_sum = scr_s + scr_t
        offx, offy = rdx * st_sum, rdy * st_sum  # quirk: rd*(s+t)
        n_dx = cam_ref[3] + cam_ref[6] * scr_s + cam_ref[9] * scr_t - cam_ref[0] - offx
        n_dy = cam_ref[4] + cam_ref[7] * scr_s + cam_ref[10] * scr_t - cam_ref[1] - offy
        n_dz = cam_ref[5] + cam_ref[8] * scr_s + cam_ref[11] * scr_t - cam_ref[2]
        # Near-clip advance along the unnormalized direction (cam slot 19;
        # sandbox/main.cpp:261 ``cam.o + d*140``; 0 for the src/ camera).
        adv = cam_ref[19]
        n_ox = cam_ref[0] + offx + adv * n_dx
        n_oy = cam_ref[1] + offy + adv * n_dy
        n_oz = cam_ref[2] + adv * n_dz

        def merge(a, b):
            return jnp.where(real, a, b)

        s["ox"] = merge(n_ox, s["ox"])
        s["oy"] = merge(n_oy, s["oy"])
        s["oz"] = merge(n_oz, s["oz"])
        s["dx"] = merge(n_dx, s["dx"])
        s["dy"] = merge(n_dy, s["dy"])
        s["dz"] = merge(n_dz, s["dz"])
        for nme in ("thx", "thy", "thz"):
            s[nme] = merge(jnp.ones_like(s[nme]), s[nme])
        for nme in ("emx", "emy", "emz", "rsx", "rsy", "rsz"):
            s[nme] = merge(jnp.zeros_like(s[nme]), s[nme])
        s["depth"] = merge(jnp.zeros_like(s["depth"]), s["depth"])
        s["gen"] = merge(want_g, s["gen"])
        s["k0"] = merge(a0, s["k0"])
        s["k1"] = merge(a1, s["k1"])
        was_alive = alive | real

        # ---------------- bounce uniforms (ops/rng.py layout) ---------------
        purpose = jax.lax.bitcast_convert_type(s["depth"] + 1, jnp.uint32)
        b0, b1 = threefry2x32(s["k0"], s["k1"], purpose, purpose * jnp.uint32(0))
        # b3 is the reserved u_c word (ops/rng.py draw-layout docstring).
        b2, _b3 = threefry2x32(s["k0"], s["k1"], purpose, purpose * jnp.uint32(0) + jnp.uint32(1))
        u_rr, u_a, u_b = _u01(b0), _u01(b1), _u01(b2)

        ox, oy, oz = s["ox"], s["oy"], s["oz"]
        dx, dy, dz = s["dx"], s["dy"], s["dz"]

        # ---------------- intersect: unrolled over the spheres ---------------
        # (src/sphere.cpp:6-30 roots; src/main.cpp:30-42 nearest, lowest index)
        a_quad = dx * dx + dy * dy + dz * dz
        # Hoisted reciprocal: one divide per lane, not per (lane, sphere).
        # Mirrored in ops/intersect.py.
        a_inv = 1.0 / a_quad

        def sphere(j, carry):
            t_best, sel = carry
            p0x, p0y, p0z = table_ref[j, 0], table_ref[j, 1], table_ref[j, 2]
            adx, ady, adz = table_ref[j, 3], table_ref[j, 4], table_ref[j, 5]
            rad = table_ref[j, 6]
            qx, qy, qz = ox - p0x, oy - p0y, oz - p0z
            qd = qx * dx + qy * dy + qz * dz
            add_ = adx * dx + ady * dy + adz * dz
            b_quad = qd + rad * add_
            qq = qx * qx + qy * qy + qz * qz
            qad = qx * adx + qy * ady + qz * adz
            c_quad = qq + 2.0 * rad * qad
            disc = b_quad * b_quad - a_quad * c_quad
            has_root = disc >= 0.0
            sq = jnp.sqrt(jnp.where(has_root, disc, 1.0))
            sgn = jnp.where(b_quad >= 0.0, 1.0, -1.0)
            qf = -(b_quad + sgn * sq)
            r1 = qf * a_inv
            r2 = jnp.where(qf != 0.0, c_quad / jnp.where(qf != 0.0, qf, 1.0), _INF)
            tn = jnp.minimum(r1, r2)
            tf_ = jnp.maximum(r1, r2)
            root = jnp.where(tn >= eps, tn, jnp.where(tf_ >= eps, tf_, _INF))
            root = jnp.where(has_root, root, _INF)
            better = root < t_best  # strict: first (lowest) index wins ties
            t_best = jnp.where(better, root, t_best)
            sel = tuple(jnp.where(better, table_ref[j, 7 + c], sel[c]) for c in range(10))
            return t_best, sel

        def block(k, carry):
            for u in range(SPHERE_BLOCK):
                carry = sphere(k * SPHERE_BLOCK + u, carry)
            return carry

        # selected sphere properties (10 columns: table 7..16)
        carry = (jnp.full_like(ox, _INF), tuple(jnp.zeros_like(ox) for _ in range(10)))
        n_blocks = n_spheres // SPHERE_BLOCK if n_spheres >= 2 * SPHERE_BLOCK else 0
        if n_blocks:
            carry = jax.lax.fori_loop(0, n_blocks, block, carry)
        for j in range(n_blocks * SPHERE_BLOCK, n_spheres):
            carry = sphere(j, carry)
        t_best, sel = carry
        hit = t_best < _INF

        (cx_, cy_, cz_, ehx, ehy, ehz, alx, aly, alz, mcode) = sel
        # Material one-hot from the single selected code (0/1/2): exact
        # 0.0/1.0 masks, value-identical to gathering one-hot columns.
        m_dif = jnp.where(mcode < 0.5, 1.0, 0.0)
        m_spe = jnp.where((mcode > 0.5) & (mcode < 1.5), 1.0, 0.0)
        m_die = jnp.where(mcode > 1.5, 1.0, 0.0)

        # ------- miss: scene background gradient (src/main.cpp:115-120) ------
        dinv = _rsqrt_safe(a_quad)
        # (dy*dinv)*0.5 + 0.5: x*0.5 is exact, so any fma grouping of this
        # form rounds identically.
        sky_t = (dy * dinv) * 0.5 + 0.5
        # Lerp form bg0 + t*(bg1-bg0), algebraically equal to the reference's
        # (1-t)*bottom + t*top (src/main.cpp:116-119) but with only one
        # product, so there is no fma grouping to disagree on.
        skyx = cam_ref[13] + sky_t * (cam_ref[16] - cam_ref[13])
        skyy = cam_ref[14] + sky_t * (cam_ref[17] - cam_ref[14])
        skyz = cam_ref[15] + sky_t * (cam_ref[18] - cam_ref[15])
        die_miss = was_alive & ~hit
        s["rsx"] = jnp.where(die_miss, s["emx"] + s["thx"] * skyx, s["rsx"])
        s["rsy"] = jnp.where(die_miss, s["emy"] + s["thy"] * skyy, s["rsy"])
        s["rsz"] = jnp.where(die_miss, s["emz"] + s["thz"] * skyz, s["rsz"])

        # ---------------- hit record --------------------------------------
        t_safe = jnp.where(hit, t_best, 1.0)
        hx = ox + t_safe * dx
        hy = oy + t_safe * dy
        hz = oz + t_safe * dz
        # Outward normal = normalized (h - center); the 1/r scale is
        # absorbed by the normalization (ops/intersect.py hit_record).
        nrx = hx - cx_
        nry = hy - cy_
        nrz = hz - cz_
        ninv = _rsqrt_safe(nrx * nrx + nry * nry + nrz * nrz)
        nox_ = nrx * ninv
        noy_ = nry * ninv
        noz_ = nrz * ninv
        ndotd = nox_ * dx + noy_ * dy + noz_ * dz
        front = ndotd < 0.0
        fsign = jnp.where(front, 1.0, -1.0)
        nx_ = nox_ * fsign
        ny_ = noy_ * fsign
        nz_ = noz_ * fsign

        emnx = s["emx"] + s["thx"] * ehx  # src/main.cpp:126
        emny = s["emy"] + s["thy"] * ehy
        emnz = s["emz"] + s["thz"] * ehz

        # ---------------- Russian roulette (src/main.cpp:128-137) -----------
        pmax = jnp.maximum(alx, jnp.maximum(aly, alz))
        p_inv = 1.0 / jnp.where(pmax > 0.0, pmax, 1.0)
        do_rr = s["depth"] > rr_depth
        survive = u_rr < pmax
        killed = do_rr & ~survive
        colf = jnp.where(do_rr & survive, p_inv, 1.0)
        die_rr = was_alive & hit & killed
        s["rsx"] = jnp.where(die_rr, emnx, s["rsx"])
        s["rsy"] = jnp.where(die_rr, emny, s["rsy"])
        s["rsz"] = jnp.where(die_rr, emnz, s["rsz"])
        thnx = s["thx"] * alx * colf
        thny = s["thy"] * aly * colf
        thnz = s["thz"] * alz * colf

        # ---------------- diffuse (src/main.cpp:44-58) ----------------------
        phi = np.float32(2.0 * math.pi) * u_a
        sin_t = jnp.sqrt(u_b)
        cos_t = _sqrt_safe(1.0 - u_b)
        ax_y = jnp.abs(nx_) > 0.1
        # cross(axis, w) for axis = (0,1,0) vs (1,0,0)
        ux_r = jnp.where(ax_y, nz_, jnp.zeros_like(nz_))
        uy_r = jnp.where(ax_y, jnp.zeros_like(nz_), -nz_)
        uz_r = jnp.where(ax_y, -nx_, ny_)
        uinv = _rsqrt_safe(ux_r * ux_r + uy_r * uy_r + uz_r * uz_r)
        ux_, uy_, uz_ = ux_r * uinv, uy_r * uinv, uz_r * uinv
        vx_ = ny_ * uz_ - nz_ * uy_
        vy_ = nz_ * ux_ - nx_ * uz_
        vz_ = nx_ * uy_ - ny_ * ux_
        cp, sp_ = jnp.cos(phi), jnp.sin(phi)
        ddx = ux_ * cp * sin_t + vx_ * sp_ * sin_t + nx_ * cos_t
        ddy = uy_ * cp * sin_t + vy_ * sp_ * sin_t + ny_ * cos_t
        ddz = uz_ * cp * sin_t + vz_ * sp_ * sin_t + nz_ * cos_t
        dinv2 = _rsqrt_safe(ddx * ddx + ddy * ddy + ddz * ddz)
        ddx, ddy, ddz = ddx * dinv2, ddy * dinv2, ddz * dinv2

        # ---------------- specular (src/main.cpp:60-67) ---------------------
        spx = dx - 2.0 * nox_ * ndotd
        spy = dy - 2.0 * noy_ * ndotd
        spz = dz - 2.0 * noz_ * ndotd

        # ---------------- dielectric (src/main.cpp:69-97) -------------------
        ratio = jnp.where(front, np.float32(1.0 / ior), np.float32(ior))
        udx, udy, udz = dx * dinv, dy * dinv, dz * dinv
        cos_d = jnp.minimum(-(udx * nx_ + udy * ny_ + udz * nz_), 1.0)
        sin_d = _sqrt_safe(1.0 - cos_d * cos_d)
        cannot = ratio * sin_d > 1.0
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        mm = jnp.maximum(1.0 - cos_d, 0.0)
        reflprob = r0 + (1.0 - r0) * (mm * mm * mm * mm * mm)
        refl = cannot | (reflprob > u_a)
        ppx = (udx + nx_ * cos_d) * ratio
        ppy = (udy + ny_ * cos_d) * ratio
        ppz = (udz + nz_ * cos_d) * ratio
        kk = jnp.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))
        neg_sqrt_k = -jnp.sqrt(kk)
        dlx = jnp.where(refl, spx, ppx + nx_ * neg_sqrt_k)
        dly = jnp.where(refl, spy, ppy + ny_ * neg_sqrt_k)
        dlz = jnp.where(refl, spz, ppz + nz_ * neg_sqrt_k)

        # ---------------- blend + state update (src/main.cpp:141-154) -------
        dnx = m_dif * ddx + m_spe * spx + m_die * dlx
        dny = m_dif * ddy + m_spe * spy + m_die * dly
        dnz = m_dif * ddz + m_spe * spz + m_die * dlz

        cont = was_alive & hit & ~killed
        s["ox"] = jnp.where(cont, hx, s["ox"])
        s["oy"] = jnp.where(cont, hy, s["oy"])
        s["oz"] = jnp.where(cont, hz, s["oz"])
        s["dx"] = jnp.where(cont, dnx, s["dx"])
        s["dy"] = jnp.where(cont, dny, s["dy"])
        s["dz"] = jnp.where(cont, dnz, s["dz"])
        s["thx"] = jnp.where(cont, thnx, s["thx"])
        s["thy"] = jnp.where(cont, thny, s["thy"])
        s["thz"] = jnp.where(cont, thnz, s["thz"])
        upd_em = was_alive & hit
        s["emx"] = jnp.where(upd_em, emnx, s["emx"])
        s["emy"] = jnp.where(upd_em, emny, s["emy"])
        s["emz"] = jnp.where(upd_em, emnz, s["emz"])

        depth_new = jnp.where(was_alive, s["depth"] + 1, s["depth"])
        exhausted = cont & (depth_new >= max_depth)
        s["rsx"] = jnp.where(exhausted, s["emx"], s["rsx"])
        s["rsy"] = jnp.where(exhausted, s["emy"], s["rsy"])
        s["rsz"] = jnp.where(exhausted, s["emz"], s["rsz"])
        alive_new = cont & ~exhausted
        s["depth"] = depth_new
        s["alive"] = alive_new.astype(jnp.int32)

        finished = was_alive & ~alive_new
        return s, was_alive, finished

    return step


def make_kernel(cfg: RenderConfig, *, n_spheres: int, n_cells: int,
                n_items: int, n_programs: int, ior: float = 2.0):
    """Kernel body for one program: a tile of LANES lanes that loops until
    every item of its stripe has retired."""
    stride = n_programs * LANES
    step = make_step(cfg, n_spheres=n_spheres, n_cells=n_cells,
                     n_items=n_items, stride=stride, ior=ior)

    def kernel(table_ref, cam_ref, dyn_ref, rx_ref, ry_ref, rz_ref, nseg_ref):
        p = pl.program_id(0)
        lane_global = p * LANES + jax.lax.broadcasted_iota(jnp.int32, (LANES,), 0)
        cell_start = dyn_ref[0]
        sample_start = dyn_ref[1]

        izero = jnp.zeros((LANES,), jnp.int32)
        s0 = {n: izero.astype(jnp.float32) for n in F32_STATE}
        s0.update(alive=izero, depth=izero, gen=izero - 1)
        s0.update(k0=izero.astype(jnp.uint32), k1=izero.astype(jnp.uint32))

        def cond(carry):
            return carry[2] > 0

        def body(carry):
            s, nseg, _ = carry
            s, was_alive, finished = step(s, table_ref, cam_ref, cell_start,
                                          sample_start, lane_global)
            nseg = nseg + was_alive.astype(jnp.int32)
            # Direct store of each retired item's radiance at its item index.
            # Lanes that did not retire point past the end, so the store is
            # masked on the GPU and dropped by the interpreter.
            item = jnp.where(finished, s["gen"] * stride + lane_global, n_items)
            plgpu.store(rx_ref.at[item], s["rsx"], mask=finished)
            plgpu.store(ry_ref.at[item], s["rsy"], mask=finished)
            plgpu.store(rz_ref.at[item], s["rsz"], mask=finished)
            # A lane has work while its path is alive or its next item exists.
            pending = (s["alive"] != 0) | (
                (s["gen"] + 1) * stride + lane_global < n_items)
            return s, nseg, jnp.max(pending.astype(jnp.int32))

        _, nseg, _ = jax.lax.while_loop(cond, body, (s0, izero, jnp.int32(1)))
        nseg_ref[p] = jnp.sum(nseg)

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_spheres", "n_cells", "n_items", "interpret", "ior"),
)
def _render_items(table, cam, dyn, *, cfg: RenderConfig, n_spheres: int,
                  n_cells: int, n_items: int, interpret: bool, ior: float):
    """Per-item radiance (three [n_items] f32 arrays) and per-program
    segment counts [P]."""
    n_programs = min(PROGRAMS, -(-n_items // LANES))
    kernel = make_kernel(cfg, n_spheres=n_spheres, n_cells=n_cells,
                         n_items=n_items, n_programs=n_programs, ior=ior)
    item_out = jax.ShapeDtypeStruct((n_items,), jnp.float32)
    return pl.pallas_call(
        kernel,
        grid=(n_programs,),
        out_shape=(item_out, item_out, item_out,
                   jax.ShapeDtypeStruct((n_programs,), jnp.int32)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="path_kernel",
    )(table, cam, dyn)


def render_kernel(scene: Scene, cfg: RenderConfig, cell_ids, sample_start,
                  num_samples: int, *, interpret: bool = False,
                  with_stats: bool = False):
    """SUM of radiance over the sample range for each cell, rendered by the
    fused GPU kernel — the same contract as ops/wavefront.render_wavefront.

    f32 scenes with uniform jitter only.  Runs compiled on the ``gpu``
    backend; ``interpret=True`` runs the Pallas interpreter (the CPU tests).
    Returns [n_cells, 3] sums, plus ``{"segments"}`` with ``with_stats``.
    """
    from ...render import check_contiguous_cells  # local import to avoid cycle

    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the fused path kernel is compiled for the gpu backend only "
            f"(found {jax.default_backend()!r}); pass interpret=True to run "
            "it in the Pallas interpreter")
    if scene.p0.dtype != jnp.float32:
        raise ValueError("the fused path kernel is float32-only")
    if cfg.jitter != "uniform":
        raise ValueError(f"jitter={cfg.jitter!r} is not implemented in the fused kernel")
    check_contiguous_cells(cell_ids)
    n_cells = cell_ids.shape[0]
    n_items = n_cells * num_samples

    dyn = jnp.stack([cell_ids[0], jnp.asarray(sample_start, jnp.int32)]).astype(jnp.int32)
    rx, ry, rz, nseg = _render_items(
        pack_scene(scene), pack_camera(scene), dyn, cfg=cfg,
        n_spheres=scene.num_spheres, n_cells=n_cells, n_items=n_items,
        interpret=interpret, ior=scene.ior)

    # Sequential sample-major reduction per component: the association
    # order of the batch integrator's fori accumulation (ops/wavefront.py).
    comps = []
    for flat in (rx, ry, rz):
        per_sample = flat.reshape(num_samples, n_cells)
        comps.append(jax.lax.fori_loop(
            1, num_samples, lambda i, acc, ps=per_sample: acc + ps[i],
            per_sample[0]))
    sums = jnp.stack(comps, axis=-1)
    if with_stats:
        return sums, {"segments": jnp.sum(nseg)}
    return sums
