"""Material scattering, batched + branch-free.

Replacement for the reference's ``switch``-dispatched per-ray
samplers (``diffuse_ray`` / ``specular_ray`` / ``dielectric_ray``,
``src/main.cpp:44-97,141-154``): all three directions are computed for every
lane and blended by material id with one-hot mask products — the
XLA-friendly "compute-all-select" form of the 3-way branch (SURVEY.md §2.3,
EP row).

Every function is total (no NaN for any input lane, hit or miss), so masked
lanes cannot poison gradients.

Expression structure note (load-bearing, do not "simplify"): every dot
product / norm is the explicit left-associated component chain and every
division-by-computed-value is a reciprocal-multiply, EXACTLY matching the
fused GPU kernel (ops/pallas/gpu_kernel.py materials block).  Identical
expression structure is what keeps the XLA integrators and the kernel
bitwise equal in interpret mode and close on the card — see
ops/intersect.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from .intersect import _rsqrt_safe

# Reference constants: src/main.cpp:62 (fuzziness, always 0 and its "fuzz" is
# a constant-vector no-op anyway) and src/main.cpp:71 (refraction index 2.0 —
# NOT the sandbox's 1.5, sandbox/main.cpp:204).
REFRACTION_INDEX = 2.0


def _sqrt_safe(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def sample_diffuse_c(nx, ny, nz, u_phi, u_sin2):
    """Cosine-weighted hemisphere about the front-facing normal
    (``diffuse_ray``, ``src/main.cpp:44-58``): phi = 2*pi*u,
    sin(theta) = sqrt(u'), cos(theta) = sqrt(1-u'), ONB with the
    |w.x| > 0.1 axis pick.  Component-chain form."""
    phi = (2.0 * jnp.pi) * u_phi
    sin_t = jnp.sqrt(u_sin2)
    cos_t = _sqrt_safe(1.0 - u_sin2)
    # axis = (0,1,0) when |n.x| > 0.1 else (1,0,0); u = cross(axis, n)
    ax_y = jnp.abs(nx) > 0.1  # src/main.cpp:52
    ux_r = jnp.where(ax_y, nz, jnp.zeros_like(nz))
    uy_r = jnp.where(ax_y, jnp.zeros_like(nz), -nz)
    uz_r = jnp.where(ax_y, -nx, ny)
    uinv = _rsqrt_safe(ux_r * ux_r + uy_r * uy_r + uz_r * uz_r)
    ux, uy, uz = ux_r * uinv, uy_r * uinv, uz_r * uinv
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    ddx = ux * cp * sin_t + vx * sp * sin_t + nx * cos_t
    ddy = uy * cp * sin_t + vy * sp * sin_t + ny * cos_t
    ddz = uz * cp * sin_t + vz * sp * sin_t + nz * cos_t
    dinv = _rsqrt_safe(ddx * ddx + ddy * ddy + ddz * ddz)
    return ddx * dinv, ddy * dinv, ddz * dinv


def sample_specular_c(dx, dy, dz, nox, noy, noz):
    """Mirror reflection about the outward normal (``specular_ray``,
    ``src/main.cpp:60-67``).  The reference's "fuzz" adds
    ``rng()*0.0 * (1,1,1)`` — a no-op — and is dropped; reflecting about the
    outward vs front-facing normal is identical (n appears quadratically)."""
    ndotd = nox * dx + noy * dy + noz * dz
    return dx - 2.0 * nox * ndotd, dy - 2.0 * noy * ndotd, dz - 2.0 * noz * ndotd


def sample_dielectric_c(dx, dy, dz, a_quad, nx, ny, nz, front, u_choice, *,
                        ior=REFRACTION_INDEX,
                        spx, spy, spz):
    """RTIOW dielectric (``dielectric_ray``, ``src/main.cpp:69-97``):
    index 2.0, Schlick-probability reflect-vs-refract choice (no splitting,
    unlike the sandbox, ``sandbox/main.cpp:219-226``).

    Args:
      dx..dz: incoming direction components (unnormalized ok).
      a_quad: |d|^2 chain (shared with the intersect/sky computation).
      nx..nz: front-facing normal components.
      front: [B] bool front_facing.
      u_choice: [B] uniform for the reflect/refract lottery.
      spx..spz: precomputed specular reflection (the reflect branch).
    Returns:
      (ddx, ddy, ddz, reflected) — direction unnormalized, matching the
      reference (it returns r_perp + r_parallel raw).
    """
    ratio = jnp.where(front, jnp.float32(1.0 / ior),
                      jnp.float32(ior)).astype(dx.dtype)
    dinv = _rsqrt_safe(a_quad)
    udx, udy, udz = dx * dinv, dy * dinv, dz * dinv
    cos_d = jnp.minimum(-(udx * nx + udy * ny + udz * nz), 1.0)
    sin_d = _sqrt_safe(1.0 - cos_d * cos_d)

    cannot = ratio * sin_d > 1.0
    # Schlick reflectance (src/main.cpp:82-87)
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    mm = jnp.maximum(1.0 - cos_d, 0.0)
    reflprob = r0 + (1.0 - r0) * (mm * mm * mm * mm * mm)
    reflected = cannot | (reflprob > u_choice)

    ppx = (udx + nx * cos_d) * ratio
    ppy = (udy + ny * cos_d) * ratio
    ppz = (udz + nz * cos_d) * ratio
    kk = jnp.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))  # abs: main.cpp:94
    neg_sqrt_k = -jnp.sqrt(kk)
    ddx = jnp.where(reflected, spx, ppx + nx * neg_sqrt_k)
    ddy = jnp.where(reflected, spy, ppy + ny * neg_sqrt_k)
    ddz = jnp.where(reflected, spz, ppz + nz * neg_sqrt_k)
    return ddx, ddy, ddz, reflected


def schlick(cosine, ref_idx):
    """Schlick reflectance (``src/main.cpp:82-87``) — scalar helper kept for
    tests; the dielectric sampler inlines the identical chain."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = jnp.maximum(1.0 - cosine, 0.0)
    return r0 + (1.0 - r0) * (m * m * m * m * m)


def scatter(mat_mask, d_in, outward_normal, normal, front, u_a, u_b,
            ior=REFRACTION_INDEX):
    """Blend all three samplers by the one-hot material mask (replaces the
    ``switch`` at ``src/main.cpp:141-154``).  Returns new (unnormalized-ok)
    directions [B,3].

    Args:
      mat_mask: [B,3] f32 one-hot (diffuse, specular, dielectric) — produced
        by ops.intersect.sphere_props so no per-lane int compares are needed.

    Draw mapping (fixed 4-block; see ops/rng.py): diffuse uses (u_a, u_b),
    dielectric uses (u_a) for the branch lottery.
    """
    dx, dy, dz = d_in[:, 0], d_in[:, 1], d_in[:, 2]
    nox, noy, noz = outward_normal[:, 0], outward_normal[:, 1], outward_normal[:, 2]
    nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]
    a_quad = dx * dx + dy * dy + dz * dz

    ddx, ddy, ddz = sample_diffuse_c(nx, ny, nz, u_a, u_b)
    spx, spy, spz = sample_specular_c(dx, dy, dz, nox, noy, noz)
    dlx, dly, dlz, _ = sample_dielectric_c(dx, dy, dz, a_quad, nx, ny, nz,
                                           front, u_a, ior=ior,
                                           spx=spx, spy=spy, spz=spz)

    m_dif, m_spe, m_die = mat_mask[:, 0], mat_mask[:, 1], mat_mask[:, 2]
    out_x = m_dif * ddx + m_spe * spx + m_die * dlx
    out_y = m_dif * ddy + m_spe * spy + m_die * dly
    out_z = m_dif * ddz + m_spe * spz + m_die * dlz
    return jnp.stack([out_x, out_y, out_z], axis=-1)


# ---------------------------------------------------------------------------
# [B,3]-interface wrappers (tests / external callers; the integrator uses the
# component-chain forms through scatter()).
# ---------------------------------------------------------------------------

def sample_diffuse(normal, u_phi, u_sin2):
    """Cosine-weighted hemisphere about ``normal`` — [B,3] wrapper."""
    ddx, ddy, ddz = sample_diffuse_c(normal[:, 0], normal[:, 1], normal[:, 2],
                                     u_phi, u_sin2)
    return jnp.stack([ddx, ddy, ddz], axis=-1)


def sample_specular(d_in, outward_normal):
    """Mirror reflection — [B,3] wrapper."""
    spx, spy, spz = sample_specular_c(
        d_in[:, 0], d_in[:, 1], d_in[:, 2],
        outward_normal[:, 0], outward_normal[:, 1], outward_normal[:, 2])
    return jnp.stack([spx, spy, spz], axis=-1)


def sample_dielectric(d_in, normal, front, u_choice):
    """RTIOW dielectric — [B,3] wrapper.  Returns (direction, reflected)."""
    dx, dy, dz = d_in[:, 0], d_in[:, 1], d_in[:, 2]
    nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]
    a_quad = dx * dx + dy * dy + dz * dz
    spx, spy, spz = sample_specular_c(dx, dy, dz, nx, ny, nz)
    ddx, ddy, ddz, reflected = sample_dielectric_c(
        dx, dy, dz, a_quad, nx, ny, nz, front, u_choice,
        spx=spx, spy=spy, spz=spz)
    return jnp.stack([ddx, ddy, ddz], axis=-1), reflected
