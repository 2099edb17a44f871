"""Batched ray-sphere intersection.

Replacement for the reference's per-ray linear scan
(``intersect`` at ``src/main.cpp:30-42`` calling ``pt::sphere::intersect``,
``src/sphere.cpp:6-30``): one broadcast [B, N] quadratic solve plus a masked
argmin.  N is tiny (5-10 spheres; the reference has no BVH, ``README.md:8``),
so all-pairs is exact and needs no acceleration structure.

Numerics (differences from the reference, deliberate):

* anchor-point parametrization (see ``models/scene.py``) removes the f32
  catastrophic cancellation of ``oc.oc - r^2`` for r=1e6 wall spheres;
* the stable "q" quadratic form is used: with ``q = -(b + sign(b) sqrt(disc))``
  the two roots are ``q/a`` and ``c/q`` — no subtractive cancellation in the
  near root, unlike the reference's ``(-b - sqrtd)/a`` (``src/sphere.cpp:20``)
  which loses all f32 precision when ``b ~ 1e6``.

Root-selection semantics match the reference exactly: nearest root ``>=
epsilon``, else the far root, else miss (``src/sphere.cpp:19-28``); ties across
spheres keep the lowest index (``src/main.cpp:34-39`` strict ``d < t`` forward
scan == first-occurrence argmin).

Precision note: every contraction here carries
``precision=Precision.HIGHEST``.  An accelerator may run a default-precision
float32 einsum/matmul at reduced precision (TF32 on a GPU: a 10-bit
mantissa) — catastrophic for the intersection quadratic and silently wrong
for the property gather (1.92 -> rounded).  HIGHEST forces full-f32
accumulation; the contractions are tiny (c=3, N<=~100), so the cost is
negligible next to the elementwise quadratic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.lax import Precision

from ..models.scene import Scene


def intersect_scene(scene: Scene, origins, directions, epsilon=1e-4, inf=1e20):
    """Intersect a ray batch against every sphere.

    Args:
      origins: [B,3]; directions: [B,3] (need not be normalized — the
        reference's primary rays are not, ``src/camera.cpp:36-37``, and the
        general quadratic with ``a = d.d`` handles it, ``src/sphere.cpp:9``).

    Returns:
      t:      [B] distance to nearest hit (== inf on miss)
      hit_id: [B] int32 index of the nearest sphere (first index on ties)
      hit:    [B] bool

    Expression structure note: every dot product is written as the explicit
    left-associated component chain ``x0*y0 + x1*y1 + x2*y2`` — the EXACT
    expression the fused GPU kernel uses — rather than einsum.  Identical
    chains compile bitwise-identically under XLA and the Pallas interpreter,
    while einsum's unspecified contraction order differs from the chain in a
    few percent of t values at smallpt coordinate scale (ulp-level, but
    enough to flip epsilon hit tests / RR lotteries and fail the on-card
    gate's strict tier for big-coordinate scenes).  Agreement between the
    integrators is a correctness feature (one estimator, one answer), so
    chain structure is load-bearing here — do not "simplify" back to
    einsum/sum.
    """
    p0 = scene.p0  # [N,3]
    r = scene.radius[None, :]  # [1,N]
    ad = jax.lax.stop_gradient(scene.anchor_dir)  # constant buffer [N,3]

    ox, oy, oz = origins[:, 0:1], origins[:, 1:2], origins[:, 2:3]  # [B,1]
    dx, dy, dz = directions[:, 0:1], directions[:, 1:2], directions[:, 2:3]
    p0x, p0y, p0z = p0[None, :, 0], p0[None, :, 1], p0[None, :, 2]  # [1,N]
    adx, ady, adz = ad[None, :, 0], ad[None, :, 1], ad[None, :, 2]

    qx, qy, qz = ox - p0x, oy - p0y, oz - p0z  # [B,N] unit scale
    a = dx * dx + dy * dy + dz * dz  # [B,1]
    qd = qx * dx + qy * dy + qz * dz  # [B,N]
    add = adx * dx + ady * dy + adz * dz
    b = qd + r * add  # oc.d
    qq = qx * qx + qy * qy + qz * qz
    qad = qx * adx + qy * ady + qz * adz
    c = qq + 2.0 * r * qad  # oc.oc - r^2, cancellation-free

    disc = b * b - a * c
    has_root = disc >= 0.0
    sqrtd = jnp.sqrt(jnp.where(has_root, disc, 1.0))  # grad-safe sqrt

    sign_b = jnp.where(b >= 0.0, 1.0, -1.0)
    qform = -(b + sign_b * sqrtd)
    qform_safe = jnp.where(qform != 0.0, qform, 1.0)
    # Reciprocal-multiply with the reciprocal HOISTED out of the per-sphere
    # math: a depends only on the ray, and an f32 divide costs several fma
    # slots — one divide per lane instead of one per (lane, sphere).  The
    # fused kernel hoists the identical chain (parity).
    a_inv = 1.0 / a
    root_1 = qform * a_inv
    root_2 = jnp.where(qform != 0.0, c / qform_safe, inf)
    t_near = jnp.minimum(root_1, root_2)
    t_far = jnp.maximum(root_1, root_2)

    # src/sphere.cpp:19-28: near root if >= epsilon, else far root, else miss.
    root = jnp.where(t_near >= epsilon, t_near, jnp.where(t_far >= epsilon, t_far, inf))
    root = jnp.where(has_root, root, inf)

    t = jnp.min(root, axis=-1)
    hit_id = jnp.argmin(root, axis=-1).astype(jnp.int32)
    hit = t < inf
    return t, hit_id, hit


from typing import NamedTuple


class SphereProps(NamedTuple):
    """Per-lane properties of the hit sphere (all [B,...])."""

    center: jax.Array  # [B,3] sphere center (p0 - radius*anchor_dir)
    emission: jax.Array  # [B,3]
    albedo: jax.Array  # [B,3]
    mat_mask: jax.Array  # [B,3] one-hot f32 (diffuse, specular, dielectric)


def sphere_props(scene: Scene, hit_id) -> SphereProps:
    """Gather all per-sphere data for a lane batch with ONE one-hot matmul.

    Rationale: the design's first target lowered per-lane `table[hit_id]`
    gathers to slow DMA; a [B,N] x [N,12] matmul over the tiny sphere table
    is pure vector/matrix work.  Whether a plain gather is cheaper on the
    GPU is not measured yet.
    The material enum rides along as three one-hot f32 columns, which the
    shading blend consumes directly (no int compares).

    The gathered geometry is the CENTER only: the outward normal is the
    normalized (hit - center), so anchor/radius never need gathering —
    10 tracked columns in the fused kernel's running select instead of 16
    (the select is ~30% of the per-sphere intersect cost).  The center is
    derived as ``p0 - radius*anchor_dir`` in the scene dtype with the
    identical chain on both sides; for the 1e6-radius walls its f32
    rounding perturbs the normal DIRECTION by ~1e-7 relative — the same
    order as the previous unit-scale ``anchor + (h-p0)/r`` chain's own
    rounding.
    """
    dtype = scene.p0.dtype
    n = scene.num_spheres
    ad = jax.lax.stop_gradient(scene.anchor_dir)
    mats = jax.nn.one_hot(scene.material, 3, dtype=dtype)  # [N,3]
    center = scene.p0 - scene.radius[:, None] * ad  # [N,3]
    table = jnp.concatenate(
        [
            center,  # 0:3
            scene.emission,  # 3:6
            scene.albedo,  # 6:9
            mats,  # 9:12
        ],
        axis=1,
    )  # [N,12]
    onehot = (hit_id[:, None] == jnp.arange(n, dtype=hit_id.dtype)[None, :]).astype(dtype)
    # HIGHEST: the default may run at reduced precision and round the
    # gathered scene constants (see module docstring).
    props = jnp.matmul(onehot, table, precision=Precision.HIGHEST)  # [B,12]
    return SphereProps(
        center=props[:, 0:3],
        emission=props[:, 3:6],
        albedo=props[:, 6:9],
        mat_mask=props[:, 9:12],
    )


def hit_record(scene: Scene, origins, directions, t, hit_id, props: "SphereProps | None" = None):
    """Batched ``pt::get_hit_record_at`` (``src/hit_record.cpp:3-12``).

    Returns (hit_point [B,3], outward_normal [B,3], normal [B,3], front [B]).
    ``normal`` is the front-facing normal; ``outward_normal`` always points
    away from the sphere center.  The caller must have replaced miss-lane ``t``
    with a finite dummy (grad safety).
    """
    if props is None:
        props = sphere_props(scene, hit_id)
    c_h = props.center

    # Kernel-identical expression structure (see intersect_scene docstring):
    # explicit component chains, rsqrt normalize — ops/pallas/gpu_kernel.py
    # hit-record block.
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = directions[:, 0], directions[:, 1], directions[:, 2]
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    # Outward normal = normalized (hp - center): the 1/r scaling is
    # absorbed by the normalization, so neither radius nor anchor needs
    # gathering (see sphere_props on the precision budget).
    nrx = hx - c_h[:, 0]
    nry = hy - c_h[:, 1]
    nrz = hz - c_h[:, 2]
    ninv = _rsqrt_safe(nrx * nrx + nry * nry + nrz * nrz)
    nox = nrx * ninv
    noy = nry * ninv
    noz = nrz * ninv
    ndotd = nox * dx + noy * dy + noz * dz
    front = ndotd < 0.0
    fsign = jnp.where(front, 1.0, -1.0)
    hp = jnp.stack([hx, hy, hz], axis=-1)
    n_out = jnp.stack([nox, noy, noz], axis=-1)
    normal = n_out * fsign[:, None]
    return hp, n_out, normal, front


def _rsqrt_safe(x):
    """Gradient-safe rsqrt — identical guard structure to the fused kernel's."""
    return jax.lax.rsqrt(jnp.where(x > 0, x, 1.0))
