"""Scene representation: structure-of-arrays sphere list + camera.

Replacement for ``pt::scene`` (``src/scene.hpp:12-16``) — instead of
an array-of-structs ``std::vector<sphere>`` the scene is a pytree of arrays,
the differentiable parameter set of the renderer.

Anchor-point parametrization (the f32 precision fix)
----------------------------------------------------
The reference stores each sphere as ``{radius, position(=center), ...}``
(``src/sphere.hpp:10-22``) and intersects with
``c = oc.oc - r^2`` (``src/sphere.cpp:8-11``).  With the box scenes' giant
wall spheres (``radius = 1e6``, ``src/box_scene.hpp:16``) that expression
catastrophically cancels in float32: ``oc.oc ~ 1e12`` carries ~1e5 of absolute
rounding error, versus a feature scale of 0.4.

We therefore parametrize every sphere by a **surface anchor point**::

    p0     = center + radius * anchor_dir        (computed once, in float64)
    center = p0 - radius * anchor_dir

with ``anchor_dir`` a unit vector pointing from the center towards the scene's
region of interest.  Intersection then only ever touches the well-scaled
quantities ``q = origin - p0`` (unit scale) and ``anchor_dir``:

    oc    = q + r * anchor_dir
    b     = oc.d        = q.d + r * (anchor_dir . d)
    c     = oc.oc - r^2 = q.q + 2 r (q . anchor_dir)        # NO cancellation

so float32 keeps full relative precision even at r = 1e6.  ``anchor_dir`` is a
constant (non-optimized) buffer; gradients w.r.t. a rigid translation of the
sphere equal gradients w.r.t. ``p0`` exactly, and d(p0)/d(radius) = anchor_dir.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from .camera import CameraConfig

# Material ids — mirror of ``pt::reflection_type`` (src/reflection.hpp:7-12).
DIFFUSE = 0
SPECULAR = 1
DIELECTRIC = 2


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["p0", "radius", "anchor_dir", "emission", "albedo", "material", "camera",
                 "background"],
    meta_fields=["ior"],
)
@dataclasses.dataclass
class Scene:
    """SoA sphere list (+ camera) — the differentiable parameter pytree.

    Mirrors ``pt::scene`` (``src/scene.hpp:12-16``) / ``pt::sphere``
    (``src/sphere.hpp:10-22``) with the anchor-point parametrization above.
    """

    p0: jax.Array  # [N,3] surface anchor points (unit scale)
    radius: jax.Array  # [N]
    anchor_dir: jax.Array  # [N,3] unit, constant (carry stop_gradient)
    emission: jax.Array  # [N,3]
    albedo: jax.Array  # [N,3] ("color" in the reference)
    material: jax.Array  # [N] int32, one of DIFFUSE/SPECULAR/DIELECTRIC
    camera: CameraConfig
    # Miss radiance: sky = (1-t)*background[0] + t*background[1] with
    # t = 0.5*(unit_dir.y + 1).  Default (white, (.5,.7,1)) is the reference
    # gradient (src/main.cpp:115-120); (0,0,0) rows give the sandbox smallpt's
    # black background (sandbox/main.cpp:154-156).  Differentiable.
    background: jax.Array = None  # [2,3]
    # Dielectric refraction index — a STATIC (meta) field: it reaches every
    # integrator as a trace-time constant, so the default 2.0 (the
    # ``src/main.cpp:71`` quirk) compiles to the identical program as before
    # the field existed, preserving the pinned renders.
    # The vendored sandbox smallpt uses 1.5 (``sandbox/main.cpp:204``) — see
    # the ``smallpt_exact`` scene / scripts/refmatch.py.
    ior: float = 2.0

    @property
    def num_spheres(self) -> int:
        return self.p0.shape[0]

    @property
    def centers(self) -> jax.Array:
        """Derived sphere centers [N,3] = p0 - r*anchor_dir.

        Accurate for unit-scale spheres; for r=1e6 wall spheres the value is
        exact in f64 and representable only to ~0.06 in f32 (which is why the
        renderer never uses it).
        """
        return self.p0 - self.radius[:, None] * self.anchor_dir

    def astype(self, dtype) -> "Scene":
        f = lambda x: jnp.asarray(x, dtype) if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else jnp.asarray(x)
        return Scene(
            p0=f(self.p0),
            radius=f(self.radius),
            anchor_dir=f(self.anchor_dir),
            emission=f(self.emission),
            albedo=f(self.albedo),
            material=jnp.asarray(self.material, jnp.int32),
            camera=self.camera.astype(dtype),
            background=f(self.background),
            ior=self.ior,
        )


# The reference's hardcoded sky gradient endpoints (src/main.cpp:116-119).
SKY_GRADIENT = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
BLACK_BACKGROUND = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))


def scene_from_spheres(
    spheres,
    camera: CameraConfig,
    anchor_toward=None,
    dtype=jnp.float32,
    background=SKY_GRADIENT,
    anchor_dirs=None,
    ior: float = 2.0,
) -> Scene:
    """Build a Scene from (radius, center, emission, albedo, material) tuples.

    All anchor math happens in float64 NumPy before the cast to ``dtype``, so
    the stored ``p0`` is the correctly-rounded surface point even for r=1e6
    walls (replaces the raw center storage of ``src/sphere.hpp:13-14``).

    Args:
      spheres: iterable of (radius, center[3], emission[3], albedo[3], mat_id).
      anchor_toward: [3] point of interest the anchors should face (default:
        the camera look-at point, matching where rays actually hit the walls).
      background: ([3],[3]) miss-radiance gradient (bottom, top); defaults to
        the reference sky (src/main.cpp:116-119).
      anchor_dirs: optional [N,3] explicit unit anchor directions (overrides
        ``anchor_toward``; used by models/io.py for exact round-trips).
    """
    if anchor_toward is None:
        anchor_toward = np.asarray(jax.device_get(camera.look_at), np.float64)
    else:
        anchor_toward = np.asarray(anchor_toward, np.float64)

    radii, centers, emissions, albedos, materials = [], [], [], [], []
    for r, c, e, a, m in spheres:
        radii.append(float(r))
        centers.append(np.asarray(c, np.float64))
        emissions.append(np.asarray(e, np.float64))
        albedos.append(np.asarray(a, np.float64))
        materials.append(int(m))

    radii = np.asarray(radii, np.float64)
    centers = np.stack(centers)
    if anchor_dirs is not None:
        anchor_dir = np.asarray(anchor_dirs, np.float64)
    else:
        toward = anchor_toward[None, :] - centers
        norms = np.linalg.norm(toward, axis=-1, keepdims=True)
        # Degenerate case (center == point of interest): arbitrary fixed axis.
        anchor_dir = np.where(norms > 0, toward / np.where(norms > 0, norms, 1.0), np.array([0.0, 0.0, 1.0]))
    p0 = centers + radii[:, None] * anchor_dir

    return Scene(
        p0=jnp.asarray(p0, dtype),
        radius=jnp.asarray(radii, dtype),
        anchor_dir=jnp.asarray(anchor_dir, dtype),
        emission=jnp.asarray(np.stack(emissions), dtype),
        albedo=jnp.asarray(np.stack(albedos), dtype),
        material=jnp.asarray(materials, jnp.int32),
        camera=camera,
        background=jnp.asarray(np.asarray(background, np.float64), dtype),
        ior=float(ior),
    )


# --------------------------------------------------------------------------
# Scene registry — replaces the reference's compile-time #include swap
# (src/main.cpp:23-25: scene choice required editing + recompiling).
# --------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[..., Scene]] = {}


def register_scene(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_scene(name: str, width: int, height: int, dtype=jnp.float32) -> Scene:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scene {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](width, height, dtype=dtype)


def scene_names():
    return sorted(_REGISTRY)
