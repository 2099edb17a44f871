"""cpu_path_tracing_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
CPU path tracer ``AlexandruIca/cpu-path-tracing`` (smallpt-derived, C++17,
Taskflow row-parallel — see SURVEY.md).  Nothing here is a port of the C++
loops: rays are batched wavefronts, RNG is counter-based threefry, material
branches are masked selects, parallelism is a jax.sharding device mesh, and
the whole estimator is differentiable end-to-end.
"""

from .config import RenderConfig
from .models.camera import Camera, CameraConfig, build_camera, get_rays
from .models.scene import (
    DIFFUSE,
    SPECULAR,
    DIELECTRIC,
    Scene,
    get_scene,
    register_scene,
    scene_from_spheres,
    scene_names,
)
from .models import scenes as _builtin_scenes  # noqa: F401  (registers scenes)
from .render import finalize_image, render_cells, render_image
from .utils.image import color_to_int, tonemap, write_png, write_ppm

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "CameraConfig",
    "build_camera",
    "get_rays",
    "DIFFUSE",
    "SPECULAR",
    "DIELECTRIC",
    "Scene",
    "get_scene",
    "register_scene",
    "scene_from_spheres",
    "scene_names",
    "render_image",
    "render_cells",
    "finalize_image",
    "color_to_int",
    "tonemap",
    "write_png",
    "write_ppm",
]
