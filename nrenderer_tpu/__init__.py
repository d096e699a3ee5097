"""nrenderer_tpu — a JAX (XLA + Pallas) rebuild of NRenderer.

A pluggable offline rendering framework with the capabilities of
civilizwa/nrenderer: the `.scn` scene DSL and OBJ importers, the renderer
registry ("RenderComponent" plugin surface), and the four renderers — RayCast
Phong, SimplePathTracer, AccPathTracer (BVH + conductor/dielectric/microfacet
BSDFs + env maps), and MetropolisLightTransport — each implemented as a
jit-compiled wavefront over SoA ray batches (and, for dense scenes on the
GPU, one Pallas megakernel) instead of per-pixel C++ thread loops.
"""
import os

__version__ = "0.1.0"

from .scene.model import (  # noqa: F401
    Ambient, AmbientType, AreaLight, Camera, DirectionalLight, Light,
    LightType, Material, Mesh, Model, Node, NodeType, Plane, PointLight,
    Property, PropertyType, RenderOption, Scene, Sphere, SpotLight, Texture,
)
from .scene.arrays import SceneArrays, build_scene_arrays  # noqa: F401
from .scene.builder import SceneBuildError, build_scene, validate_scene  # noqa: F401
from .scene.templates import make_material, template_names  # noqa: F401
from .io.scn import load_scn, parse_scn, ScnParseError  # noqa: F401
from .io.obj import load_obj, ObjParseError  # noqa: F401


def _register_builtin_renderers() -> None:
    """Import renderer modules for their registration side effects (the
    analogue of the reference's DLL scan + static-initializer registration,
    `ComponentManager.cpp:15-30`)."""
    from .renderers import (example, raycast, simple_pt, acc_pt, mlt,  # noqa: F401
                            preview)  # noqa: F401


CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> None:
    """Persist XLA compilations across processes (each scene and camera
    compiles its own program; the cache makes re-renders of the same scene
    shape start at once).  Called by the CLI and bench entry points.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache is `.jax_cache/` in the checkout."""
    import jax
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
