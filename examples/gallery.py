"""Render the stock-scene gallery to docs/images/.

    python examples/gallery.py [outdir]

Runs everything sequentially on the default JAX device, at full size on a
GPU and at a small size elsewhere.
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from nrenderer_tpu.resources import (  # noqa: E402
    attach_env_map, bunny_path, scene_path)


def main() -> int:
    outdir = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                          else "docs/images")
    outdir.mkdir(parents=True, exist_ok=True)
    import jax
    import nrenderer_tpu
    nrenderer_tpu.enable_compilation_cache()
    nrenderer_tpu._register_builtin_renderers()
    from nrenderer_tpu import load_scn, load_obj
    from nrenderer_tpu.io.image import write_png
    from nrenderer_tpu.server.manager import ComponentManager

    full = jax.default_backend() == "gpu"
    size = 512 if full else 96
    spp = 2048 if full else 16

    def run(name, scene, renderer, component=None):
        t0 = time.time()
        mgr = ComponentManager()
        mgr.exec(renderer, scene, component=component)
        result = mgr.wait()
        dt = time.time() - t0
        path = outdir / f"{name}.png"
        write_png(str(path), result.pixels)
        print(f"{name}: {dt:.1f}s -> {path}", flush=True)

    # 1. RayCast cornel (config 1)
    scene = load_scn(scene_path("ray_cast_cornel.scn"))
    scene.render_option.width = scene.render_option.height = size
    run("raycast_cornel", scene, "RayCast")

    # 2. PT cornel north star (config 2)
    scene = load_scn(scene_path("path_tracing_cornel.scn"))
    ro = scene.render_option
    ro.width = ro.height = size
    ro.samples_per_pixel = spp
    ro.depth = 20
    run("pt_cornel_2048spp", scene, "SimplePathTracer")

    # 3. pt_glass (config 3: conductor Fresnel)
    scene = load_scn(scene_path("pt_glass.scn"))
    ro = scene.render_option
    ro.width = ro.height = size
    ro.samples_per_pixel = spp
    ro.depth = 20
    run("pt_glass_2048spp", scene, "AccPathTracer")

    # 4. bunny-5k mesh + BVH (config 4)
    scene = load_scn(scene_path("path_tracing_cornel.scn"))
    load_obj(bunny_path("5k"), scene, material=0)
    m = scene.models[-1]
    m.scale = (600.0,) * 3
    m.translation = (40.0, -305.0, 920.0)
    ro = scene.render_option
    ro.width = ro.height = min(size, 256)
    ro.samples_per_pixel = min(spp, 128)
    ro.depth = 8
    run("bunny5k_cornel", scene, "AccPathTracer")

    # 4b. env-map spheres (config 4)
    scene = attach_env_map(load_scn(scene_path("env_map_spheres.scn")))
    ro = scene.render_option
    ro.width = ro.height = min(size, 256)
    ro.samples_per_pixel = min(spp, 256)
    ro.depth = 8
    run("env_map_spheres", scene, "AccPathTracer")

    # 5. MLT (config 5)
    from nrenderer_tpu.renderers.mlt import MetropolisRenderer
    scene = load_scn(scene_path("Metropolis.scn"))
    ro = scene.render_option
    ro.width = ro.height = min(size, 384)
    ro.depth = 20 if full else 6
    comp = MetropolisRenderer(chains=4096 if full else 64,
                              mutations=512 if full else 8)
    run("mlt_cornel", scene, "MetropolisLightTransport", component=comp)

    return 0


if __name__ == "__main__":
    sys.exit(main())
