"""Benchmark suite: every stock workload through the renderer registry.

Each row renders once to compile (set-up) and once warm, through the same
`ComponentManager` path the CLI uses, so every path tracer runs the engine
`renderers.engine.choose_engine` picks.  Prints a markdown table headed by
the device.  Without a GPU it exits non-zero and prints no result.

    python bench_suite.py
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


def _cornel(name):
    from nrenderer_tpu import load_scn
    from nrenderer_tpu.resources import scene_path
    return load_scn(scene_path(name))


def _conductors():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "examples"))
    from conductors_grid import build_scene
    return build_scene()


def _env():
    from nrenderer_tpu.resources import attach_env_map
    return attach_env_map(_cornel("env_map_spheres.scn"))


def _bunny():
    from nrenderer_tpu import load_obj
    from nrenderer_tpu.resources import bunny_path
    scene = _cornel("path_tracing_cornel.scn")
    load_obj(bunny_path("5k"), scene, material=0)
    m = scene.models[-1]
    m.scale = (600.0,) * 3
    m.translation = (40.0, -305.0, 920.0)
    return scene


# (row name, scene factory, renderer, size, spp, depth)
WORKLOADS = [
    ("RayCast cornel", lambda: _cornel("ray_cast_cornel.scn"), "RayCast",
     512, 1, 1),
    ("PT cornel (north star)", lambda: _cornel("path_tracing_cornel.scn"),
     "SimplePathTracer", 512, 2048, 20),
    ("AccPT pt_glass", lambda: _cornel("pt_glass.scn"), "AccPathTracer",
     512, 2048, 20),
    ("AccPT conductors", _conductors, "AccPathTracer", 512, 2048, 20),
    ("AccPT env-map spheres", _env, "AccPathTracer", 512, 1024, 8),
    ("AccPT bunny-5k", _bunny, "AccPathTracer", 500, 256, 20),
]


def _render(make_scene, renderer, size, spp, depth):
    from nrenderer_tpu.server.manager import ComponentManager
    scene = make_scene()
    ro = scene.render_option
    ro.width = ro.height = size
    ro.samples_per_pixel, ro.depth = spp, depth
    mgr = ComponentManager()
    t0 = time.perf_counter()
    mgr.exec(renderer, scene)
    result = mgr.wait()
    if result is None:
        raise RuntimeError(f"{renderer} failed")
    return time.perf_counter() - t0


def main() -> int:
    import jax
    if jax.default_backend() != "gpu":
        print(f"bench_suite.py needs a GPU; JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    import nrenderer_tpu
    nrenderer_tpu.enable_compilation_cache()
    nrenderer_tpu._register_builtin_renderers()
    dev = jax.devices()[0]
    lines = [f"# Benchmarks ({dev.platform}, {dev.device_kind}, "
             f"{len(jax.devices())} device(s))", "",
             "| Workload | Config | Set-up (s) | Warm (s) | Rate |",
             "|---|---|---|---|---|"]
    for name, make_scene, renderer, size, spp, depth in WORKLOADS:
        cold = _render(make_scene, renderer, size, spp, depth)
        warm = _render(make_scene, renderer, size, spp, depth)
        lines.append(f"| {name} | {size}x{size}, {spp} spp, depth {depth} "
                     f"| {cold - warm:.3f} | {warm:.3f} "
                     f"| {spp / warm:.1f} spp/s |")

    from nrenderer_tpu.renderers.mlt import render_mlt
    scene = _cornel("Metropolis.scn")
    scene.render_option.width = scene.render_option.height = 500
    chains, muts = 4096, 1024
    render_mlt(scene, chains=chains, mutations=128, seed=0)   # compile
    t0 = time.perf_counter()
    render_mlt(scene, chains=chains, mutations=muts, seed=1)
    dt = time.perf_counter() - t0
    lines.append(f"| MLT Metropolis.scn | 500x500, {chains}x{muts} "
                 f"mutations | - | {dt:.3f} "
                 f"| {chains * muts / dt / 1e3:.1f} Kmut/s |")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
