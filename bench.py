"""North-star benchmark: `path_tracing_cornel.scn` at 512x512, 2048 spp,
depth 20, on one GPU.

Renders with the engine `renderers.engine.choose_engine` picks for the
scene, warm (compile first, then the median of 3 timed renders, each ending
in `block_until_ready`), and prints ONE JSON line naming the device:

    {"metric": ..., "value": seconds, "unit": "seconds", "device": {...}}

Without a GPU it exits non-zero and prints no result.

    python bench.py
"""
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

SIZE, SPP, DEPTH = 512, 2048, 20


def main() -> int:
    import jax
    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    import numpy as np
    import nrenderer_tpu
    nrenderer_tpu.enable_compilation_cache()
    from nrenderer_tpu import build_scene_arrays, load_scn
    from nrenderer_tpu.ops.camera import make_camera
    from nrenderer_tpu.ops.intersect import make_static_scene
    from nrenderer_tpu.renderers.engine import MEGAKERNEL, choose_engine
    from nrenderer_tpu.resources import scene_path

    scene = load_scn(scene_path("path_tracing_cornel.scn"))
    arr = build_scene_arrays(scene)
    ss = make_static_scene(arr)
    cam = make_camera(scene.camera)
    engine = choose_engine(ss, mesh=False, has_lens=False, textures=None)
    if engine == MEGAKERNEL:
        from nrenderer_tpu.ops.pt_pallas import render_simple_pt_pallas

        def render(seed):
            return render_simple_pt_pallas(ss, cam, SIZE, SIZE, SPP, DEPTH,
                                           seed=seed)
    else:
        from nrenderer_tpu.ops.sampling import make_base_key
        from nrenderer_tpu.renderers.simple_pt import (build_render_fn,
                                                       pick_chunk)
        fn = build_render_fn(ss, SIZE, SIZE, SPP, DEPTH,
                             pick_chunk(SIZE, SIZE, SPP), False, False)

        def render(seed):
            return fn(cam, arr.env_map, make_base_key(seed))

    t0 = time.perf_counter()
    render(0).block_until_ready()
    compile_s = time.perf_counter() - t0
    walls = []
    for rep in range(3):
        t0 = time.perf_counter()
        img = render(1 + rep).block_until_ready()
        walls.append(time.perf_counter() - t0)
    img = np.asarray(img)
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()
    wall = statistics.median(walls)
    dev = jax.devices()[0]
    result = {
        "metric": (f"wall-clock path_tracing_cornel.scn {SIZE}x{SIZE} "
                   f"{SPP}spp depth={DEPTH} [{engine}]; "
                   f"{SPP / wall:.1f} spp/s, "
                   f"{SIZE * SIZE * SPP * DEPTH / wall / 1e6:.1f} "
                   f"Mbounce-rays/s; set-up {compile_s:.2f}s"),
        "value": wall,
        "unit": "seconds",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
