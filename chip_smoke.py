#!/usr/bin/env python3
"""Smoke run of every renderer on one GPU, through the normal entry points.

    python chip_smoke.py               # one card, full size
    python chip_smoke.py --four-cards  # the sharded paths on four cards
    python chip_smoke.py --rehearse    # every phase, tiny, on the CPU

One process drives the card.  The phases, in order:

  1. card: JAX's device and, from `nvidia-smi`, the name and power limit;
  2. megakernel build: compile the north-star kernel, memory analysis;
  3. megakernel against its plain reference, per pixel (512^2, 64 spp,
     depth 20), and against the jax.random XLA wavefront, statistically;
  4. the north star through the CLI `render` (512^2, 2048 spp, depth 20),
     checked against the plain XLA render at equal spp;
  5. engine timings: megakernel against XLA (Cornell, pt_glass), staged
     against unstaged on the mesh engine (bunny-5k);
  6. AccPathTracer through the registry: pt_glass, conductors, the env-map
     scene and bunny-5k;
  7. RayCast; 8. MetropolisLightTransport; 9. the compile cache.

A phase that fails raises, and the script exits non-zero without its last
line.  Without a GPU it exits non-zero (except with --rehearse, which never
prints "ok": true).  The last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Images and the long output go to chiprun_out/.
"""
import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

FULL = dict(ns=(512, 2048, 20), ref=(512, 64, 20), glass=(512, 2048, 20),
            env=(512, 1024, 8), bunny=(500, 256, 20), raycast=512,
            mlt=(500, 4096, 4096, 20), reps=3, mlt4=(500, 4096, 512, 4))
TINY = dict(ns=(16, 8, 3), ref=(16, 4, 3), glass=(16, 8, 3),
            env=(16, 8, 3), bunny=(16, 2, 3), raycast=16,
            mlt=(16, 16, 8, 4), reps=1, mlt4=(16, 16, 8, 4))


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line(rehearse: bool) -> str:
    """`nvidia-smi` name and power limit, read by a child off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        if rehearse:
            return "card: (no nvidia-smi in a rehearsal)"
        raise
    return "card: " + out.replace("\n", " | ")


def block_corr(a, b, block: int) -> float:
    """Correlation of the `block` x `block`-pixel means of two (H, W, 3)
    images.  Two independent renders differ pixel by pixel by their Monte
    Carlo noise; block means keep the image and average the noise down."""
    import numpy as np
    h, w = (a.shape[0] // block) * block, (a.shape[1] // block) * block

    def means(x):
        return np.asarray(x)[:h, :w].reshape(
            h // block, block, w // block, block, -1).mean(axis=(1, 3))
    return float(np.corrcoef(means(a).reshape(-1),
                             means(b).reshape(-1))[0, 1])


def median_time(fn, reps: int):
    """Warm-up call, then the median wall time of `reps` calls, each
    ending in block_until_ready.  Returns (median_s, all_s, last_out)."""
    import jax
    jax.block_until_ready(fn(0))
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(1 + r))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times, out


class Smoke:
    def __init__(self, rehearse: bool):
        import jax
        import numpy as np
        import nrenderer_tpu
        self.jax, self.np = jax, np
        self.rehearse = rehearse
        self.cfg = TINY if rehearse else FULL
        nrenderer_tpu.enable_compilation_cache()
        nrenderer_tpu._register_builtin_renderers()
        OUT.mkdir(exist_ok=True)

    # -- helpers ---------------------------------------------------------
    def check(self, ok: bool, what: str) -> None:
        """Enforce a statistical bound.  A rehearsal's tiny films are too
        noisy for the full-size bounds, so there they are only reported."""
        if ok:
            return
        if self.rehearse:
            log(f"  (rehearsal, not enforced: {what})")
            return
        raise RuntimeError(what)

    def scene(self, name):
        from nrenderer_tpu import load_scn
        from nrenderer_tpu.resources import scene_path
        return load_scn(scene_path(name))

    def static(self, scene):
        from nrenderer_tpu import build_scene_arrays
        from nrenderer_tpu.ops.camera import make_camera
        from nrenderer_tpu.ops.intersect import make_static_scene
        arr = build_scene_arrays(scene)
        return arr, make_static_scene(arr), make_camera(scene.camera)

    def bunny_scene(self):
        from nrenderer_tpu import load_obj
        from nrenderer_tpu.resources import bunny_path
        scene = self.scene("path_tracing_cornel.scn")
        load_obj(bunny_path("5k"), scene, material=0)
        m = scene.models[-1]
        m.scale = (600.0,) * 3
        m.translation = (40.0, -305.0, 920.0)
        return scene

    def registry_render(self, renderer, scene, size, spp, depth, name,
                        component=None):
        """Render through ComponentManager (the CLI's path); checks the
        image is finite and not black.  Returns (seconds, rgb)."""
        from nrenderer_tpu.io.image import write_png
        from nrenderer_tpu.server.manager import ComponentManager
        ro = scene.render_option
        ro.width = ro.height = size
        ro.samples_per_pixel, ro.depth = spp, depth
        mgr = ComponentManager()
        t0 = time.perf_counter()
        mgr.exec(renderer, scene, component=component)
        result = mgr.wait()
        dt = time.perf_counter() - t0
        if result is None:
            raise RuntimeError(f"{renderer} on {name} failed")
        rgb = self.np.asarray(result.pixels)[..., :3]
        write_png(str(OUT / f"{name}.png"), result.pixels)
        if not self.np.isfinite(rgb).all() or rgb.max() <= 0.05:
            raise RuntimeError(f"{name}: image not finite or black "
                               f"(max {rgb.max()})")
        log(f"  {name}: {renderer} {size}x{size} spp={spp} depth={depth} "
            f"in {dt:.3f}s (incl. compile), mean {rgb.mean():.4f}")
        return dt, rgb

    # -- phases ----------------------------------------------------------
    def phase_card(self):
        jax = self.jax
        d = jax.devices()[0]
        log(f"  jax: platform={d.platform} kind={d.device_kind} "
            f"count={len(jax.devices())} version={jax.__version__}")
        self.card = card_line(self.rehearse)
        log("  " + self.card)

    def phase_build(self):
        from nrenderer_tpu.ops import pt_pallas as P
        _, ss, cam = self.static(self.scene("path_tracing_cornel.scn"))
        size, spp, depth = self.cfg["ns"]
        run = P._build_kernel(
            P._hashable_static_scene(ss), P._camera_tuple(cam), size, size,
            spp, depth, P.scene_epsilon(ss), False, self.rehearse,
            (P.BLOCK, P.NUM_WARPS, P.NUM_STAGES))
        t0 = time.perf_counter()
        compiled = run.lower(self.jax.numpy.asarray([0], "int32")).compile()
        log(f"  compiled {size}^2 spp={spp} depth={depth} "
            f"(BLOCK={P.BLOCK}, num_warps={P.NUM_WARPS}) in "
            f"{time.perf_counter() - t0:.2f}s")
        log(f"  memory_analysis: {compiled.memory_analysis()}")

    def phase_reference(self):
        np = self.np
        from nrenderer_tpu.ops import pt_pallas as P
        from nrenderer_tpu.ops.sampling import make_base_key
        from nrenderer_tpu.renderers.simple_pt import (build_linear_chunk_fn,
                                                       pick_chunk)
        size, spp, depth = self.cfg["ref"]
        for name, bsdf in (("path_tracing_cornel.scn", False),
                           ("pt_glass.scn", True)):
            _, ss, cam = self.static(self.scene(name))
            k = np.asarray(P.render_pt_pallas_linear(
                ss, cam, size, size, spp, depth, seed=11, bsdf=bsdf,
                interpret=self.rehearse)) / spp
            r = np.asarray(P.render_reference_linear(
                ss, cam, size, size, spp, depth, seed=11, bsdf=bsdf)) / spp
            d = np.abs(k - r)
            mean_d = float(d.mean())
            frac = float((d.max(axis=-1) > 1e-2).mean())
            log(f"  {name}: mean|d|={mean_d:.3e} (<= 1e-4), "
                f"pixels |d|>1e-2: {frac:.5f} (<= 0.001)")
            if not np.isfinite(k).all():
                raise RuntimeError(f"megakernel film not finite on {name}")
            self.check(mean_d <= 1e-4 and frac <= 1e-3,
                       f"megakernel disagrees with its plain reference on "
                       f"{name}")
        # statistically against the jax.random XLA wavefront, equal spp
        arr, ss, cam = self.static(self.scene("path_tracing_cornel.scn"))
        chunk = pick_chunk(size, size, spp)
        fn = build_linear_chunk_fn(ss, size, size, depth, chunk, False,
                                   False)
        key = make_base_key(0)
        xla = sum(np.asarray(fn(cam, arr.env_map, key, s))
                  for s in range(spp // chunk)) / spp
        n = 4
        passes = np.stack([np.asarray(P.render_pt_pallas_linear(
            ss, cam, size, size, spp // n, depth, seed=100 + s,
            interpret=self.rehearse)) / (spp // n) for s in range(n)])
        sigma_px = passes.std(axis=0, ddof=1) / np.sqrt(n)
        sigma_mean = float(np.sqrt((sigma_px ** 2).sum()) / sigma_px.size)
        kern = np.asarray(P.render_pt_pallas_linear(
            ss, cam, size, size, spp, depth, seed=11,
            interpret=self.rehearse)) / spp
        diff = abs(float(kern.mean()) - float(xla.mean()))
        bound = 3.0 * np.sqrt(2.0) * sigma_mean
        log(f"  vs XLA wavefront: |mean diff|={diff:.3e}, 3 sigma={bound:.3e}"
            f" (means {kern.mean():.5f} / {xla.mean():.5f})")
        self.check(diff <= bound, "megakernel mean outside 3 sigma of XLA")

    def phase_north_star(self):
        np = self.np
        from nrenderer_tpu import cli
        from nrenderer_tpu.io.image import read_png
        from nrenderer_tpu.ops.sampling import make_base_key
        from nrenderer_tpu.renderers.engine import choose_engine
        from nrenderer_tpu.renderers.simple_pt import (build_render_fn,
                                                       pick_chunk)
        from nrenderer_tpu.resources import scene_path
        size, spp, depth = self.cfg["ns"]
        out = OUT / "north_star.png"
        argv = ["render", "--scene", scene_path("path_tracing_cornel.scn"),
                "--renderer", "SimplePathTracer", "--width", str(size),
                "--height", str(size), "--spp", str(spp), "--depth",
                str(depth), "--out", str(out)]
        walls = []
        for _ in range(2 if self.rehearse else 1 + self.cfg["reps"]):
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise RuntimeError("CLI render failed")
            walls.append(time.perf_counter() - t0)
        warm = statistics.median(walls[1:])
        arr, ss, cam = self.static(self.scene("path_tracing_cornel.scn"))
        engine = choose_engine(ss, mesh=False, has_lens=False, textures=None)
        log(f"  CLI render [{engine}]: first call {walls[0]:.3f}s, "
            f"set-up (compile) {walls[0] - warm:.3f}s, warm {warm:.3f}s "
            f"(median of {walls[1:]}), {spp / warm:.1f} spp/s, "
            f"{size * size * spp * depth / warm / 1e9:.3f} G bounce-rays/s")
        img = read_png(str(out))
        fn = build_render_fn(ss, size, size, spp, depth,
                             pick_chunk(size, size, spp), False, False)
        ref = np.clip(np.asarray(fn(cam, arr.env_map, make_base_key(5)))
                      [::-1], 0.0, 1.0)
        dm = abs(float(img.mean()) - float(ref.mean()))
        corr = float(np.corrcoef(img.reshape(-1), ref.reshape(-1))[0, 1])
        bcorr = block_corr(img, ref, 8)
        log(f"  vs plain XLA render at {spp} spp: |mean diff|={dm:.4f} "
            f"(< 0.01), per-pixel corr={corr:.4f}, corr of 8x8 block "
            f"means={bcorr:.4f} (> 0.99)")
        self.check(dm < 0.01 and bcorr > 0.99,
                   "north star disagrees with the XLA render")

    def phase_engines(self):
        np, jax = self.np, self.jax
        from nrenderer_tpu.ops import pt_pallas as P
        from nrenderer_tpu.ops.bvh import build_mesh_engine
        from nrenderer_tpu.ops.pt_core import make_mat_channels
        from nrenderer_tpu.ops.sampling import make_base_key
        from nrenderer_tpu.renderers import acc_pt, simple_pt
        reps = self.cfg["reps"]
        size, spp, depth = self.cfg["ns"]
        chunk = simple_pt.pick_chunk(size, size, spp)
        for name, bsdf in (("path_tracing_cornel.scn", False),
                           ("pt_glass.scn", True)):
            arr, ss, cam = self.static(self.scene(name))
            kern = lambda s: P.render_pt_pallas_linear(  # noqa: E731
                ss, cam, size, size, spp, depth, seed=s, bsdf=bsdf,
                interpret=self.rehearse)
            build = acc_pt.build_render_fn if bsdf else \
                simple_pt.build_render_fn
            fn = build(ss, size, size, spp, depth, chunk, False, False)
            xla = (lambda s: fn(cam, arr.env_map, make_base_key(s), None)) \
                if bsdf else (lambda s: fn(cam, arr.env_map,
                                           make_base_key(s)))
            tk, allk, _ = median_time(kern, reps)
            tx, allx, _ = median_time(xla, reps)
            log(f"  {name} {size}^2 {spp} spp depth {depth}: megakernel "
                f"{tk:.4f}s {allk}, XLA wavefront {tx:.4f}s {allx}, "
                f"XLA/megakernel {tx / tk:.2f}x")
        size, spp, depth = self.cfg["bunny"]
        scene = self.bunny_scene()
        arr, ss, cam = self.static(scene)
        chunk = simple_pt.pick_chunk(size, size, spp)
        t0 = time.perf_counter()
        tri = jax.block_until_ready(build_mesh_engine(arr,
                                                      make_mat_channels(ss)))
        t_build = time.perf_counter() - t0
        for staged in (False, True):
            fn = acc_pt.build_render_fn(ss, size, size, spp, depth, chunk,
                                        False, False, True, False, staged)
            t0 = time.perf_counter()
            jax.block_until_ready(fn(cam, arr.env_map, make_base_key(0), tri))
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            img = np.asarray(jax.block_until_ready(
                fn(cam, arr.env_map, make_base_key(1), tri)))
            t_warm = time.perf_counter() - t0
            log(f"  bunny-5k {size}^2 {spp} spp depth {depth}: BVH walk "
                f"staged={staged!s:5s}: warm {t_warm:.3f}s, first call "
                f"{t_first:.3f}s, build {t_build:.3f}s, mean {img.mean():.4f}")

    def phase_acc(self):
        sys.path.insert(0, str(ROOT / "examples"))
        from conductors_grid import build_scene as conductors_scene
        from nrenderer_tpu.resources import attach_env_map
        size, spp, depth = self.cfg["glass"]
        self.registry_render("AccPathTracer", self.scene("pt_glass.scn"),
                             size, spp, depth, "acc_pt_glass")
        self.registry_render("AccPathTracer", conductors_scene(), size, spp,
                             depth, "acc_conductors")
        size, spp, depth = self.cfg["env"]
        self.registry_render(
            "AccPathTracer", attach_env_map(self.scene("env_map_spheres.scn")),
            size, spp, depth, "acc_env_map")
        size, spp, depth = self.cfg["bunny"]
        self.registry_render("AccPathTracer", self.bunny_scene(), size, spp,
                             depth, "acc_bunny5k")

    def phase_raycast(self):
        size = self.cfg["raycast"]
        scene = self.scene("ray_cast_cornel.scn")
        self.registry_render("RayCast", scene, size, 1, 1, "raycast")
        dt, _ = self.registry_render("RayCast", scene, size, 1, 1, "raycast")
        log(f"  RayCast warm {dt:.4f}s")

    def phase_mlt(self):
        from nrenderer_tpu.renderers.mlt import MetropolisRenderer
        size, chains, muts, depth = self.cfg["mlt"]
        log(f"  budget: {chains} chains x {muts} mutations "
            f"({chains * muts / 1e6:.2f} M), {size}^2, depth {depth}")
        dt, _ = self.registry_render(
            "MetropolisLightTransport", self.scene("Metropolis.scn"), size,
            1, depth, "mlt",
            component=MetropolisRenderer(chains=chains, mutations=muts))
        log(f"  {chains * muts / dt / 1e6:.3f} M mutations/s incl. compile")

    def phase_cache(self):
        import nrenderer_tpu
        d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
            nrenderer_tpu.CACHE_DIR
        n = len(os.listdir(d)) if os.path.isdir(d) else 0
        log(f"  compile cache: {d}, {n} entries")

    # -- four cards ------------------------------------------------------
    def phase_sharded_render(self):
        np, jax = self.np, self.jax
        from jax.sharding import PartitionSpec as Pspec
        from nrenderer_tpu import cli
        from nrenderer_tpu.io.image import read_png
        from nrenderer_tpu.ops.sampling import make_base_key
        from nrenderer_tpu.ops.pt_pallas import render_simple_pt_pallas
        from nrenderer_tpu.parallel.mesh import _linear_film, make_mesh
        from nrenderer_tpu.renderers.simple_pt import trace_diffuse_wavefront
        from nrenderer_tpu.resources import scene_path
        size, spp, depth = self.cfg["ns"]
        out = OUT / "north_star_4cards.png"
        argv = ["render", "--scene", scene_path("path_tracing_cornel.scn"),
                "--renderer", "SimplePathTracer", "--width", str(size),
                "--height", str(size), "--spp", str(spp), "--depth",
                str(depth), "--devices", "4", "--out", str(out)]
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise RuntimeError("sharded CLI render failed")
            walls.append(time.perf_counter() - t0)
        img4 = read_png(str(out))
        _, ss, cam = self.static(self.scene("path_tracing_cornel.scn"))
        # the one-card film: the megakernel, an independent sample stream
        t0 = time.perf_counter()
        one = np.clip(np.asarray(jax.block_until_ready(
            render_simple_pt_pallas(ss, cam, size, size, spp, depth, seed=9,
                                    interpret=self.rehearse)))[::-1],
                      0.0, 1.0)
        t_one = time.perf_counter() - t0
        dm = abs(float(img4.mean()) - float(one.mean()))
        corr = block_corr(img4, one, 8)
        log(f"  render --devices 4: first {walls[0]:.3f}s, warm "
            f"{walls[1]:.3f}s; one card (megakernel, incl. compile) "
            f"{t_one:.3f}s; |mean diff|={dm:.4f} (< 0.01), corr of 8x8 "
            f"block means={corr:.4f} (> 0.99)")
        self.check(dm < 0.01 and corr > 0.99,
                   "4-card film disagrees with one card")
        # the four partial films: one per device, none empty
        mesh = make_mesh(4)
        axis = mesh.axis_names[0]

        def shard_fn(cam, seeds):
            trace = lambda o, d, k: trace_diffuse_wavefront(  # noqa: E731
                ss, o, d, k, depth)
            key = jax.random.fold_in(make_base_key(0), seeds[0])
            return _linear_film(trace, cam, size, size, 1, 1, key)[None]

        films = jax.jit(jax.shard_map(
            shard_fn, mesh=mesh, in_specs=(Pspec(), Pspec(axis)),
            out_specs=Pspec(axis), check_vma=False))(
                cam, jax.numpy.arange(4, dtype="int32"))
        devs = {s.device for s in films.addressable_shards}
        sums = [float(np.asarray(s.data).sum())
                for s in films.addressable_shards]
        log(f"  partial films on {len(devs)} devices "
            f"({sorted(d.id for d in devs)}), sums {sums}")
        if len(devs) != 4 or min(sums) <= 0.0:
            raise RuntimeError("the four films do not come from four devices")

    def phase_sharded_mlt(self):
        np = self.np
        from nrenderer_tpu.parallel.mesh import make_mesh
        from nrenderer_tpu.parallel.mlt import render_mlt_sharded
        from nrenderer_tpu.renderers.mlt import render_mlt
        size, chains, muts, depth = self.cfg["mlt4"]
        log(f"  cut: depth {depth} (phase 8 of the one-card run renders "
            f"depth {self.cfg['mlt'][3]}), so that the two MLT programs "
            f"compile in a short four-card call")

        def scene():
            s = self.scene("Metropolis.scn")
            s.render_option.width = s.render_option.height = size
            s.render_option.depth = depth
            return s
        t0 = time.perf_counter()
        four = render_mlt_sharded(scene(), chains=chains, mutations=muts,
                                  seed=1, mesh=make_mesh(4))[..., :3]
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = render_mlt(scene(), chains=chains, mutations=muts,
                         seed=2)[..., :3]
        t1 = time.perf_counter() - t0
        dm = abs(float(four.mean()) - float(one.mean()))
        # a few mutations per pixel: correlate 20 x 20-pixel block means
        b = max(1, size // 25)
        corr = block_corr(four, one, b)
        log(f"  MLT {chains}x{muts} depth {depth} at {size}^2: 4 cards "
            f"{t4:.3f}s, one card {t1:.3f}s (both incl. compile); "
            f"|mean diff|={dm:.4f}, corr of {b}x{b} block means={corr:.4f}")
        if not np.isfinite(four).all():
            raise RuntimeError("chain-sharded MLT film not finite")
        self.check(dm < 0.03 and corr > 0.9,
                   "chain-sharded MLT disagrees with one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded render and sharded MLT on "
                         "four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="every phase at a tiny size on the CPU")
    args = ap.parse_args()
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    import jax
    if not args.rehearse and jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(jax.devices()) < n_cards:
        print(f"chip_smoke.py: {n_cards} devices needed, "
              f"{len(jax.devices())} found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smoke = Smoke(args.rehearse)
    phases = [("card", smoke.phase_card)]
    if args.four_cards:
        phases += [("sharded render (--devices 4)", smoke.phase_sharded_render),
                   ("chain-sharded MLT", smoke.phase_sharded_mlt)]
    else:
        phases += [("megakernel build", smoke.phase_build),
                   ("megakernel vs plain reference", smoke.phase_reference),
                   ("north star through the CLI", smoke.phase_north_star),
                   ("engine timings", smoke.phase_engines),
                   ("AccPathTracer", smoke.phase_acc),
                   ("RayCast", smoke.phase_raycast),
                   ("MetropolisLightTransport", smoke.phase_mlt),
                   ("compile cache", smoke.phase_cache)]
    t_all = time.perf_counter()
    for i, (name, fn) in enumerate(phases, 1):
        log(f"== phase {i}: {name}")
        t0 = time.perf_counter()
        fn()
        log(f"   phase {i} done in {time.perf_counter() - t0:.1f}s")
    log(f"all phases in {time.perf_counter() - t_all:.1f}s")
    log(smoke.card)
    if args.rehearse:
        log("rehearsal: every phase passed (no card, no result)")
        return 0
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
