"""AccPathTracer: multi-BSDF path tracing (Lambertian/conductor/glass/GGX).

Rebuild of the acc_path_tracing plugin (`components/acc_path_tracing/`):
the same estimator as SimplePathTracer but with material-type dispatch
{0 Lambertian, 1 smooth conductor, 2 dielectric glass, 3 microfacet}
(`AccPathTracer.cpp:120-181`, `acc/include/shaders/ShaderCreator.hpp:17-39`)
and acceleration for mesh-heavy scenes.

Design:
  - the reference's per-hit virtual `Shader::shade` becomes a branchless
    4-lobe blend over tracked material channels (ops/pt_core.bsdf_bounce)
  - the reference's pointer BVH + recursive traversal
    (`acc/include/BVH.hpp:93-155`) is replaced by: (a) the same unrolled
    constant-folded brute force for small scenes, and (b) one mesh engine
    for large triangle pools (`ops.bvh.build_mesh_engine`)
  - glass's two-ray recursion becomes stochastic single-lobe selection with
    identical expectation (pt_core.glass_scatter docstring)
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.camera import make_camera
from ..ops.env import sample_env_map_v3
from ..ops.intersect import T_MIN_PT, StaticScene, make_static_scene
from ..ops.pt_core import (
    bsdf_bounce, finish_ambient, make_mat_channels, scene_epsilon,
)
from ..ops.sampling import make_base_key
from ..ops.soa import V3
from ..scene.arrays import build_scene_arrays
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from .engine import MEGAKERNEL, choose_engine
from .simple_pt import pick_chunk

BVH_THRESHOLD = 64
ACC_TYPE0_MAX_TRIS = 2048  # acc_type=0 (brute force) refused past this:
# the unrolled intersect bakes every triangle into one program and a
# multi-thousand unroll does not compile in reasonable time


def trace_bsdf_wavefront(ss: StaticScene, o: V3, d: V3, key, depth: int,
                         env_map=None, tri_bvh=None,
                         t_min: float = None, textures=None) -> V3:
    """(N,)-ray wavefront with the 4-BSDF dispatch; returns V3 radiance.
    `tri_bvh`: optional (FlatBVH, TrianglePack) routing the triangle pool
    through the stackless BVH walk (mesh-heavy scenes)."""
    n = o.x.shape[0]
    zeros = jnp.zeros((n,), o.x.dtype)
    ones = jnp.ones((n,), o.x.dtype)
    throughput = V3(ones, ones, ones)
    radiance = V3(zeros, zeros, zeros)
    alive = jnp.ones((n,), jnp.bool_)
    mat_ch = make_mat_channels(ss)
    if t_min is None:
        t_min = scene_epsilon(ss, T_MIN_PT)

    def bounce(carry, b):
        o, d, throughput, radiance, alive = carry
        kb = jax.random.fold_in(key, b)
        k1, k2, k3 = jax.random.split(kb, 3)
        u1 = jax.random.uniform(k1, (n,))
        u2 = jax.random.uniform(k2, (n,))
        u3 = jax.random.uniform(k3, (n,))
        if env_map is not None:
            # missing rays keep their o/d/throughput, so the env term can
            # be added AFTER the bounce from its own closest-hit result —
            # no second intersection pass
            o, d, throughput, radiance, alive, miss = bsdf_bounce(
                ss, mat_ch, o, d, throughput, radiance, alive, u1, u2, u3,
                t_min=t_min, tri_bvh=tri_bvh, with_miss=True,
                textures=textures)
            env = sample_env_map_v3(env_map, d)
            ew = miss.astype(o.x.dtype)
            radiance = V3(radiance.x + ew * throughput.x * env.x,
                          radiance.y + ew * throughput.y * env.y,
                          radiance.z + ew * throughput.z * env.z)
        else:
            o, d, throughput, radiance, alive = bsdf_bounce(
                ss, mat_ch, o, d, throughput, radiance, alive, u1, u2, u3,
                t_min=t_min, tri_bvh=tri_bvh, textures=textures)
        return (o, d, throughput, radiance, alive), None

    (o, d, throughput, radiance, alive), _ = jax.lax.scan(
        bounce, (o, d, throughput, radiance, alive),
        jnp.arange(depth, dtype=jnp.int32))

    return finish_ambient(ss, throughput, radiance, alive)


def build_render_fn(ss: StaticScene, width: int, height: int, spp: int,
                    depth: int, chunk: int, has_lens: bool, use_env: bool,
                    use_bvh: bool = False, linear: bool = False,
                    staged: bool = False) -> Callable:
    """Compile a full-render function closed over the static scene.
    Returns fn(cam, env_map, key, tri_bvh) -> (H, W, 3), row 0 = BOTTOM.
    `tri_bvh` must be None iff use_bvh is False.  With `linear=True` the
    gamma is skipped and the LINEAR film SUM over `spp` samples is returned
    as (n_pix, 3) — used for chunked/progressive accumulation.  With
    `staged=True` the wavefront compacts its whole ray state as rays die
    (`_wavefront.build_staged_wavefront_fn`), opt-in with NR_STAGED=1."""
    from ._wavefront import build_staged_wavefront_fn, build_wavefront_fn

    if staged:
        mat_ch = make_mat_channels(ss)
        t_min = scene_epsilon(ss, T_MIN_PT)

        def bounce(o, d, thr, rad, alive, kb, env_map, tri_bvh, textures):
            n = o.x.shape[0]
            k1, k2, k3 = jax.random.split(kb, 3)
            u1 = jax.random.uniform(k1, (n,))
            u2 = jax.random.uniform(k2, (n,))
            u3 = jax.random.uniform(k3, (n,))
            if use_env:
                o, d, thr, rad, alive, miss = bsdf_bounce(
                    ss, mat_ch, o, d, thr, rad, alive, u1, u2, u3,
                    t_min=t_min, tri_bvh=tri_bvh, with_miss=True,
                    textures=textures)
                env = sample_env_map_v3(env_map, d)
                ew = miss.astype(o.x.dtype)
                rad = V3(rad.x + ew * thr.x * env.x,
                         rad.y + ew * thr.y * env.y,
                         rad.z + ew * thr.z * env.z)
            else:
                o, d, thr, rad, alive = bsdf_bounce(
                    ss, mat_ch, o, d, thr, rad, alive, u1, u2, u3,
                    t_min=t_min, tri_bvh=tri_bvh, textures=textures)
            return o, d, thr, rad, alive

        def finish(thr, rad, alive):
            return finish_ambient(ss, thr, rad, alive)

        return build_staged_wavefront_fn(width, height, spp, chunk,
                                         has_lens, bounce, finish, depth,
                                         linear=linear)

    def trace(o, d, key, env_map, tri_bvh, textures):
        return trace_bsdf_wavefront(
            ss, o, d, key, depth,
            env_map=env_map if use_env else None, tri_bvh=tri_bvh,
            textures=textures)

    return build_wavefront_fn(width, height, spp, chunk, has_lens, trace,
                              linear=linear)


_FN_CACHE: Dict[str, Callable] = {}


def get_render_fn(ss: StaticScene, *shape_args) -> Callable:
    key = hashlib.sha1(repr((ss, shape_args)).encode()).hexdigest()
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = build_render_fn(ss, *shape_args)
        _FN_CACHE[key] = fn
    return fn


def _progressive_loop(checkpoint_path, seed, timer, w, h, spp, pcall,
                      render_step, fp_parts, fp_arrays):
    """Shared chunked host loop for both engines: one device call per
    `pcall` spp, progressive Screen previews, and checkpoint/resume
    (SURVEY §5.4) — so --checkpoint works on every AccPathTracer engine.

    `render_step(step) -> (n_pix, 3)` linear film SUM over pcall samples;
    steps index disjoint PRNG streams so a resume reproduces the remaining
    steps exactly.  Returns (gamma image, start_step, n_steps)."""
    from ..server.checkpoint import (
        load_checkpoint, render_fingerprint, save_checkpoint)
    film = np.zeros((w * h, 3), np.float32)
    start = 0
    fingerprint = None
    if checkpoint_path:
        fingerprint = render_fingerprint(fp_parts, arrays=fp_arrays)
        loaded = load_checkpoint(checkpoint_path, fingerprint)
        if loaded is not None:
            film, spp_done = loaded
            start = spp_done // pcall
            get_server().logger.log(
                f"resumed at {spp_done}/{spp} spp from {checkpoint_path}")
    n_steps = spp // pcall
    for step in range(start, n_steps):
        with timer.phase("compile+first-pass" if step == start
                         else "render-pass"):
            film += np.asarray(render_step(step))
        with timer.phase("host-preview"):
            done = (step + 1) * pcall
            img = np.sqrt(np.maximum(film / done, 0.0))
            img = img.reshape(h, w, 3)[::-1]
            get_server().screen.set(
                np.concatenate([img, np.ones((h, w, 1), np.float32)],
                               axis=2), w, h)
        if checkpoint_path:
            save_checkpoint(checkpoint_path, film, (step + 1) * pcall,
                            w, h, seed, fingerprint)
    img = np.sqrt(np.maximum(film / spp, 0.0)).reshape(h, w, 3)
    return np.clip(img[::-1], 0.0, 1.0), start, n_steps


@register_renderer("AccPathTracer", description=(
    "An accelerated path tracer.\n"
    "Multi-BSDF (Lambertian/conductor/glass/microfacet) wavefront path "
    "tracing with BVH acceleration for meshes."))
class AccPathTracerRenderer(RenderComponent):
    def __init__(self, seed: int = 0, checkpoint_path: str = None):
        self.seed = seed
        self.checkpoint_path = checkpoint_path

    def render(self, scene: Scene) -> RenderResult:
        # per-render phase stats (SURVEY §5.1), logged below
        from ..utils.timing import GLOBAL_TIMER, PhaseTimer
        timer = PhaseTimer()
        ro = scene.render_option
        w, h, spp, depth = (ro.width, ro.height, ro.samples_per_pixel,
                            ro.depth)
        with timer.phase("scene-prep"):
            arrays = build_scene_arrays(scene)
            ss = make_static_scene(arrays)
            cam = make_camera(scene.camera)
        chunk = pick_chunk(w, h, spp)
        use_env = ss.ambient_type == 1
        has_lens = scene.camera.aperture > 0
        # mesh-heavy scenes route triangles through the mesh accelerator;
        # small prim sets stay on the (faster) unrolled brute force
        n_tri = int(np.asarray(arrays.tri_valid).sum())
        # acc_type (reference `Scene.hpp:23`, default 1 — stored but never
        # read by any shipped reference renderer): 0 forces brute force,
        # 1 (default) = heuristic (accelerate when the triangle pool is
        # big enough to win), 2 forces the accelerated path for any
        # non-empty pool.  A 0 on a huge pool would unroll thousands of
        # triangles into one program (uncompilable), so it is refused
        # past ACC_TYPE0_MAX_TRIS with a log line.
        acc_type = int(getattr(scene.render_option, "acc_type", 1))
        if acc_type == 0 and n_tri > ACC_TYPE0_MAX_TRIS:
            get_server().logger.warning(
                f"AccPathTracer: acc_type=0 (brute force) refused for "
                f"{n_tri} triangles (> {ACC_TYPE0_MAX_TRIS}); using the "
                "mesh engine")
            acc_type = 1
        if acc_type == 0:
            accelerate = False
        elif acc_type == 1:
            accelerate = n_tri > BVH_THRESHOLD
        else:
            accelerate = n_tri > 0
        # textures resolve at full resolution on the XLA wavefront (the
        # reference never samples textures at all, `Shader.hpp:22`)
        textures = arrays.textures if ss.tri_uv else None
        engine = choose_engine(ss, mesh=accelerate, has_lens=has_lens,
                               textures=textures)
        if engine == MEGAKERNEL:
            img = self._render_megakernel(ss, cam, w, h, spp, depth, timer)
            img = np.clip(img, 0.0, 1.0)
            get_server().logger.log("phases: " + timer.summary())
            get_server().logger.log("Done...")
            rgba = np.concatenate(
                [img, np.ones((h, w, 1), np.float32)], axis=2)
            return RenderResult(pixels=rgba, width=w, height=h)
        use_bvh = accelerate
        tri_bvh = None
        if use_bvh:
            from ..ops.bvh import build_mesh_engine
            with timer.phase("bvh-build"):
                tri_bvh = build_mesh_engine(arrays, make_mat_channels(ss))
            get_server().logger.log(
                f"AccPathTracer: mesh engine over {n_tri} triangles")
        # the staged wavefront (ray-state compaction as rays die) only with
        # NR_STAGED=1: on the bunny mesh cell its warm render is faster, but
        # its extra compile costs more than that saves in one render
        staged = os.environ.get("NR_STAGED") == "1"
        n_steps = spp // chunk
        if n_steps > 4 or (self.checkpoint_path and n_steps > 1):
            # chunked host loop: one device call per chunk gives
            # progressive Screen previews for free, and (with a
            # checkpoint_path) resumable renders — the per-step key is
            # fold_in(base, step), so a resume reproduces the remaining
            # steps exactly (SURVEY §5.4, same recipe as
            # simple_pt.render_progressive)
            from ..server.checkpoint import camera_key
            fn = get_render_fn(ss, w, h, chunk, depth, chunk, has_lens,
                               use_env, use_bvh, True, staged)
            key = make_base_key(self.seed)
            img, start, _ = _progressive_loop(
                self.checkpoint_path, self.seed, timer, w, h, spp, chunk,
                lambda step: fn(cam, arrays.env_map,
                                jax.random.fold_in(key, step),
                                tri_bvh, textures),
                (ss, camera_key(cam), w, h, spp, depth, self.seed,
                 chunk, use_bvh, staged, has_lens, use_env),
                ((np.asarray(arrays.env_map),) if use_env else ())
                + tuple(textures or ()))
            GLOBAL_TIMER.add("AccPathTracer.render",
                             timer.get("render-pass").total_s
                             if n_steps - start > 1 else
                             timer.get("compile+first-pass").total_s)
        else:
            if self.checkpoint_path:
                get_server().logger.warning(
                    f"--checkpoint: render fits a single pass "
                    f"({spp} spp, chunk {chunk}); nothing to snapshot")
            fn = get_render_fn(ss, w, h, spp, depth, chunk, has_lens,
                               use_env, use_bvh, False, staged)
            with timer.phase("render(+compile)"):
                img = np.asarray(fn(cam, arrays.env_map,
                                    make_base_key(self.seed), tri_bvh,
                                    textures))
            img = img[::-1]
            GLOBAL_TIMER.add("AccPathTracer.render",
                             timer.get("render(+compile)").total_s)
        img = np.clip(img, 0.0, 1.0)
        get_server().logger.log("phases: " + timer.summary())
        get_server().logger.log("Done...")
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)

    def _render_megakernel(self, ss, cam, w, h, spp, depth, timer):
        """GPU megakernel render -> (H, W, 3) gamma image, row 0 = top.
        With a checkpoint the in-kernel spp loop is split over ~8 launches
        so the linear film can be snapshotted between them; without one a
        single full-spp launch is fastest."""
        from ..ops.pt_pallas import (render_bsdf_pt_pallas,
                                     render_pt_pallas_linear)
        from ..utils.timing import GLOBAL_TIMER
        if self.checkpoint_path and spp > 1:
            from ..server.checkpoint import camera_key
            pcall = 1
            for k in range(1, spp + 1):
                if spp % k == 0 and k <= max(spp // 8, 1):
                    pcall = k
            img, start, n_steps = _progressive_loop(
                self.checkpoint_path, self.seed, timer, w, h, spp, pcall,
                lambda step: render_pt_pallas_linear(
                    ss, cam, w, h, pcall, depth, bsdf=True,
                    seed=self.seed * 100003 + step),
                (ss, camera_key(cam), w, h, spp, depth, self.seed, pcall,
                 MEGAKERNEL), ())
            GLOBAL_TIMER.add("AccPathTracer.render",
                             timer.get("render-pass").total_s
                             if n_steps - start > 1 else
                             timer.get("compile+first-pass").total_s)
            return img
        with timer.phase(f"render[{MEGAKERNEL}]"):
            img = np.asarray(render_bsdf_pt_pallas(ss, cam, w, h, spp, depth,
                                                   seed=self.seed))
        GLOBAL_TIMER.add("AccPathTracer.render",
                         timer.get(f"render[{MEGAKERNEL}]").total_s)
        return img[::-1]
