"""SimplePathTracer: diffuse Monte Carlo path tracing as a wavefront megakernel.

Rebuild of the simple_path_tracing plugin
(`components/simple_path_tracing/src/SimplePathTracer.cpp`).  Estimator per
bounce (`trace`, `SimplePathTracer.cpp:144-177`):

    depth cap          -> ambient.constant
    object before light-> Le + BRDF * Li * cos(n, wi) / pdf
    area light hit     -> its radiance
    miss               -> black (or env map if ambient type is ENVIRONMENT_MAP
                          — a capability the reference declares but never
                          implements; see ops/env.py)

Lambertian sampling matches `shaders/Lambertian.cpp:15-46`: uniform hemisphere
about the stored (unflipped) normal via the Onb, pdf = 1/(2 pi),
BRDF = albedo / pi, so throughput *= 2 * albedo * cos.

Design (vs the reference's 16 row-interleaved std::threads and bounded
recursion), for the XLA wavefront engine:

  - recursion -> `lax.scan` over the bounce index with component-SoA path
    state ((N,) planes, see ops/soa.py) — no (N, 3) lane waste
  - the scene's ~20 primitives are UNROLLED into the kernel as constants
    (ops.intersect.intersect_scene_unrolled): the whole closest-hit +
    area-light + Lambertian bounce compiles to ONE fused elementwise kernel;
    no (P, N) intermediates, no gathers — the hit material's albedo is
    tracked as running channels during the masked-min scan
  - 16 threads -> one (H*W*C)-ray wavefront per scan step; an outer scan
    walks spp chunks accumulating the film in f32
  - thread_local time-seeded RNG -> counter-based PRNG folded per
    (chunk, bounce), race-free and reproducible
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

import os

from ..ops.camera import CameraParams, make_camera, shoot_v3
from ..ops.env import sample_env_map_v3
from ..ops.intersect import (
    T_MIN_PT, StaticScene, intersect_area_lights_unrolled,
    intersect_scene_unrolled, make_static_scene,
)
from ..ops.pt_core import diffuse_bounce, finish_ambient, scene_epsilon
from ..ops.sampling import make_base_key, uniform_circle
from ..ops.soa import V3, to_array
from ..scene.arrays import SceneArrays, build_scene_arrays
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from .engine import MEGAKERNEL, choose_engine


def trace_diffuse_wavefront(ss: StaticScene, o: V3, d: V3, key, depth: int,
                            env_map=None, t_min: float = None,
                            textures=None) -> V3:
    """Trace an (N,)-ray wavefront for `depth` diffuse bounces; returns V3
    radiance.  `env_map` (traced (He,We,3) array) enables env-map misses.

    The bounce physics is the shared `ops.pt_core.diffuse_bounce`, also used
    verbatim by the GPU megakernel — the two engines differ only in how
    uniforms are drawn and where state lives."""
    n = o.x.shape[0]
    zeros = jnp.zeros((n,), o.x.dtype)
    ones = jnp.ones((n,), o.x.dtype)
    throughput = V3(ones, ones, ones)
    radiance = V3(zeros, zeros, zeros)
    alive = jnp.ones((n,), jnp.bool_)
    albedo_ch = [tuple(m["diffuse"]) for m in ss.mats]
    if t_min is None:
        t_min = scene_epsilon(ss, T_MIN_PT)

    def bounce(carry, b):
        o, d, throughput, radiance, alive = carry
        kb = jax.random.fold_in(key, b)
        k1, k2 = jax.random.split(kb)
        u1 = jax.random.uniform(k1, (n,))
        u2 = jax.random.uniform(k2, (n,))
        if env_map is not None:
            # missing rays keep their o/d/throughput, so the env term can
            # be added AFTER the bounce from its own closest-hit result —
            # no second intersection pass
            o, d, throughput, radiance, alive, miss = diffuse_bounce(
                ss, albedo_ch, o, d, throughput, radiance, alive, u1, u2,
                t_min=t_min, with_miss=True, textures=textures)
            env = sample_env_map_v3(env_map, d)
            ew = miss.astype(o.x.dtype)
            radiance = V3(radiance.x + ew * throughput.x * env.x,
                          radiance.y + ew * throughput.y * env.y,
                          radiance.z + ew * throughput.z * env.z)
        else:
            o, d, throughput, radiance, alive = diffuse_bounce(
                ss, albedo_ch, o, d, throughput, radiance, alive, u1, u2,
                t_min=t_min, textures=textures)
        return (o, d, throughput, radiance, alive), None

    (o, d, throughput, radiance, alive), _ = jax.lax.scan(
        bounce, (o, d, throughput, radiance, alive),
        jnp.arange(depth, dtype=jnp.int32))

    return finish_ambient(ss, throughput, radiance, alive)


def build_render_fn(ss: StaticScene, width: int, height: int, spp: int,
                    depth: int, chunk: int, has_lens: bool,
                    use_env: bool) -> Callable:
    """Compile a full-render function closed over the static scene.

    Returns `fn(cam: CameraParams, env_map, key) -> (H, W, 3)` image
    (row 0 = BOTTOM)."""
    from ._wavefront import build_wavefront_fn

    def trace(o, d, key, env_map, tri_bvh, textures):
        return trace_diffuse_wavefront(
            ss, o, d, key, depth, env_map=env_map if use_env else None,
            textures=textures)

    return build_wavefront_fn(width, height, spp, chunk, has_lens, trace)


def build_linear_chunk_fn(ss: StaticScene, width: int, height: int,
                          depth: int, chunk: int, has_lens: bool,
                          use_env: bool, textures=None) -> Callable:
    """One progressive pass: `fn(cam, env_map, key, step) -> (n_pix, 3)`
    linear film SUM over `chunk` samples per pixel (step indexes the PRNG
    stream, so passes are independent estimates)."""
    n_pix = width * height
    n_rays = n_pix * chunk
    jj = np.tile(np.tile(np.arange(width, dtype=np.float32), height), chunk)
    ii = np.tile(np.repeat(np.arange(height, dtype=np.float32), width), chunk)

    @jax.jit
    def one_pass(cam: CameraParams, env_map, key, step):
        k = jax.random.fold_in(key, step)
        k_jx, k_jy, k_lens, k_path = jax.random.split(k, 4)
        rx = jax.random.uniform(k_jx, (n_rays,), minval=-1.0, maxval=1.0)
        ry = jax.random.uniform(k_jy, (n_rays,), minval=-1.0, maxval=1.0)
        x = (jnp.asarray(jj) + rx) / width
        y = (jnp.asarray(ii) + ry) / height
        if has_lens:
            lens = uniform_circle(k_lens, (n_rays,))
            lens_uv = (lens[..., 0], lens[..., 1])
        else:
            lens_uv = None
        o, d = shoot_v3(cam, x, y, lens_uv=lens_uv)
        radiance = trace_diffuse_wavefront(
            ss, o, d, k_path, depth, env_map=env_map if use_env else None,
            textures=textures)
        return to_array(radiance).reshape(chunk, n_pix, 3).sum(axis=0)

    return one_pass


def render_progressive(scene_arrays, ss: StaticScene, cam, width, height,
                       spp, depth, seed=0, has_lens=False, use_env=False,
                       checkpoint_path=None, preview_every=1,
                       on_preview=None):
    """Progressive render with live Screen previews and checkpoint/resume.

    The reference posts the film exactly once at the end (SURVEY.md §5.5 "no
    progressive preview"); here each pass updates the shared Screen and can
    snapshot the linear film so an interrupted render resumes (§5.4)."""
    from ..server.checkpoint import (
        camera_key, load_checkpoint, render_fingerprint, save_checkpoint)

    chunk = pick_chunk(width, height, spp)
    n_steps = spp // chunk
    textures = scene_arrays.textures if ss.tri_uv else None
    # the fingerprint must cover everything that changes the estimator —
    # including the CAMERA and the env/texture pixels (review r3: omitting
    # them let a resume after `--camera-position` blend two viewpoints)
    fingerprint = render_fingerprint(
        (ss, camera_key(cam), width, height, spp, depth, seed, chunk,
         has_lens, use_env),
        arrays=((np.asarray(scene_arrays.env_map),) if use_env else ())
        + tuple(textures or ()))
    film = np.zeros((width * height, 3), np.float32)
    start = 0
    if checkpoint_path:
        loaded = load_checkpoint(checkpoint_path, fingerprint)
        if loaded is not None:
            film, spp_done = loaded
            start = spp_done // chunk
            get_server().logger.log(
                f"resumed at {spp_done}/{spp} spp from {checkpoint_path}")

    if choose_engine(ss, mesh=False, has_lens=has_lens,
                     textures=textures) == MEGAKERNEL:
        from ..ops.pt_pallas import render_pt_pallas_linear
        fn = lambda cam, env, key, step: render_pt_pallas_linear(  # noqa: E731
            ss, cam, width, height, chunk, depth, seed=seed * 100003 + step)
    else:
        fn = build_linear_chunk_fn(ss, width, height, depth, chunk,
                                   has_lens, use_env, textures=textures)
    key = make_base_key(seed)
    for step in range(start, n_steps):
        film = film + np.asarray(fn(cam, scene_arrays.env_map, key, step))
        spp_done = (step + 1) * chunk
        if (step + 1) % preview_every == 0 or step == n_steps - 1:
            img = np.sqrt(np.maximum(film / spp_done, 0.0))
            img = img.reshape(height, width, 3)[::-1]
            get_server().screen.set(
                np.concatenate([img, np.ones((height, width, 1),
                                             np.float32)], axis=2),
                width, height)
            if on_preview:
                on_preview(spp_done, img)
        if checkpoint_path:
            save_checkpoint(checkpoint_path, film, spp_done, width, height,
                            seed, fingerprint)
    img = np.sqrt(np.maximum(film / spp, 0.0)).reshape(height, width, 3)
    return np.clip(img[::-1], 0.0, 1.0)


def pick_chunk(width: int, height: int, spp: int,
               budget_rays: int = 1 << 21) -> int:
    """Largest spp-divisor chunk keeping the wavefront under ~budget rays."""
    n_pix = max(1, width * height)
    best = 1
    for c in range(1, spp + 1):
        if spp % c == 0 and n_pix * c <= budget_rays:
            best = c
    return best


def _fingerprint(ss: StaticScene, *shape_args) -> str:
    h = hashlib.sha1(repr((ss, shape_args)).encode()).hexdigest()
    return h


_FN_CACHE: Dict[str, Callable] = {}


def get_render_fn(ss: StaticScene, width, height, spp, depth, chunk,
                  has_lens, use_env) -> Callable:
    key = _fingerprint(ss, width, height, spp, depth, chunk, has_lens,
                       use_env)
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = build_render_fn(ss, width, height, spp, depth, chunk, has_lens,
                             use_env)
        _FN_CACHE[key] = fn
    return fn


@register_renderer("SimplePathTracer", description=(
    "A simple path tracer.\n"
    "Diffuse Monte Carlo path tracing as a single jitted wavefront."))
class SimplePathTracerRenderer(RenderComponent):
    def __init__(self, seed: int = 0, checkpoint_path: str = None,
                 progressive: bool = False, preview_every: int = 1):
        self.seed = seed
        self.checkpoint_path = checkpoint_path or os.environ.get(
            "NR_CHECKPOINT")
        self.progressive = progressive or bool(self.checkpoint_path) or \
            os.environ.get("NR_PROGRESSIVE") == "1"
        self.preview_every = preview_every

    def render(self, scene: Scene) -> RenderResult:
        # per-render phase stats, logged like the reference's per-thread
        # intersect timing (`SimplePathTracer.cpp:90-94`, SURVEY §5.1)
        from ..utils.timing import GLOBAL_TIMER, PhaseTimer
        timer = PhaseTimer()
        ro = scene.render_option
        w, h, spp, depth = (ro.width, ro.height, ro.samples_per_pixel,
                            ro.depth)
        with timer.phase("scene-prep"):
            arrays = build_scene_arrays(scene)
            ss = make_static_scene(arrays)
            cam = make_camera(scene.camera)
        use_env = ss.ambient_type == 1
        has_lens = scene.camera.aperture > 0
        if self.progressive:
            img = render_progressive(
                arrays, ss, cam, w, h, spp, depth, seed=self.seed,
                has_lens=has_lens, use_env=use_env,
                checkpoint_path=self.checkpoint_path,
                preview_every=self.preview_every)
            get_server().logger.log("Done...")
            rgba = np.concatenate(
                [img, np.ones((h, w, 1), np.float32)], axis=2)
            return RenderResult(pixels=rgba, width=w, height=h)
        textures = arrays.textures if ss.tri_uv else None
        engine = choose_engine(ss, mesh=False, has_lens=has_lens,
                               textures=textures)
        if engine == MEGAKERNEL:
            from ..ops.pt_pallas import render_simple_pt_pallas
            with timer.phase(f"render[{engine}]"):
                img = np.asarray(render_simple_pt_pallas(
                    ss, cam, w, h, spp, depth, seed=self.seed))
        else:
            chunk = pick_chunk(w, h, spp)
            fn = get_render_fn(ss, w, h, spp, depth, chunk, has_lens,
                               use_env)
            with timer.phase(f"render[{engine}]"):
                img = np.asarray(fn(cam, arrays.env_map,
                                    make_base_key(self.seed),
                                    None, textures))
        with timer.phase("host-post"):
            img = img[::-1]  # bottom-up -> row 0 top
            img = np.clip(img, 0.0, 1.0)  # Screen.set clamp (Screen.cpp:63)
        GLOBAL_TIMER.add("SimplePathTracer.render",
                         timer.get(f"render[{engine}]").total_s)
        get_server().logger.log("phases: " + timer.summary())
        get_server().logger.log("Done...")
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)
