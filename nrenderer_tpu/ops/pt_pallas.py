"""Path-tracing megakernel for the GPU (Pallas, Triton route), and its plain
reference.

The whole render of a dense scene — camera rays, the spp x depth bounce
loop over the unrolled primitives, area-light hits, BSDF sampling and the
film — runs as ONE `pallas_call`.  Each program owns a 1-D block of `BLOCK`
pixels, one path per thread, with the path state in registers for the whole
loop; device memory sees one film write per pixel.  The XLA wavefront
instead reads and writes ~14 carried floats per ray at every bounce.

Scene primitives and the camera are folded into the kernel as constants
(one compile per scene and camera, cached).  Uniforms come from the
stateless counter-based `pt_core.hash_uniform`, so every (pixel, sample,
bounce, site) draw is independent of the launch layout.  The physics is the
shape-agnostic `pt_core.diffuse_bounce` / `pt_core.bsdf_bounce` that the XLA
engine uses.

`render_reference_linear` is the plain reference: the same per-pixel
estimator and hash draws as `jnp` over the whole film, compiled by XLA.  The
kernel must agree with it pixel by pixel up to float contraction.

Scope: dense scenes with constant ambient, a pinhole camera and no textures
(`renderers.engine.choose_engine`); env maps, textures, lenses and meshes
render on the XLA wavefront.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .intersect import StaticScene
from .pt_core import (
    bsdf_bounce, diffuse_bounce, finish_ambient, hash_uniform,
    make_mat_channels, scene_epsilon,
)
from .soa import V3

# Pixels per program (a power of two, as Triton requires) and its launch
# shape; tuned on the card (PERF.md).
BLOCK = 256
NUM_WARPS = 8
NUM_STAGES = 1


def _camera_tuple(cam) -> Tuple[float, ...]:
    """CameraParams -> hashable tuple of floats for kernel baking."""
    f = lambda a: tuple(float(x) for x in np.asarray(a).reshape(-1))  # noqa: E731
    return (f(cam.position) + f(cam.lower_left) + f(cam.horizontal)
            + f(cam.vertical))


def _sample_radiance(ss: StaticScene, cam: Tuple[float, ...], width: int,
                     height: int, depth: int, t_min: float, bsdf: bool,
                     pid, sp, seed) -> V3:
    """Radiance of sample `sp` of pixels `pid` (any 1-D int32 shape): the
    per-pixel estimator shared by the kernel and the plain reference."""
    (px0, py0, pz0, llx, lly, llz, hx, hy, hz, vx, vy, vz) = cam
    pyi = pid // width
    pxf = (pid - pyi * width).astype(jnp.float32)
    pyf = pyi.astype(jnp.float32)
    # pixel jitter in [-1, 1] (UniformInSquare)
    s = (pxf + hash_uniform(pid, sp, 0, seed) * 2.0 - 1.0) \
        * jnp.float32(1.0 / width)
    t = (pyf + hash_uniform(pid, sp, 1, seed) * 2.0 - 1.0) \
        * jnp.float32(1.0 / height)
    dx = llx + s * hx + t * vx - px0
    dy = lly + s * hy + t * vy - py0
    dz = llz + s * hz + t * vz - pz0
    inv_len = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    ones = jnp.ones_like(dx)
    zeros = jnp.zeros_like(dx)
    o = V3(ones * px0, ones * py0, ones * pz0)
    d = V3(dx * inv_len, dy * inv_len, dz * inv_len)
    if bsdf:
        mat_ch = make_mat_channels(ss)
    else:
        albedo_ch = [tuple(float(v) for v in m["diffuse"]) for m in ss.mats]

    def bounce(b, st):
        o, d, thr, rad, alive_f = st
        bseed = seed + b * jnp.int32(-1640531535)
        u1 = hash_uniform(pid, sp, 4, bseed)
        u2 = hash_uniform(pid, sp, 5, bseed)
        if bsdf:
            u3 = hash_uniform(pid, sp, 6, bseed)
            o, d, thr, rad, alive = bsdf_bounce(
                ss, mat_ch, o, d, thr, rad, alive_f > 0.5, u1, u2, u3,
                t_min=t_min)
        else:
            o, d, thr, rad, alive = diffuse_bounce(
                ss, albedo_ch, o, d, thr, rad, alive_f > 0.5, u1, u2,
                t_min=t_min)
        # the alive mask rides the loop as a float
        return o, d, thr, rad, alive.astype(jnp.float32)

    state = (o, d, V3(ones, ones, ones), V3(zeros, zeros, zeros), ones)
    _, _, thr, rad, alive_f = jax.lax.fori_loop(0, depth, bounce, state)
    return finish_ambient(ss, thr, rad, alive_f > 0.5)


def _pt_kernel(seed_ref, film_r, film_g, film_b, *, ss: StaticScene,
               cam: Tuple[float, ...], width: int, height: int, spp: int,
               depth: int, t_min: float, bsdf: bool, block: int):
    """One program: `block` pixels, spp samples each, summed in registers."""
    pid = (pl.program_id(0) * block
           + jax.lax.broadcasted_iota(jnp.int32, (block,), 0))
    seed = seed_ref[0]

    def sample(sp, film):
        rad = _sample_radiance(ss, cam, width, height, depth, t_min, bsdf,
                               pid, sp, seed)
        return (film[0] + rad.x, film[1] + rad.y, film[2] + rad.z)

    zeros = jnp.zeros((block,), jnp.float32)
    fr, fg, fb = jax.lax.fori_loop(0, spp, sample, (zeros, zeros, zeros))
    film_r[...] = fr
    film_g[...] = fg
    film_b[...] = fb


@functools.lru_cache(maxsize=32)
def _build_kernel(ss: StaticScene, cam: Tuple[float, ...], width: int,
                  height: int, spp: int, depth: int, t_min: float,
                  bsdf: bool, interpret: bool,
                  launch: Tuple[int, int, int]):
    """`run(seed (1,) int32) -> (n_pix, 3)` linear film SUM over `spp`.
    `launch` = (pixels per program, num_warps, num_stages)."""
    n_pix = width * height
    block_px, num_warps, num_stages = launch
    n_blocks = pl.cdiv(n_pix, block_px)
    kernel = functools.partial(_pt_kernel, ss=ss, cam=cam, width=width,
                               height=height, spp=spp, depth=depth,
                               t_min=t_min, bsdf=bsdf, block=block_px)
    plane = jax.ShapeDtypeStruct((n_blocks * block_px,), jnp.float32)
    block = pl.BlockSpec((block_px,), lambda i: (i,))

    @jax.jit
    def run(seed):
        fr, fg, fb = pl.pallas_call(
            kernel,
            grid=(n_blocks,),
            in_specs=[pl.BlockSpec((1,), lambda i: (0,))],
            out_specs=(block, block, block),
            out_shape=(plane, plane, plane),
            backend="triton",
            interpret=interpret,
            compiler_params=pl_triton.CompilerParams(
                num_warps=num_warps, num_stages=num_stages),
            name="pt_megakernel_bsdf" if bsdf else "pt_megakernel",
        )(seed)
        # the padded tail of the last block is traced and dropped
        return jnp.stack([fr[:n_pix], fg[:n_pix], fb[:n_pix]], axis=-1)

    return run


def render_pt_pallas_linear(ss: StaticScene, cam, width: int, height: int,
                            spp: int, depth: int, seed: int = 0,
                            t_min: float = None, bsdf: bool = False,
                            interpret: bool = False) -> jnp.ndarray:
    """LINEAR film SUM over `spp` samples, (n_pix, 3), row 0 = BOTTOM.
    Distinct seeds give independent passes (progressive and checkpointed
    renders).  `interpret=True` runs the kernel in the Pallas interpreter
    (tests on the CPU)."""
    if not (ss.sph or ss.tri or ss.pln):
        raise ValueError("the megakernel needs at least one primitive; "
                         "render empty scenes on the XLA wavefront")
    if t_min is None:
        t_min = scene_epsilon(ss)
    run = _build_kernel(_hashable_static_scene(ss), _camera_tuple(cam),
                        width, height, spp, depth, float(t_min), bool(bsdf),
                        bool(interpret), (BLOCK, NUM_WARPS, NUM_STAGES))
    return run(jnp.asarray([seed], jnp.int32))


def _gamma(film_sum: jnp.ndarray, spp: int, width: int,
           height: int) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(film_sum / float(spp), 0.0)).reshape(
        height, width, 3)


def render_simple_pt_pallas(ss: StaticScene, cam, width: int, height: int,
                            spp: int, depth: int, seed: int = 0,
                            t_min: float = None,
                            interpret: bool = False) -> jnp.ndarray:
    """SimplePathTracer's diffuse estimator: (H, W, 3) sqrt-gamma image,
    row 0 = BOTTOM (the contract of `simple_pt.build_render_fn`)."""
    film = render_pt_pallas_linear(ss, cam, width, height, spp, depth,
                                   seed=seed, t_min=t_min, bsdf=False,
                                   interpret=interpret)
    return _gamma(film, spp, width, height)


def render_bsdf_pt_pallas(ss: StaticScene, cam, width: int, height: int,
                          spp: int, depth: int, seed: int = 0,
                          t_min: float = None,
                          interpret: bool = False) -> jnp.ndarray:
    """AccPathTracer's multi-BSDF estimator; same contract as
    render_simple_pt_pallas."""
    film = render_pt_pallas_linear(ss, cam, width, height, spp, depth,
                                   seed=seed, t_min=t_min, bsdf=True,
                                   interpret=interpret)
    return _gamma(film, spp, width, height)


@functools.lru_cache(maxsize=8)
def _build_reference(ss: StaticScene, cam: Tuple[float, ...], width: int,
                     height: int, spp: int, depth: int, t_min: float,
                     bsdf: bool):
    n_pix = width * height

    @jax.jit
    def run(seed):
        pid = jnp.arange(n_pix, dtype=jnp.int32)

        def sample(sp, film):
            rad = _sample_radiance(ss, cam, width, height, depth, t_min,
                                   bsdf, pid, sp, seed)
            return film + jnp.stack([rad.x, rad.y, rad.z], axis=-1)

        return jax.lax.fori_loop(0, spp, sample,
                                 jnp.zeros((n_pix, 3), jnp.float32))

    return run


def render_reference_linear(ss: StaticScene, cam, width: int, height: int,
                            spp: int, depth: int, seed: int = 0,
                            t_min: float = None,
                            bsdf: bool = False) -> jnp.ndarray:
    """Plain-`jnp` reference of the megakernel: the same estimator and hash
    draws over the whole film.  (n_pix, 3) linear SUM over `spp`."""
    if t_min is None:
        t_min = scene_epsilon(ss)
    run = _build_reference(_hashable_static_scene(ss), _camera_tuple(cam),
                           width, height, spp, depth, float(t_min),
                           bool(bsdf))
    return run(jnp.int32(seed))


class _HashableScene:
    """StaticScene wrapper with structural hashing for the lru_cache."""

    def __init__(self, ss: StaticScene):
        self.ss = ss
        self._key = repr(ss)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, _HashableScene) and self._key == other._key

    def __getattr__(self, name):
        return getattr(self.ss, name)


def _hashable_static_scene(ss: StaticScene):
    if isinstance(ss, _HashableScene):
        return ss
    return _HashableScene(ss)
