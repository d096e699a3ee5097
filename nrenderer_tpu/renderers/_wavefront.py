"""Shared wavefront film-loop builder for the XLA render engines.

SimplePathTracer and AccPathTracer differ only in their bounce physics; the
film loop around it — pixel jitter, thin lens, spp-chunk scan, linear film
accumulation, sqrt gamma — is identical (reference `renderTask`,
`SimplePathTracer.cpp:19-37` / `AccPathTracer.cpp:18-38`).  This module holds
the single implementation both renderers close over."""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.camera import CameraParams, shoot_v3
from ..ops.sampling import uniform_circle
from ..ops.compact import shift_pack_channels
from ..ops.soa import V3, to_array


def stage_plan(depth: int):
    """Static shrink schedule for the staged wavefront: (first_bounce,
    buffer_shrink_denominator) pairs.  Boundaries are ABSOLUTE bounce
    indices, not fractions of depth: the alive curve is bounce-indexed
    physics (survival per bounce), independent of where the depth cap
    sits.  Calibrated on the measured bunny-5k curve — alive 39.9% at
    bounce 6, 19.5% at 11, 9.8% at 16 — so each 1/2, 1/4, 1/8 buffer has
    a ~4-10%% margin and the russian-roulette backstop almost never fires
    on mesh-in-box workloads, while brighter scenes stay unbiased (RR
    reweighting)."""
    return [(0, 1)] + [(b, k) for b, k in ((6, 2), (11, 4), (16, 8))
                       if b < depth]


def build_staged_wavefront_fn(width: int, height: int, spp: int, chunk: int,
                              has_lens: bool, bounce_fn: Callable,
                              finish_fn: Callable, depth: int,
                              linear: bool = False) -> Callable:
    """Film loop with WAVEFRONT COMPACTION: as rays die, the whole ray
    state (o, d, throughput, radiance, pixel id) is packed into smaller
    static buffers at scheduled bounce boundaries, so the per-bounce cost
    tracks the alive count instead of the launch count.  On the bunny-5k
    depth-20 workload the alive fraction decays 100% -> 6.5% (measured);
    `stage_plan`'s 6/11/16 boundaries cut total bounce work ~1.7x.

    Unbiasedness: a stage buffer of n/k slots can overflow if more than
    n/k rays are alive at the boundary.  Overflow is resolved by russian
    roulette — each alive ray survives with probability q = 0.97*cap/alive
    (1 if it fits) and survivors are reweighted by 1/q — the standard
    unbiased path-termination tool, used here only as a backstop.  The
    0.97 margin makes the binomial tail past `cap` astronomically unlikely
    (sd ~ sqrt(cap) << 0.03*cap); any residual overflow rays are dropped
    by the fixed-size pack.

    `bounce_fn(o, d, thr, rad, alive, key, env_map, tri_bvh, textures) ->
    (o, d, thr, rad, alive)` runs ONE bounce on the current buffer (the
    last three are the render fn's traced args, passed through so scene
    tables stay arguments, not baked constants);
    `finish_fn(thr, rad, alive) -> V3`
    applies the depth-cap ambient term.  Radiance is banked into the
    (n_pix,) film at every boundary (dense reshape-reduce while the buffer
    is still pixel-aligned, scatter-add afterwards) and the packed
    radiance restarts at zero, so dropped rays lose nothing."""
    n_pix = width * height
    n_rays = n_pix * chunk
    n_steps = spp // chunk
    plan = stage_plan(depth)  # strictly increasing boundaries, all < depth
    jj = np.tile(np.tile(np.arange(width, dtype=np.float32), height), chunk)
    ii = np.tile(np.repeat(np.arange(height, dtype=np.float32), width), chunk)

    @jax.jit
    def render(cam: CameraParams, env_map, key, tri_bvh=None,
               textures=None):
        jjd = jnp.asarray(jj)
        iid = jnp.asarray(ii)

        def step(film, it):
            k = jax.random.fold_in(key, it)
            k_jx, k_jy, k_lens, k_path = jax.random.split(k, 4)
            rx = jax.random.uniform(k_jx, (n_rays,), minval=-1.0, maxval=1.0)
            ry = jax.random.uniform(k_jy, (n_rays,), minval=-1.0, maxval=1.0)
            x = (jjd + rx) / width
            y = (iid + ry) / height
            if has_lens:
                lens = uniform_circle(k_lens, (n_rays,))
                lens_uv = (lens[..., 0], lens[..., 1])
            else:
                lens_uv = None
            o, d = shoot_v3(cam, x, y, lens_uv=lens_uv)
            ones = jnp.ones((n_rays,), jnp.float32)
            zeros = jnp.zeros((n_rays,), jnp.float32)
            thr = V3(ones, ones, ones)
            rad = V3(zeros, zeros, zeros)
            alive = jnp.ones((n_rays,), jnp.bool_)
            pix = None  # implicit (slot % n_pix) until the first pack
            fx, fy, fz = film

            def bounce_scan(carry, b):
                o, d, thr, rad, alive = carry
                kb = jax.random.fold_in(k_path, b)
                return bounce_fn(o, d, thr, rad, alive, kb, env_map,
                                 tri_bvh, textures), None

            for si, (b0, shrink) in enumerate(plan):
                b1 = plan[si + 1][0] if si + 1 < len(plan) else depth
                if si > 0:
                    # ---- bank radiance, then RR-pack the alive rays ----
                    n_cur = o.x.shape[0]
                    cap = n_rays // shrink
                    if pix is None:
                        fx = fx + rad.x.reshape(-1, n_pix).sum(axis=0)
                        fy = fy + rad.y.reshape(-1, n_pix).sum(axis=0)
                        fz = fz + rad.z.reshape(-1, n_pix).sum(axis=0)
                        pix = jnp.tile(
                            jnp.arange(n_pix, dtype=jnp.int32),
                            n_cur // n_pix)
                    else:
                        f3 = jnp.stack([fx, fy, fz], axis=-1).at[pix].add(
                            jnp.stack([rad.x, rad.y, rad.z], axis=-1))
                        fx, fy, fz = f3[:, 0], f3[:, 1], f3[:, 2]
                    n_alive = jnp.sum(alive.astype(jnp.int32))
                    # keep everything when the buffer fits; only roulette
                    # on genuine overflow
                    q = jnp.where(
                        n_alive <= cap, 1.0,
                        0.97 * cap
                        / jnp.maximum(n_alive, 1).astype(jnp.float32))
                    u = jax.random.uniform(
                        jax.random.fold_in(k_path, 7000 + si), (n_cur,))
                    keep = alive & (u < q)
                    inv_q = 1.0 / q
                    # log-shift pack (ops/compact) of the 10 state
                    # channels
                    packed, _, n_keep = shift_pack_channels(
                        keep, (o.x, o.y, o.z, d.x, d.y, d.z,
                               thr.x, thr.y, thr.z, pix), cap)
                    ox, oy, oz, dx, dy, dz, tx, ty, tz, pixp = packed
                    slot_ok = jnp.arange(cap, dtype=jnp.int32) < n_keep
                    o = V3(ox, oy, oz)
                    d = V3(dx, dy, dz)
                    thr = V3(tx * inv_q, ty * inv_q, tz * inv_q)
                    zc = jnp.zeros((cap,), jnp.float32)
                    rad = V3(zc, zc, zc)
                    alive = slot_ok
                    pix = jnp.where(slot_ok, pixp, 0)
                (o, d, thr, rad, alive), _ = jax.lax.scan(
                    bounce_scan, (o, d, thr, rad, alive),
                    jnp.arange(b0, b1, dtype=jnp.int32))

            rad = finish_fn(thr, rad, alive)
            if pix is None:
                fx = fx + rad.x.reshape(-1, n_pix).sum(axis=0)
                fy = fy + rad.y.reshape(-1, n_pix).sum(axis=0)
                fz = fz + rad.z.reshape(-1, n_pix).sum(axis=0)
            else:
                f3 = jnp.stack([fx, fy, fz], axis=-1).at[pix].add(
                    jnp.stack([rad.x, rad.y, rad.z], axis=-1))
                fx, fy, fz = f3[:, 0], f3[:, 1], f3[:, 2]
            return (fx, fy, fz), None

        zeros = jnp.zeros((n_pix,), jnp.float32)
        (fx, fy, fz), _ = jax.lax.scan(
            step, (zeros, zeros, zeros), jnp.arange(n_steps, dtype=jnp.int32))
        if linear:
            return to_array(V3(fx, fy, fz)).reshape(n_pix, 3)
        inv = 1.0 / float(spp)
        color = V3(jnp.sqrt(jnp.maximum(fx * inv, 0.0)),
                   jnp.sqrt(jnp.maximum(fy * inv, 0.0)),
                   jnp.sqrt(jnp.maximum(fz * inv, 0.0)))
        return to_array(color).reshape(height, width, 3)

    return render


def build_wavefront_fn(width: int, height: int, spp: int, chunk: int,
                       has_lens: bool, trace_fn: Callable,
                       linear: bool = False) -> Callable:
    """Compile the film loop around `trace_fn(o, d, key, env_map, tri_bvh,
    textures) -> V3 radiance`.

    Returns `fn(cam, env_map, key, tri_bvh=None, textures=None)`; with
    `linear=False` an (H, W, 3) gamma'd image (row 0 = BOTTOM), else the
    (n_pix, 3) LINEAR film SUM over `spp` samples (chunked/progressive
    accumulation).  `textures` (tuple of (H, W, 3) arrays) are traced args,
    so texture contents never invalidate the compile cache."""
    n_pix = width * height
    n_rays = n_pix * chunk
    n_steps = spp // chunk
    jj = np.tile(np.tile(np.arange(width, dtype=np.float32), height), chunk)
    ii = np.tile(np.repeat(np.arange(height, dtype=np.float32), width), chunk)

    @jax.jit
    def render(cam: CameraParams, env_map, key, tri_bvh=None,
               textures=None):
        jjd = jnp.asarray(jj)
        iid = jnp.asarray(ii)

        def step(film, it):
            k = jax.random.fold_in(key, it)
            k_jx, k_jy, k_lens, k_path = jax.random.split(k, 4)
            rx = jax.random.uniform(k_jx, (n_rays,), minval=-1.0, maxval=1.0)
            ry = jax.random.uniform(k_jy, (n_rays,), minval=-1.0, maxval=1.0)
            x = (jjd + rx) / width   # 2px-wide jitter, UniformInSquare
            y = (iid + ry) / height
            if has_lens:
                lens = uniform_circle(k_lens, (n_rays,))
                lens_uv = (lens[..., 0], lens[..., 1])
            else:
                lens_uv = None
            o, d = shoot_v3(cam, x, y, lens_uv=lens_uv)
            radiance = trace_fn(o, d, k_path, env_map, tri_bvh, textures)
            fx, fy, fz = film
            fx = fx + radiance.x.reshape(chunk, n_pix).sum(axis=0)
            fy = fy + radiance.y.reshape(chunk, n_pix).sum(axis=0)
            fz = fz + radiance.z.reshape(chunk, n_pix).sum(axis=0)
            return (fx, fy, fz), None

        zeros = jnp.zeros((n_pix,), jnp.float32)
        (fx, fy, fz), _ = jax.lax.scan(
            step, (zeros, zeros, zeros), jnp.arange(n_steps, dtype=jnp.int32))
        if linear:
            return to_array(V3(fx, fy, fz)).reshape(n_pix, 3)
        inv = 1.0 / float(spp)
        color = V3(jnp.sqrt(jnp.maximum(fx * inv, 0.0)),
                   jnp.sqrt(jnp.maximum(fy * inv, 0.0)),
                   jnp.sqrt(jnp.maximum(fz * inv, 0.0)))  # sqrt gamma
        return to_array(color).reshape(height, width, 3)

    return render
