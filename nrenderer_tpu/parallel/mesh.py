"""Multi-chip rendering: sample-parallel SPMD over a device mesh.

The reference's only parallelism is 16 `std::thread`s row-interleaving one
image inside one process (`SimplePathTracer.cpp:80-87`, SURVEY.md §2.9).  The
replacement scales over devices instead: the spp budget is sharded
over a 1-D `jax.sharding.Mesh` ("samples" axis) with `shard_map`; every device
renders the full image at `spp / n_devices` samples with an independent PRNG
stream, and the linear films are combined with one `psum` — the
collective replacing the reference's join barrier + shared pixel buffer.

This is data parallelism over samples, the natural decomposition for Monte
Carlo rendering (zero-variance-cost, perfectly balanced, one all-reduce of
H*W*3 floats at the end).  Pixel-space sharding is also supported for very
large films (shard the pixel axis, no collective at all).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.camera import CameraParams, shoot_v3
from ..ops.intersect import StaticScene
from ..ops.pt_core import diffuse_bounce, finish_ambient
from ..ops.sampling import make_base_key
from ..ops.soa import V3, to_array
from ..renderers.simple_pt import trace_diffuse_wavefront


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "samples",
              devices=None) -> Mesh:
    """Build a 1-D device mesh.

    `devices` defaults to the default platform's `jax.devices()`; pass an
    explicit list (e.g. `jax.devices("cpu")`) to pin the platform.  Raises if
    fewer than `n_devices` are available — silent truncation would "pass" an
    8-way dryrun on a 1-device mesh, testing no sharding at all."""
    if devices is None:
        devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    if len(devices) < n:
        raise ValueError(
            f"make_mesh({n_devices}): only {len(devices)} devices available "
            f"({devices[0].platform if devices else 'none'}); refusing to "
            "truncate to a smaller mesh")
    return Mesh(np.asarray(devices[:n]), (axis_name,))


def _linear_film(trace_fn: Callable, cam: CameraParams, width: int,
                 height: int, spp: int, chunk: int, key, row0=0,
                 rows: int = None, it0=0) -> jnp.ndarray:
    """Linear-light film sum over `spp` samples: (rows * width, 3) float32.
    `trace_fn(o, d, key) -> V3 radiance` supplies the bounce physics.
    `row0`/`rows` select a horizontal band of the film (row0 may be traced,
    e.g. an axis_index — pixel-axis sharding renders disjoint bands).
    `it0` (may be traced): global chunk-step offset — pass p of a
    host-chunked render scans steps [it0, it0 + spp/chunk), so each step
    folds the SAME key it would in a one-shot run (resume determinism)."""
    rows = height if rows is None else rows
    n_pix = width * rows
    n_rays = n_pix * chunk
    jj = jnp.tile(jnp.tile(jnp.arange(width, dtype=jnp.float32), (rows,)),
                  (chunk,))
    ii = jnp.tile(jnp.repeat(row0 + jnp.arange(rows, dtype=jnp.float32),
                             width), (chunk,))

    def step(film, it):
        k = jax.random.fold_in(key, it)
        k_jx, k_jy, k_path = jax.random.split(k, 3)
        rx = jax.random.uniform(k_jx, (n_rays,), minval=-1.0, maxval=1.0)
        ry = jax.random.uniform(k_jy, (n_rays,), minval=-1.0, maxval=1.0)
        o, d = shoot_v3(cam, (jj + rx) / width, (ii + ry) / height)
        radiance = trace_fn(o, d, k_path)
        return film + to_array(radiance).reshape(chunk, n_pix, 3).sum(axis=0), None

    film = jnp.zeros((n_pix, 3), jnp.float32)
    film, _ = jax.lax.scan(step, film,
                           it0 + jnp.arange(spp // chunk, dtype=jnp.int32))
    return film


def _build_sharded_film(trace_fn: Callable, width: int, height: int,
                        spp: int, mesh: Mesh, chunk: int) -> Callable:
    """Sample-sharded film loop over `mesh` around any trace fn.  Returns
    `fn(cam, seeds) -> (H, W, 3)` gamma'd image (row 0 = BOTTOM)."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    assert spp % (n_dev * chunk) == 0, (spp, n_dev, chunk)
    per_dev_spp = spp // n_dev

    def shard_fn(cam, seeds):
        # inside shard_map: seeds is this device's (1,) slice
        key = jax.random.fold_in(make_base_key(0), seeds[0])
        film = _linear_film(trace_fn, cam, width, height, per_dev_spp,
                            chunk, key)
        # the collective that replaces the reference's join barrier:
        return jax.lax.psum(film, axis)

    # check_vma off: the scan carries inside the trace start as unvarying
    # constants and become sample-varying after the first bounce
    sharded = jax.shard_map(shard_fn, mesh=mesh,
                            in_specs=(P(), P(axis)), out_specs=P(),
                            check_vma=False)

    @jax.jit
    def run(cam: CameraParams, seeds: jnp.ndarray) -> jnp.ndarray:
        film = sharded(cam, seeds)
        color = jnp.sqrt(jnp.maximum(film / float(spp), 0.0))
        return color.reshape(height, width, 3)

    return run


def build_sharded_render(ss: StaticScene, width: int, height: int, spp: int,
                         depth: int, mesh: Mesh,
                         chunk: int = 1) -> Callable:
    """Compile a sample-sharded SimplePathTracer render over `mesh`.

    Returns `fn(cam: CameraParams, seeds: (n_dev,) int32) -> (H, W, 3)`
    gamma'd image (row 0 = BOTTOM).  `spp` is the TOTAL sample budget and
    must be divisible by n_devices * chunk."""
    def trace(o, d, key):
        return trace_diffuse_wavefront(ss, o, d, key, depth)

    return _build_sharded_film(trace, width, height, spp, mesh, chunk)


def _build_sharded_film_pixels(trace_fn: Callable, width: int, height: int,
                               spp: int, mesh: Mesh, chunk: int) -> Callable:
    """PIXEL-axis sharding: each device renders a disjoint horizontal band
    of the film at the FULL spp budget — the literal analogue of the
    reference's row-interleaved threads (`SimplePathTracer.cpp:80-87`),
    except in contiguous bands (better ray coherence than interleave, and
    XLA concatenates the shards for free via the output sharding).  NO
    collective at all: disjoint writes, just like the reference's disjoint
    pixel rows.  Prefer this over sample sharding for very large films
    (sample sharding all-reduces H*W*3 floats; this moves nothing).

    Returns `fn(cam, seeds) -> (H, W, 3)` gamma'd image (row 0 = BOTTOM).
    `seeds[k]` seeds band k, so band k of the output equals a single-device
    `_linear_film(..., row0=k*h_loc, rows=h_loc)` render with the same seed
    up to float summation order (tested in tests/test_parallel.py)."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    assert height % n_dev == 0, (height, n_dev)
    assert spp % chunk == 0, (spp, chunk)
    h_loc = height // n_dev

    def shard_fn(cam, seeds):
        blk = jax.lax.axis_index(axis)
        key = jax.random.fold_in(make_base_key(0), seeds[0])
        return _linear_film(trace_fn, cam, width, height, spp, chunk, key,
                            row0=(blk * h_loc).astype(jnp.float32),
                            rows=h_loc)

    sharded = jax.shard_map(shard_fn, mesh=mesh,
                            in_specs=(P(), P(axis)), out_specs=P(axis),
                            check_vma=False)

    @jax.jit
    def run(cam: CameraParams, seeds: jnp.ndarray) -> jnp.ndarray:
        film = sharded(cam, seeds)
        color = jnp.sqrt(jnp.maximum(film / float(spp), 0.0))
        return color.reshape(height, width, 3)

    return run


def build_sharded_render_pixels(ss: StaticScene, width: int, height: int,
                                spp: int, depth: int, mesh: Mesh,
                                chunk: int = 1) -> Callable:
    """Compile a pixel-sharded SimplePathTracer render over `mesh` (each
    device owns a horizontal film band; see `_build_sharded_film_pixels`)."""
    def trace(o, d, key):
        return trace_diffuse_wavefront(ss, o, d, key, depth)

    return _build_sharded_film_pixels(trace, width, height, spp, mesh, chunk)


def build_sharded_render_acc_pixels(ss: StaticScene, width: int,
                                    height: int, spp: int, depth: int,
                                    mesh: Mesh, chunk: int = 1,
                                    tri_bvh=None, env_map=None,
                                    textures=None) -> Callable:
    """Pixel-sharded AccPathTracer (4-BSDF) render over `mesh`: each device
    owns a horizontal film band at the full spp budget, no collective
    (see `_build_sharded_film_pixels`).  Scene acceleration structures are
    replicated constants, same as the sample-sharded variant."""
    from ..renderers.acc_pt import trace_bsdf_wavefront

    def trace(o, d, key):
        return trace_bsdf_wavefront(ss, o, d, key, depth, env_map=env_map,
                                    tri_bvh=tri_bvh, textures=textures)

    return _build_sharded_film_pixels(trace, width, height, spp, mesh, chunk)


def build_sharded_render_acc(ss: StaticScene, width: int, height: int,
                             spp: int, depth: int, mesh: Mesh,
                             chunk: int = 1, tri_bvh=None,
                             env_map=None, textures=None) -> Callable:
    """Compile a sample-sharded AccPathTracer (4-BSDF) render over `mesh`.

    `tri_bvh` (from `bvh.build_mesh_engine`), `env_map` and
    `textures` are baked into the program as constants — XLA replicates
    them to every device, exactly what read-only render data wants."""
    from ..renderers.acc_pt import trace_bsdf_wavefront

    def trace(o, d, key):
        return trace_bsdf_wavefront(ss, o, d, key, depth, env_map=env_map,
                                    tri_bvh=tri_bvh, textures=textures)

    return _build_sharded_film(trace, width, height, spp, mesh, chunk)


def _build_sharded_pass(trace_fn: Callable, width: int, height: int,
                        pass_spp: int, mesh: Mesh, chunk: int,
                        shard: str = "samples") -> Callable:
    """One host-chunked PASS of a sharded render: returns
    `fn(cam, seeds, it0) -> (H*W, 3)` LINEAR film sum over `pass_spp`
    samples, where `it0` is the pass's global chunk-step offset (see
    `_linear_film`).  The host accumulates passes, posts previews, and
    snapshots the film — composing checkpoint/resume and progressive
    preview with `--devices`.  Summing whole passes keeps
    a resume equal to a straight run: pass results depend only on
    (seed, it0), up to the order of the device's float sums, and the host
    adds them in pass order either way."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    if shard == "pixels":
        assert height % n_dev == 0, (height, n_dev)
        assert pass_spp % chunk == 0, (pass_spp, chunk)
        h_loc = height // n_dev

        def shard_fn(cam, seeds, it0):
            blk = jax.lax.axis_index(axis)
            key = jax.random.fold_in(make_base_key(0), seeds[0])
            return _linear_film(trace_fn, cam, width, height, pass_spp,
                                chunk, key, row0=(blk * h_loc).astype(
                                    jnp.float32), rows=h_loc, it0=it0)

        sharded = jax.shard_map(shard_fn, mesh=mesh,
                                in_specs=(P(), P(axis), P()),
                                out_specs=P(axis), check_vma=False)
    else:
        assert pass_spp % (n_dev * chunk) == 0, (pass_spp, n_dev, chunk)
        per_dev_spp = pass_spp // n_dev

        def shard_fn(cam, seeds, it0):
            key = jax.random.fold_in(make_base_key(0), seeds[0])
            film = _linear_film(trace_fn, cam, width, height, per_dev_spp,
                                chunk, key, it0=it0)
            return jax.lax.psum(film, axis)

        sharded = jax.shard_map(shard_fn, mesh=mesh,
                                in_specs=(P(), P(axis), P()),
                                out_specs=P(), check_vma=False)

    @jax.jit
    def run(cam: CameraParams, seeds: jnp.ndarray, it0) -> jnp.ndarray:
        return sharded(cam, seeds, jnp.asarray(it0, jnp.int32))

    return run


def render_multichip_resumable(
        trace_fn: Callable, cam: CameraParams, width: int, height: int,
        spp: int, mesh: Mesh, seed: int = 0, chunk: int = 1,
        shard: str = "samples", passes: int = None,
        checkpoint_path: str = None, fingerprint_parts=(),
        fingerprint_arrays=(), screen=None, on_preview=None) -> np.ndarray:
    """Host-chunked sharded render with checkpoint/resume + progressive
    previews — the multi-device counterpart of
    `renderers.simple_pt.render_progressive` (a framework
    that adds distribution must carry its aux subsystems across it).

    The spp budget splits into `passes` equal passes (default: one per
    chunk-step, capped at 16); after each pass the linear film is
    snapshotted to `checkpoint_path` and a gamma'd preview is posted to
    `screen` / `on_preview`.  Resume re-runs from the first missing pass
    with identical per-step PRNG keys, so an interrupted render finishes
    equal to a straight run up to the float order of the cross-device sum
    (tested in tests/test_parallel.py).

    Returns the gamma'd (H, W, 3) image, row 0 = BOTTOM (same contract as
    the other multichip entry points)."""
    from ..server.checkpoint import (
        camera_key, load_checkpoint, render_fingerprint, save_checkpoint)

    n_dev = mesh.devices.size
    steps_total = spp // chunk // (n_dev if shard == "samples" else 1)
    if passes is None:
        passes = min(16, steps_total)
    while steps_total % passes:
        passes -= 1  # equal whole-step passes
    steps_pp = steps_total // passes
    pass_spp = spp // passes

    mesh_fp = (mesh.axis_names, tuple(d.id for d in mesh.devices.flat),
               tuple(d.platform for d in mesh.devices.flat))
    fingerprint = render_fingerprint(
        ("multichip", shard, mesh_fp, camera_key(cam), width, height, spp,
         seed, chunk, passes) + tuple(fingerprint_parts),
        arrays=fingerprint_arrays)

    film = np.zeros((width * height, 3), np.float32)
    start = 0
    if checkpoint_path:
        loaded = load_checkpoint(checkpoint_path, fingerprint)
        if loaded is not None:
            film, spp_done = loaded
            start = spp_done // pass_spp
            from ..server.registry import get_server
            get_server().logger.log(
                f"multichip resume at {spp_done}/{spp} spp "
                f"from {checkpoint_path}")

    pass_fn = _build_sharded_pass(trace_fn, width, height, pass_spp, mesh,
                                  chunk, shard=shard)
    seeds = jnp.arange(seed, seed + n_dev, dtype=jnp.int32)
    for p in range(start, passes):
        film = film + np.asarray(pass_fn(cam, seeds, p * steps_pp))
        spp_done = (p + 1) * pass_spp
        if checkpoint_path:
            save_checkpoint(checkpoint_path, film, spp_done, width, height,
                            seed, fingerprint)
        if screen is not None or on_preview is not None:
            img = np.sqrt(np.maximum(film / spp_done, 0.0))
            img = img.reshape(height, width, 3)[::-1]  # row 0 = top
            if screen is not None:
                screen.set(np.concatenate(
                    [img, np.ones((height, width, 1), np.float32)], axis=2),
                    width, height)
            if on_preview is not None:
                on_preview(spp_done, img)
    return np.sqrt(np.maximum(film / spp, 0.0)).reshape(height, width, 3)


def render_multichip(ss: StaticScene, cam: CameraParams, width: int,
                     height: int, spp: int, depth: int,
                     mesh: Optional[Mesh] = None, seed: int = 0,
                     chunk: int = 1) -> jnp.ndarray:
    """Convenience wrapper: sample-parallel render across all local devices."""
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    fn = build_sharded_render(ss, width, height, spp, depth, mesh,
                              chunk=chunk)
    seeds = jnp.arange(seed, seed + n_dev, dtype=jnp.int32)
    return fn(cam, seeds)


def render_multichip_acc(ss: StaticScene, cam: CameraParams, width: int,
                         height: int, spp: int, depth: int,
                         mesh: Optional[Mesh] = None, seed: int = 0,
                         chunk: int = 1, tri_bvh=None,
                         env_map=None, textures=None) -> jnp.ndarray:
    """Convenience wrapper: sample-parallel 4-BSDF render across devices."""
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    fn = build_sharded_render_acc(ss, width, height, spp, depth, mesh,
                                  chunk=chunk, tri_bvh=tri_bvh,
                                  env_map=env_map, textures=textures)
    seeds = jnp.arange(seed, seed + n_dev, dtype=jnp.int32)
    return fn(cam, seeds)
