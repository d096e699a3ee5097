"""Chain-sharded MLT: Markov chains SPMD over a device mesh.

The reference's MLT parallelism is 8 racy `std::thread`s mutating one
shared film (`metropolis_light_transport/src/Metropolis.cpp:7,94-101`,
SURVEY.md §2.9).  The single-chip rebuild already replaces that with
thousands of lockstep lane-parallel chains (renderers/mlt.py); this module
shards the CHAIN axis over a `jax.sharding.Mesh` with `shard_map`:

  - every device runs `chains / n_devices` chains with a device-folded PRNG
    stream (race-free by construction, SURVEY §5.2)
  - the brightness estimate b is one scalar `psum` (each device contributes
    its init-sample sum)
  - each device splats into its own film; one `psum` of (H*W, 3) floats at
    flush combines them — the collective that replaces the reference's
    racy shared-buffer writes

The per-device chain pipeline is the SAME `MLTKernel` the single-chip
driver uses; block-resumable compiles and the `_finish_mlt` driver loop are
reused verbatim (the sharded functions have identical call signatures)."""
from __future__ import annotations

import hashlib
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.sampling import make_base_key
from ..renderers.mlt import (
    LARGE_STEP_PROB, _finish_mlt, _prepare_mlt, film_bucket,
)
from ..scene.model import Scene
from .mesh import make_mesh

_SHARDED_MLT_CACHE: Dict[str, tuple] = {}


def render_mlt_sharded(scene: Scene, chains: int = 4096,
                       mutations: int = 256, n_init: int = 10000,
                       seed: int = 0, mesh: Optional[Mesh] = None,
                       max_path: int = None,
                       checkpoint_path: str = None) -> np.ndarray:
    """Chain-sharded MLT render over `mesh`; same output contract as
    `renderers.mlt.render_mlt` ((H, W, 4) RGBA, row 0 = TOP).  `chains` is
    the TOTAL chain count and must divide by the device count.

    `checkpoint_path`: the shared `_finish_mlt` driver
    snapshots the full sharded chain carry after every block — leaves are
    materialized to host numpy and re-sharded on resume by the shard_map
    in_specs — so an interrupted sharded render resumes to the same film,
    up to the order of the splat's atomic adds on the GPU."""
    import os
    mesh = mesh or make_mesh()
    n_dev = int(mesh.devices.size)
    axis = mesh.axis_names[0]
    prep = _prepare_mlt(scene, max_path)
    if prep is None:
        ro = scene.render_option
        return np.zeros((ro.height, ro.width, 4), np.float32)
    kern, width, height = prep
    assert chains % n_dev == 0, (chains, n_dev)
    c_loc = chains // n_dev
    ns = kern.n_states
    cap = film_bucket(width * height)
    key = make_base_key(seed)
    block = min(mutations, int(os.environ.get("NR_MLT_BLOCK", "128")))

    # Mesh identity (axis names + device ids) must be in the key: the mesh is
    # baked into the compiled shard_map closures, so a later call with the
    # same n_dev but a different device subset/axis would otherwise get
    # functions compiled against the old mesh.  Resolution is
    # NOT in the key: w/h are traced args and the film is bucket-padded,
    # so one compile serves every resolution in the bucket.
    mesh_fp = (mesh.axis_names, tuple(d.id for d in mesh.devices.flat),
               tuple(d.platform for d in mesh.devices.flat))
    cache_key = hashlib.sha1(repr(
        (kern.ss, kern.cam, kern.max_path, kern.emitted,
         kern.light_pos, kern.light_u, kern.light_v, chains, n_init, block,
         n_dev, mesh_fp, cap)).encode()).hexdigest()
    # resume-compat fingerprint: compile key + everything else shaping the
    # estimator (same contract as the single-device driver, renderers/mlt)
    ck_fp = repr((cache_key, width, height, chains, mutations, block, seed))
    cached = _SHARDED_MLT_CACHE.get(cache_key)
    if cached is not None:
        return _finish_mlt(*cached, key, width, height, chains, mutations,
                           block, checkpoint_path, ck_fp)

    def dev_key(key):
        return jax.random.fold_in(key, jax.lax.axis_index(axis))

    # carry: (film (n_dev, cap, 3) dev-sharded, u (ns, C), contribs
    # 6 x (n_combo, C), sc (C,), w_acc (C,)) — C sharded on its last/only axis
    carry_specs = (P(axis), P(None, axis),
                   (P(None, axis),) * 6, P(axis), P(axis))
    wh_spec = (P(), P())

    def splat(film, contribs, weight, wh):
        w_, h_ = wh
        wi = w_.astype(jnp.int32)
        hi = h_.astype(jnp.int32)
        px, py, cr, cg, cb, valid = contribs
        ix = px.astype(jnp.int32)
        iy = py.astype(jnp.int32)
        ok = (valid & (ix >= 0) & (ix < wi) & (iy >= 0) & (iy < hi))
        flat = jnp.where(ok, iy * wi + ix, cap)  # cap = out of bounds
        w = weight[None, :]
        vals = jnp.stack([cr * w, cg * w, cb * w], axis=-1)
        return film.at[flat.reshape(-1)].add(vals.reshape(-1, 3),
                                             mode="drop")

    # ONE compiled sharded sample serves the b phase AND the chain init
    # (round 4, VERDICT r3 #3 — same structure as the single-device
    # driver): the b phase host-loops the shared executable.  Keying: a
    # fresh batch i uses dev_key(fold_in(key, i)) — per-device streams
    # stay independent, batches stay independent.
    def _sample_sm(key, wh):
        u = jax.random.uniform(dev_key(key), (ns, c_loc))
        contribs, sc = kern.sample(u, wh)
        return u, contribs, sc

    sample_fresh = jax.jit(jax.shard_map(
        _sample_sm, mesh=mesh, in_specs=(P(), wh_spec),
        out_specs=(P(None, axis), (P(None, axis),) * 6, P(axis)),
        check_vma=False))

    def estimate_b(key, wh):
        steps = max(1, n_init // chains)
        total = 0.0
        for i in range(steps):
            _, _, sc = sample_fresh(jax.random.fold_in(key, i), wh)
            total += float(jnp.sum(sc))
        return total / (steps * chains)

    def init_chains(key, wh):
        u_cur, contribs, sc_cur = sample_fresh(key, wh)
        film = jnp.zeros((n_dev, cap, 3))
        film = jax.device_put(film, jax.sharding.NamedSharding(
            mesh, P(axis)))
        w_acc = jnp.zeros((chains,))
        w_acc = jax.device_put(w_acc, jax.sharding.NamedSharding(
            mesh, P(axis)))
        return (film, u_cur, contribs, sc_cur, w_acc)

    def _block_sm(key, b, carry, wh):
        k_dev = dev_key(key)

        def step(carry, i):
            film, u_cur, cur_contribs, sc_cur, w_acc = carry
            k = jax.random.fold_in(k_dev, i)
            k1, k2, k3 = jax.random.split(k, 3)
            is_large = jax.random.uniform(k1, (c_loc,)) <= LARGE_STEP_PROB
            u_fresh = jax.random.uniform(k2, (ns, c_loc))
            u_mut = kern.mutate(u_cur, k3, wh)
            u_prop = jnp.where(is_large[None, :], u_fresh, u_mut)
            prop_contribs, sc_prop = kern.sample(u_prop, wh)

            a = jnp.where(sc_cur > 0,
                          jnp.clip(sc_prop / jnp.where(sc_cur > 0, sc_cur,
                                                       1.0), 0.0, 1.0), 1.0)
            ilf = is_large.astype(jnp.float32)
            w_prop = jnp.where(sc_prop > 0,
                               (a + ilf) / (sc_prop / b + LARGE_STEP_PROB),
                               0.0)
            w_cur_step = jnp.where(sc_cur > 0,
                                   (1.0 - a) / (sc_cur / b
                                                + LARGE_STEP_PROB), 0.0)
            w_acc = w_acc + w_cur_step

            k4 = jax.random.fold_in(k, 777)
            accept = jax.random.uniform(k4, (c_loc,)) <= a

            aw = accept.astype(jnp.float32)
            splat_weight = aw * w_acc + (1.0 - aw) * w_prop
            splat_contribs = tuple(
                jnp.where(accept[None, :], c, p)
                for c, p in zip(cur_contribs, prop_contribs))
            film = splat(film[0], splat_contribs, splat_weight, wh)[None]

            new_contribs = tuple(
                jnp.where(accept[None, :], p, c)
                for c, p in zip(cur_contribs, prop_contribs))
            u_cur = jnp.where(accept[None, :], u_prop, u_cur)
            sc_cur = jnp.where(accept, sc_prop, sc_cur)
            w_acc = jnp.where(accept, w_prop, w_acc)
            return (film, u_cur, new_contribs, sc_cur, w_acc), None

        carry, _ = jax.lax.scan(step, carry,
                                jnp.arange(block, dtype=jnp.int32))
        return carry

    run_block = jax.jit(jax.shard_map(
        _block_sm, mesh=mesh, in_specs=(P(), P(), carry_specs, wh_spec),
        out_specs=carry_specs, check_vma=False))

    def _flush_sm(carry, wh):
        film, u_cur, cur_contribs, sc_cur, w_acc = carry
        local = splat(film[0], cur_contribs, w_acc, wh)
        return jax.lax.psum(local, axis)

    flush_film = jax.jit(jax.shard_map(
        _flush_sm, mesh=mesh, in_specs=(carry_specs, wh_spec), out_specs=P(),
        check_vma=False))

    _SHARDED_MLT_CACHE[cache_key] = (estimate_b, init_chains, run_block,
                                     flush_film)
    return _finish_mlt(estimate_b, init_chains, run_block, flush_film, key,
                       width, height, chains, mutations, block,
                       checkpoint_path, ck_fp)
