"""BVH: host-side build + flattened arrays for stackless device traversal.

Rebuild of the acc_path_tracing BVH (`acc_path_tracing/include/BVH.hpp:18-223`,
`Bounds3.hpp:13-168`):

  - build: midpoint-median object split — sort prim AABBs by centroid along
    the axis of maximum extent, split at size/2, recurse; leaves hold exactly
    1 primitive, matching the reference topology (`BVH.hpp:166-222`).  The
    sort is STABLE for reproducibility (the reference uses an unstable sort
    with ties, SURVEY.md §7 "hard parts").
  - traversal: the reference's recursive both-children descent
    (`BVH.hpp:93-155`) becomes a STACKLESS escape-index walk: nodes are laid
    out in depth-first preorder; on a bbox hit the walk advances to the next
    node (first child), on a miss it jumps to `skip[i]` (the subtree escape).
    This is branch-light and fixed-bound `lax.while_loop`-able.

The build itself is numpy on the host — scene setup time, not render time —
exactly as the reference builds its pointer tree on the UI thread before
spawning workers (`AccPathTracer.cpp:58-62`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def _put(a) -> jnp.ndarray:
    """Upload a ready numpy array as a plain transfer.  `jnp.asarray`
    dispatches an eager convert_element_type whose executable is compiled
    per shape; device_put of an already-typed array never compiles."""
    return jax.device_put(np.ascontiguousarray(a))


class FlatBVH(NamedTuple):
    """Preorder-flattened BVH with escape indices (device arrays)."""
    bb_min: jnp.ndarray   # (Nn, 3) float32
    bb_max: jnp.ndarray   # (Nn, 3) float32
    skip: jnp.ndarray     # (Nn,) int32: node index to jump to on bbox miss
    prim: jnp.ndarray     # (Nn,) int32: primitive index at leaf, -1 internal
    n_nodes: int          # static count


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray, use_native: bool = True
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build from per-primitive AABBs; returns flat (bb_min, bb_max, skip,
    prim) numpy arrays in depth-first preorder.

    Matches the reference's median-object split on the max-extent axis of the
    *centroid* bounds (`BVH.hpp:176-207`).

    Uses the native C++ builder (native/nrnative.cpp, ~50x faster for large
    meshes) when available; this numpy version is the fallback and the
    reference for equality tests."""
    n = bb_min.shape[0]
    if n == 0:
        return (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                np.ones((1,), np.int32), np.full((1,), -1, np.int32))
    if use_native:
        from .. import native
        built = native.build_bvh(np.asarray(bb_min, np.float32),
                                 np.asarray(bb_max, np.float32))
        if built is not None:
            return built
    centroid = (bb_min + bb_max) * 0.5

    out_min, out_max, out_skip, out_prim = [], [], [], []

    def emit(mn, mx, prim):
        out_min.append(mn)
        out_max.append(mx)
        out_skip.append(-1)   # patched after subtree emission
        out_prim.append(prim)
        return len(out_prim) - 1

    def recurse(idx: np.ndarray) -> None:
        mn = bb_min[idx].min(axis=0)
        mx = bb_max[idx].max(axis=0)
        if idx.shape[0] == 1:
            node = emit(mn, mx, int(idx[0]))
            out_skip[node] = node + 1
            return
        node = emit(mn, mx, -1)
        ext = mx - mn
        axis = int(np.argmax(ext))
        order = np.argsort(centroid[idx, axis], kind="stable")
        idx = idx[order]
        half = idx.shape[0] // 2
        recurse(idx[:half])
        recurse(idx[half:])
        out_skip[node] = len(out_prim)

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 64))
    try:
        recurse(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    return (np.asarray(out_min, np.float32), np.asarray(out_max, np.float32),
            np.asarray(out_skip, np.int32), np.asarray(out_prim, np.int32))


def flatten_bvh(bb_min: np.ndarray, bb_max: np.ndarray) -> FlatBVH:
    mn, mx, skip, prim = build_bvh(bb_min, bb_max)
    return FlatBVH(bb_min=_put(mn), bb_max=_put(mx),
                   skip=_put(skip), prim=_put(prim),
                   n_nodes=int(prim.shape[0]))


class TrianglePack(NamedTuple):
    """Device-side triangle pool for BVH leaves (component SoA)."""
    v1x: jnp.ndarray
    v1y: jnp.ndarray
    v1z: jnp.ndarray
    e1x: jnp.ndarray
    e1y: jnp.ndarray
    e1z: jnp.ndarray
    e2x: jnp.ndarray
    e2y: jnp.ndarray
    e2z: jnp.ndarray
    nx: jnp.ndarray
    ny: jnp.ndarray
    nz: jnp.ndarray
    mat: jnp.ndarray        # (T,) float material id
    channels: jnp.ndarray   # (K, T) tracked material constants
    # per-triangle texture coords (None when no face carries a map): uv at
    # v1, uv edges and the diffuse texture id; the walk interpolates the
    # winner's UV from its barycentrics (`with_uv`)
    uv1x: jnp.ndarray = None
    uv1y: jnp.ndarray = None
    ue1x: jnp.ndarray = None
    ue1y: jnp.ndarray = None
    ue2x: jnp.ndarray = None
    ue2y: jnp.ndarray = None
    tex: jnp.ndarray = None


def pack_triangles(scene_arrays, mat_channels) -> TrianglePack:
    """Build the leaf triangle pool from SceneArrays (+ per-material channel
    table, same layout as intersect_scene_unrolled's mat_channels)."""
    a = scene_arrays
    v1 = np.asarray(a.tri_v1, np.float32)
    e1 = np.asarray(a.tri_e1, np.float32)
    e2 = np.asarray(a.tri_e2, np.float32)
    n = np.asarray(a.tri_normal, np.float32)
    mat = np.asarray(a.tri_mat, np.int64)
    k = len(mat_channels[0]) if mat_channels else 0
    chan_table = np.asarray(mat_channels, np.float32).reshape(-1, k)
    channels = chan_table[mat].T if k else np.zeros((0, mat.shape[0]),
                                                    np.float32)
    f = _put
    uv_kw = {}
    if _textured(a):
        # faces carrying EITHER map need interpolated UVs; the diffuse tex
        # id rides the pool, the specularMap id rides the material channels
        # (pt_core.make_mat_channels)
        uv1 = np.asarray(a.tri_uv1, np.float32)
        ue1 = np.asarray(a.tri_uve1, np.float32)
        ue2 = np.asarray(a.tri_uve2, np.float32)
        uv_kw = dict(uv1x=f(uv1[:, 0]), uv1y=f(uv1[:, 1]),
                     ue1x=f(ue1[:, 0]), ue1y=f(ue1[:, 1]),
                     ue2x=f(ue2[:, 0]), ue2y=f(ue2[:, 1]),
                     tex=f(np.asarray(a.tri_tex, np.float32)))
    return TrianglePack(
        v1x=f(v1[:, 0]), v1y=f(v1[:, 1]), v1z=f(v1[:, 2]),
        e1x=f(e1[:, 0]), e1y=f(e1[:, 1]), e1z=f(e1[:, 2]),
        e2x=f(e2[:, 0]), e2y=f(e2[:, 1]), e2z=f(e2[:, 2]),
        nx=f(n[:, 0]), ny=f(n[:, 1]), nz=f(n[:, 2]),
        mat=f(mat.astype(np.float32)), channels=f(channels), **uv_kw)


def _textured(scene_arrays) -> bool:
    """True iff a valid face carries a diffuse or specular map."""
    a = scene_arrays
    mapped = (np.asarray(a.tri_tex) >= 0) | (np.asarray(a.tri_stex) >= 0)
    return bool(mapped[np.asarray(a.tri_valid)].any())


def build_triangle_bvh(scene_arrays) -> FlatBVH:
    """BVH over the triangle buffer only (spheres/planes stay on the dense
    unrolled path)."""
    a = scene_arrays
    v1 = np.asarray(a.tri_v1, np.float64)
    v2 = v1 + np.asarray(a.tri_e1, np.float64)
    v3 = v1 + np.asarray(a.tri_e2, np.float64)
    valid = np.asarray(a.tri_valid)
    bb_min = np.minimum(np.minimum(v1, v2), v3) - 1e-4
    bb_max = np.maximum(np.maximum(v1, v2), v3) + 1e-4
    # exclude padding rows from the tree
    idx = np.nonzero(valid)[0]
    mn, mx, skip, prim = build_bvh(bb_min[idx], bb_max[idx])
    prim = np.where(prim >= 0, idx[np.clip(prim, 0, len(idx) - 1)], -1)
    return FlatBVH(bb_min=_put(mn), bb_max=_put(mx),
                   skip=_put(skip), prim=_put(prim),
                   n_nodes=int(prim.shape[0]))


def _moller_trumbore(o, d, v1, e1, e2):
    """Moller-Trumbore in the PT conventions (`Triangle` intersect):
    returns (det, u, v, t) with det >= 0; the ray hits iff det >= 1e-6,
    0 <= u, 0 <= v, u + v <= det, and the barycentrics are u/det, v/det."""
    v1x, v1y, v1z = v1
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = d.y * e2z - d.z * e2y
    py = d.z * e2x - d.x * e2z
    pz = d.x * e2y - d.y * e2x
    det0 = e1x * px + e1y * py + e1z * pz
    sign = jnp.where(det0 > 0, 1.0, -1.0)
    det = det0 * sign
    tx = (o.x - v1x) * sign
    ty = (o.y - v1y) * sign
    tz = (o.z - v1z) * sign
    u = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = d.x * qx + d.y * qy + d.z * qz
    w = (e2x * qx + e2y * qy + e2z * qz) / jnp.where(det == 0, 1.0, det)
    return det, u, vv, w


def intersect_triangles_bvh(bvh: FlatBVH, tp: TrianglePack, o, d,
                            t_min: float = 1e-6, with_uv: bool = False):
    """Stackless escape-index BVH walk for a ray batch (component-SoA).

    Replaces the reference's recursive both-children descent
    (`acc/include/BVH.hpp:93-155`) with a preorder walk: on bbox hit advance
    to node+1 (first child), on miss jump to skip[node].  Every ray carries
    its own node cursor through one `lax.while_loop`; node/leaf data are
    (N,)-wide gathers from the flat tree tables.

    Returns (t, nx, ny, nz, mat_id, prim_id, channels tuple) like the
    unrolled kernels; t=+inf on miss.  With `with_uv` (and a textured pool)
    an extra (u, v, tex_id) triple follows: the winner's texture coords
    interpolated from its barycentrics, (0, 0, -1) on a miss."""
    import jax

    n = o.x.shape[0]
    inf = jnp.float32(jnp.inf)
    inv_dx = 1.0 / jnp.where(jnp.abs(d.x) < 1e-20, 1e-20, d.x)
    inv_dy = 1.0 / jnp.where(jnp.abs(d.y) < 1e-20, 1e-20, d.y)
    inv_dz = 1.0 / jnp.where(jnp.abs(d.z) < 1e-20, 1e-20, d.z)

    bb_min, bb_max = bvh.bb_min, bvh.bb_max
    skip, prim = bvh.skip, bvh.prim
    n_nodes = bvh.n_nodes

    def take(tab, idx):
        return jnp.take(tab, idx, axis=0, mode="clip")

    def cond(state):
        node, t_best, idx_best = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, t_best, idx_best = state
        nc = jnp.clip(node, 0, n_nodes - 1)
        bmin_x = take(bb_min[:, 0], nc)
        bmin_y = take(bb_min[:, 1], nc)
        bmin_z = take(bb_min[:, 2], nc)
        bmax_x = take(bb_max[:, 0], nc)
        bmax_y = take(bb_max[:, 1], nc)
        bmax_z = take(bb_max[:, 2], nc)
        t0x = (bmin_x - o.x) * inv_dx
        t1x = (bmax_x - o.x) * inv_dx
        t0y = (bmin_y - o.y) * inv_dy
        t1y = (bmax_y - o.y) * inv_dy
        t0z = (bmin_z - o.z) * inv_dz
        t1z = (bmax_z - o.z) * inv_dz
        t_near = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                         jnp.minimum(t0y, t1y)),
                             jnp.minimum(t0z, t1z))
        t_far = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                        jnp.maximum(t0y, t1y)),
                            jnp.maximum(t0z, t1z))
        # max(t_near, t_min) is the earliest possible in-box hit; raw
        # t_near is negative when the origin is inside the box, which
        # would defeat the cap cull for rays parked on the mesh
        hit_box = ((t_near <= t_far) & (t_far >= t_min)
                   & (jnp.maximum(t_near, t_min) < t_best))

        pidx = take(prim, nc)
        is_leaf = pidx >= 0
        pc = jnp.clip(pidx, 0, tp.v1x.shape[0] - 1)

        det, u, vv, w = _moller_trumbore(o, d, *_tri_at(tp, pc))
        tri_hit = (hit_box & is_leaf & (det >= 1e-6) & (u >= 0) & (u <= det)
                   & (vv >= 0) & (u + vv <= det) & (w >= t_min)
                   & (w < t_best))
        t_best = jnp.where(tri_hit, w, t_best)
        idx_best = jnp.where(tri_hit, pidx, idx_best)

        node = jnp.where(node >= n_nodes, node,
                         jnp.where(hit_box & ~is_leaf, node + 1,
                                   take(skip, nc)))
        return node, t_best, idx_best

    node0 = jnp.zeros((n,), jnp.int32)
    t0 = jnp.full((n,), inf)
    i0 = jnp.full((n,), -1, jnp.int32)
    node, t_best, idx_best = jax.lax.while_loop(cond, body,
                                                (node0, t0, i0))
    ic = jnp.clip(idx_best, 0, tp.v1x.shape[0] - 1)
    nx = take(tp.nx, ic)
    ny = take(tp.ny, ic)
    nz = take(tp.nz, ic)
    mat = take(tp.mat, ic)
    chans = tuple(take(tp.channels[k], ic)
                  for k in range(tp.channels.shape[0]))
    miss = idx_best < 0
    out = (t_best, jnp.where(miss, 0.0, nx), jnp.where(miss, 0.0, ny),
           jnp.where(miss, 0.0, nz), jnp.where(miss, 0.0, mat),
           jnp.where(miss, -1.0, idx_best.astype(jnp.float32)), chans)
    if not with_uv:
        return out
    zeros = jnp.zeros((n,), jnp.float32)
    if tp.tex is None:
        return out + ((zeros, zeros, jnp.full((n,), -1.0)),)
    # the winner's barycentrics, from the same test that picked it
    det, u, vv, _ = _moller_trumbore(o, d, *_tri_at(tp, ic))
    inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
    b1, b2 = u * inv_det, vv * inv_det
    uvx = take(tp.uv1x, ic) + b1 * take(tp.ue1x, ic) + b2 * take(tp.ue2x, ic)
    uvy = take(tp.uv1y, ic) + b1 * take(tp.ue1y, ic) + b2 * take(tp.ue2y, ic)
    return out + ((jnp.where(miss, 0.0, uvx), jnp.where(miss, 0.0, uvy),
                   jnp.where(miss, -1.0, take(tp.tex, ic))),)


def _tri_at(tp: TrianglePack, idx):
    """(v1, e1, e2) component triples of triangles `idx` (gathers)."""
    take = lambda tab: jnp.take(tab, idx, axis=0, mode="clip")  # noqa: E731
    return ((take(tp.v1x), take(tp.v1y), take(tp.v1z)),
            (take(tp.e1x), take(tp.e1y), take(tp.e1z)),
            (take(tp.e2x), take(tp.e2y), take(tp.e2z)))


def build_mesh_engine(scene_arrays, mat_channels):
    """The triangle-pool accelerator the renderers pass as `tri_bvh`: the
    flattened BVH and its leaf pool, walked per ray
    (`intersect_triangles_bvh`)."""
    return (build_triangle_bvh(scene_arrays),
            pack_triangles(scene_arrays, mat_channels))


def primitive_aabbs(scene_arrays) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """AABBs over the combined prim order [spheres | triangles | planes] used
    by ops.intersect (ε-inflated planes as in `Bounds3.hpp:79-103`).

    Returns (bb_min, bb_max, valid_count_per_type)."""
    sph_pos = np.asarray(scene_arrays.sph_pos, np.float64)
    sph_r = np.asarray(scene_arrays.sph_radius, np.float64)[:, None]
    sph_valid = np.asarray(scene_arrays.sph_valid)
    tri_v1 = np.asarray(scene_arrays.tri_v1, np.float64)
    tri_v2 = tri_v1 + np.asarray(scene_arrays.tri_e1, np.float64)
    tri_v3 = tri_v1 + np.asarray(scene_arrays.tri_e2, np.float64)
    pln_pos = np.asarray(scene_arrays.pln_pos, np.float64)

    mins, maxs = [], []
    mins.append(sph_pos - sph_r)
    maxs.append(sph_pos + sph_r)
    mins.append(np.minimum(np.minimum(tri_v1, tri_v2), tri_v3))
    maxs.append(np.maximum(np.maximum(tri_v1, tri_v2), tri_v3))
    # planes: corners p, p+u, p+v, p+u+v with epsilon inflation
    # (the reference inflates by 0.0001, `Bounds3.hpp:90-99`)
    inv = np.asarray(scene_arrays.pln_inv, np.float64)
    # recover u, v from the inverse is overkill; planes are few — reuse
    # pln_pos only when caller passes explicit u/v (see mesh path).  Here the
    # plane AABB falls back to a point bound inflated below; plane-heavy
    # scenes stay on the dense path anyway.
    mins.append(pln_pos)
    maxs.append(pln_pos)
    bb_min = np.concatenate(mins) - 1e-4
    bb_max = np.concatenate(maxs) + 1e-4
    counts = np.array([sph_pos.shape[0], tri_v1.shape[0], pln_pos.shape[0]])
    return bb_min.astype(np.float32), bb_max.astype(np.float32), counts
