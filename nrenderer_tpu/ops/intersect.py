"""Batched ray-primitive intersection kernels (component-SoA layout).

The math ports the *behavior* of the reference's per-plugin intersection
routines (`simple_path_tracing/src/intersections/intersections.cpp:1-95`),
keeping the PT variants' epsilon and boundary conventions (SURVEY.md §2.8):

  - triangle: Möller-Trumbore with det-sign folding, parallel reject at
    det < 1e-6, `t >= tMin` acceptance, stored (unnormalized) normal returned
  - sphere: both quadratic roots tried in order, normal = (p-c)/r
  - plane: parallelogram patch via the precomputed inverse of [u, v, u x v]
    (the reference inverts per ray; we precompute the two needed rows per
    plane), near-parallel reject at |n.d| ~ 1e-7
  - area light: the plane test on (position, u, v) with normal cross(u, v)

Design: all primitives of all types are evaluated for all rays as one
(P_total, N) matrix — rays dense in the minor axis, primitives on the major
axis — followed by a one-hot argmin.  Attribute "gathers" are
mask-reductions / tiny matmuls (`soa.select_prim`), not dynamic gathers.  The
`closestHitObject` brute-force loops (`SimplePathTracer.cpp:104-129`) map to a
single fused masked reduction."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..scene.arrays import (
    MAT_ABSORBED, MAT_ALBEDO, MAT_DIFFUSE, MAT_DIFFUSE_MAP, MAT_ETA_I,
    MAT_ETA_R, MAT_F0, MAT_IOR, MAT_METALNESS, MAT_ROUGHNESS, MAT_SPECULAR,
    MAT_SPECULAR_EX, MAT_SPECULAR_MAP, SceneArrays,
)
from .soa import (
    V3, cross3, dot3, one_hot_argmin, select_prim, select_prim3, splat,
    where3,
)

FLOAT_INF = jnp.inf
T_MIN_PT = 1e-6       # PT epsilon (`SimplePathTracer.cpp:108`)
T_MIN_RAYCAST = 0.01  # ray_cast epsilon (`RayCastRenderer.cpp:70`)


class MatTable(NamedTuple):
    """Material parameter table in SoA columns ((M,) each)."""
    type: jnp.ndarray
    diffuse: V3
    specular: V3
    specular_ex: jnp.ndarray
    ior: jnp.ndarray
    absorbed: V3
    eta_r: V3
    eta_i: V3
    albedo: V3
    roughness: jnp.ndarray
    f0: jnp.ndarray
    metalness: jnp.ndarray


class SceneSoA(NamedTuple):
    """Device-side SoA scene view derived from SceneArrays inside jit."""
    # spheres
    sph_pos: V3
    sph_radius: jnp.ndarray
    sph_valid: jnp.ndarray
    # triangles
    tri_v1: V3
    tri_e1: V3
    tri_e2: V3
    tri_valid: jnp.ndarray
    # planes
    pln_pos: V3
    pln_normal: V3
    pln_inv0: V3       # row 0 of inv([u v uxv]) -> u coordinate
    pln_inv1: V3       # row 1 -> v coordinate
    pln_valid: jnp.ndarray
    # combined static per-prim tables, order [spheres | triangles | planes]
    prim_normal: V3    # zeros for sphere rows (computed from hit point)
    prim_is_sphere: jnp.ndarray
    prim_sph_pos: V3   # sphere center per row (zeros elsewhere)
    prim_sph_inv_r: jnp.ndarray
    mat_indicator: jnp.ndarray  # (M, P_total) float: prim -> material one-hot
    # area lights
    al_pos: V3
    al_normal: V3
    al_inv0: V3
    al_inv1: V3
    al_radiance: V3
    al_valid: jnp.ndarray
    # materials / ambient
    mat: MatTable
    ambient_type: jnp.ndarray
    ambient_constant: V3
    env_map: jnp.ndarray


class HitSoA(NamedTuple):
    t: jnp.ndarray        # (N,), +inf on miss
    valid: jnp.ndarray    # (N,) bool
    point: V3             # (N,)
    normal: V3            # (N,) raw, NOT renormalized (PT convention)
    mat_oh: jnp.ndarray   # (M, N) float one-hot of the hit material


def make_scene_soa(scene: SceneArrays) -> SceneSoA:
    """Trace-time conversion; XLA folds these slices into the kernel."""
    sph_pos = splat(scene.sph_pos)
    tri_v1 = splat(scene.tri_v1)
    tri_e1 = splat(scene.tri_e1)
    tri_e2 = splat(scene.tri_e2)
    tri_n = splat(scene.tri_normal)
    pln_pos = splat(scene.pln_pos)
    pln_n = splat(scene.pln_normal)
    pln_inv0 = splat(scene.pln_inv[:, 0, :])
    pln_inv1 = splat(scene.pln_inv[:, 1, :])

    s, t, p = scene.sph_valid.shape[0], scene.tri_valid.shape[0], \
        scene.pln_valid.shape[0]
    m = scene.mat_type.shape[0]
    zeros_s = jnp.zeros((s,), scene.tri_normal.dtype)

    def cat(*parts):
        return jnp.concatenate(parts)

    prim_normal = V3(cat(zeros_s, tri_n.x, pln_n.x),
                     cat(zeros_s, tri_n.y, pln_n.y),
                     cat(zeros_s, tri_n.z, pln_n.z))
    prim_is_sphere = cat(jnp.ones((s,)), jnp.zeros((t,)), jnp.zeros((p,)))
    zt = jnp.zeros((t + p,))
    prim_sph_pos = V3(cat(sph_pos.x, zt), cat(sph_pos.y, zt),
                      cat(sph_pos.z, zt))
    prim_sph_inv_r = cat(1.0 / jnp.maximum(scene.sph_radius, 1e-20), zt)
    prim_mat = cat(scene.sph_mat, scene.tri_mat, scene.pln_mat)
    mat_indicator = (jnp.arange(m, dtype=jnp.int32)[:, None]
                     == prim_mat[None, :]).astype(jnp.float32)

    mp = scene.mat_params
    mat = MatTable(
        type=scene.mat_type,
        diffuse=splat(mp[:, MAT_DIFFUSE]),
        specular=splat(mp[:, MAT_SPECULAR]),
        specular_ex=mp[:, MAT_SPECULAR_EX],
        ior=mp[:, MAT_IOR],
        absorbed=splat(mp[:, MAT_ABSORBED]),
        eta_r=splat(mp[:, MAT_ETA_R]),
        eta_i=splat(mp[:, MAT_ETA_I]),
        albedo=splat(mp[:, MAT_ALBEDO]),
        roughness=mp[:, MAT_ROUGHNESS],
        f0=mp[:, MAT_F0],
        metalness=mp[:, MAT_METALNESS],
    )

    return SceneSoA(
        sph_pos=sph_pos, sph_radius=scene.sph_radius,
        sph_valid=scene.sph_valid,
        tri_v1=tri_v1, tri_e1=tri_e1, tri_e2=tri_e2,
        tri_valid=scene.tri_valid,
        pln_pos=pln_pos, pln_normal=pln_n, pln_inv0=pln_inv0,
        pln_inv1=pln_inv1, pln_valid=scene.pln_valid,
        prim_normal=prim_normal, prim_is_sphere=prim_is_sphere,
        prim_sph_pos=prim_sph_pos, prim_sph_inv_r=prim_sph_inv_r,
        mat_indicator=mat_indicator,
        al_pos=splat(scene.al_pos), al_normal=splat(scene.al_normal),
        al_inv0=splat(scene.al_inv[:, 0, :]),
        al_inv1=splat(scene.al_inv[:, 1, :]),
        al_radiance=splat(scene.al_radiance), al_valid=scene.al_valid,
        mat=mat,
        ambient_type=scene.ambient_type,
        ambient_constant=splat(scene.ambient_constant),
        env_map=scene.env_map,
    )


def _col(v: V3) -> V3:
    """Lift per-prim (P,) components to (P, 1) for broadcasting against (N,)."""
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _sphere_ts(s: SceneSoA, o: V3, d: V3, t_min: float) -> jnp.ndarray:
    """(S, N) hit distances, +inf on miss (`intersections.cpp:31-55`)."""
    pos = _col(s.sph_pos)
    oc = V3(o.x[None, :] - pos.x, o.y[None, :] - pos.y, o.z[None, :] - pos.z)
    a = dot3(d, d)[None, :]
    b = oc.x * d.x[None, :] + oc.y * d.y[None, :] + oc.z * d.z[None, :]
    c = dot3(oc, oc) - (s.sph_radius ** 2)[:, None]
    disc = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    ok = (disc > 0) & s.sph_valid[:, None]
    t = jnp.where(ok & (t1 >= t_min), t1,
                  jnp.where(ok & (t2 >= t_min), t2, FLOAT_INF))
    return t


def _triangle_ts(s: SceneSoA, o: V3, d: V3, t_min: float) -> jnp.ndarray:
    """(T, N) distances (Möller-Trumbore with det-sign fold,
    `intersections.cpp:5-30`)."""
    e1 = _col(s.tri_e1)
    e2 = _col(s.tri_e2)
    dn = V3(d.x[None, :], d.y[None, :], d.z[None, :])
    p = cross3(dn, e2)                       # (T, N)
    det0 = dot3(e1, p)
    sign = jnp.where(det0 > 0, 1.0, -1.0)
    det = det0 * sign
    v1 = _col(s.tri_v1)
    tvec = V3((o.x[None, :] - v1.x) * sign, (o.y[None, :] - v1.y) * sign,
              (o.z[None, :] - v1.z) * sign)
    u = dot3(tvec, p)
    q = cross3(tvec, e1)
    v = dot3(dn, q)
    w = dot3(e2, q) / jnp.where(det == 0, 1.0, det)
    ok = ((det >= 1e-6) & (u >= 0) & (u <= det) & (v >= 0) & (u + v <= det)
          & (w >= t_min) & s.tri_valid[:, None])
    return jnp.where(ok, w, FLOAT_INF)


def _patch_ts(pos: V3, normal: V3, inv0: V3, inv1: V3, valid: jnp.ndarray,
              o: V3, d: V3, t_min: float) -> jnp.ndarray:
    """(P, N) distances for parallelogram patches (planes & area lights,
    `intersections.cpp:56-92`)."""
    pc = _col(pos)
    nc = _col(normal)
    nd = nc.x * d.x[None, :] + nc.y * d.y[None, :] + nc.z * d.z[None, :]
    parallel = (nd < 1e-7) & (nd > -1e-8)
    num = dot3(pos, normal)[:, None] - (
        nc.x * o.x[None, :] + nc.y * o.y[None, :] + nc.z * o.z[None, :])
    t = num / jnp.where(parallel, 1.0, nd)
    rel = V3(o.x[None, :] + t * d.x[None, :] - pc.x,
             o.y[None, :] + t * d.y[None, :] - pc.y,
             o.z[None, :] + t * d.z[None, :] - pc.z)
    i0 = _col(inv0)
    i1 = _col(inv1)
    u = i0.x * rel.x + i0.y * rel.y + i0.z * rel.z
    v = i1.x * rel.x + i1.y * rel.y + i1.z * rel.z
    ok = (~parallel & (t >= t_min) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
          & valid[:, None])
    return jnp.where(ok, t, FLOAT_INF)


def intersect_scene(s: SceneSoA, o: V3, d: V3,
                    t_min: float = T_MIN_PT) -> HitSoA:
    """Closest hit against spheres + triangles + planes for a ray batch."""
    ts = _sphere_ts(s, o, d, t_min)
    tt = _triangle_ts(s, o, d, t_min)
    tp = _patch_ts(s.pln_pos, s.pln_normal, s.pln_inv0, s.pln_inv1,
                   s.pln_valid, o, d, t_min)
    t_all = jnp.concatenate([ts, tt, tp], axis=0)      # (P_total, N)
    t = jnp.min(t_all, axis=0)
    valid = jnp.isfinite(t)
    oh = one_hot_argmin(t_all) * valid[None, :].astype(t_all.dtype)

    # miss rays carry t=inf; fold them to the origin so downstream
    # masked shading never computes 0 * inf = NaN (visible as NaN pixels
    # on any ray that leaves the scene, e.g. wide-fov RayCast)
    t_pt = jnp.where(valid, t, 0.0)
    point = V3(o.x + t_pt * d.x, o.y + t_pt * d.y, o.z + t_pt * d.z)

    n_static = select_prim3(oh, s.prim_normal)
    w_sph = select_prim(oh, s.prim_is_sphere)
    c_sel = select_prim3(oh, s.prim_sph_pos)
    inv_r = select_prim(oh, s.prim_sph_inv_r)
    n_sph = V3((point.x - c_sel.x) * inv_r, (point.y - c_sel.y) * inv_r,
               (point.z - c_sel.z) * inv_r)
    normal = where3(w_sph > 0.5, n_sph, n_static)

    mat_oh = s.mat_indicator @ oh                      # (M, N)
    return HitSoA(t=t, valid=valid, point=point, normal=normal, mat_oh=mat_oh)


def intersect_area_lights(s: SceneSoA, o: V3, d: V3,
                          t_min: float = T_MIN_PT
                          ) -> Tuple[jnp.ndarray, V3]:
    """`closestHitLight` (`SimplePathTracer.cpp:131-142`): nearest area-light
    crossing.  Returns (t, radiance V3); t = +inf if none."""
    ta = _patch_ts(s.al_pos, s.al_normal, s.al_inv0, s.al_inv1, s.al_valid,
                   o, d, t_min)
    t = jnp.min(ta, axis=0)
    ok = jnp.isfinite(t)
    oh = one_hot_argmin(ta) * ok[None, :].astype(ta.dtype)
    rad = select_prim3(oh, s.al_radiance)
    return t, rad


# ---------------------------------------------------------------------------
# Unrolled variant: for small static prim counts, loop over primitives in
# Python so XLA fuses the whole closest-hit into ONE elementwise kernel over
# (N,) arrays — no (P, N) intermediates touch HBM.  Per-prim data are numpy
# scalars baked into the kernel as constants.
# ---------------------------------------------------------------------------

class StaticScene(NamedTuple):
    """Host-side (numpy) scene view for constant-folding into kernels."""
    sph: list    # (cx, cy, cz, r, mat)
    tri: list    # (v1, e1, e2, n, mat) tuples of np arrays
    pln: list    # (pos, n, inv0, inv1, mat)
    al: list     # (pos, n, inv0, inv1, radiance)
    mats: list   # per-material dict of params (numpy)
    ambient_type: int
    ambient_constant: tuple
    n_mats: int
    # per-tri texture coords, parallel to `tri`: (u1x, u1y, e1x, e1y,
    # e2x, e2y, tex_id, stex_id) plain-float tuples; () when the scene has
    # no textured faces (texture PIXELS are traced args, never baked here —
    # this struct's repr is the compile-cache fingerprint).  tex_id is the
    # diffuseMap, stex_id the specularMap (map_Ks); either may be -1.
    tri_uv: tuple = ()


def make_static_scene(scene_arrays: SceneArrays) -> StaticScene:
    import numpy as np
    a = scene_arrays
    f = lambda x: np.asarray(x)
    sph = [(float(p[0]), float(p[1]), float(p[2]), float(r), int(m))
           for p, r, m, v in zip(f(a.sph_pos), f(a.sph_radius), f(a.sph_mat),
                                 f(a.sph_valid)) if v]
    tri = [(f(v1), f(e1), f(e2), f(n), int(m))
           for v1, e1, e2, n, m, v in zip(f(a.tri_v1), f(a.tri_e1),
                                          f(a.tri_e2), f(a.tri_normal),
                                          f(a.tri_mat), f(a.tri_valid)) if v]
    pln = [(f(p), f(n), f(i)[0], f(i)[1], int(m))
           for p, n, i, m, v in zip(f(a.pln_pos), f(a.pln_normal),
                                    f(a.pln_inv), f(a.pln_mat),
                                    f(a.pln_valid)) if v]
    al = [(f(p), f(n), f(i)[0], f(i)[1], f(r))
          for p, n, i, r, v in zip(f(a.al_pos), f(a.al_normal), f(a.al_inv),
                                   f(a.al_radiance), f(a.al_valid)) if v]
    mats = []
    mp = f(a.mat_params)
    for mi in range(mp.shape[0]):
        mats.append({
            "type": int(f(a.mat_type)[mi]),
            "diffuse": mp[mi, MAT_DIFFUSE],
            "specular": mp[mi, MAT_SPECULAR],
            "specular_ex": float(mp[mi, MAT_SPECULAR_EX]),
            "ior": float(mp[mi, MAT_IOR]),
            "absorbed": mp[mi, MAT_ABSORBED],
            "eta_r": mp[mi, MAT_ETA_R],
            "eta_i": mp[mi, MAT_ETA_I],
            "albedo": mp[mi, MAT_ALBEDO],
            "roughness": float(mp[mi, MAT_ROUGHNESS]),
            "f0": float(mp[mi, MAT_F0]),
            "metalness": float(mp[mi, MAT_METALNESS]),
            "stex": (float(mp[mi, MAT_SPECULAR_MAP])
                     if mp.shape[1] > MAT_SPECULAR_MAP else -1.0),
        })
    tri_uv = ()
    stex_col = (f(a.tri_stex) if hasattr(a, "tri_stex")
                else np.full(f(a.tri_valid).shape, -1, np.int32))
    if hasattr(a, "tri_tex") and np.any(
            (f(a.tri_tex)[f(a.tri_valid)] >= 0)
            | (stex_col[f(a.tri_valid)] >= 0)):
        tri_uv = tuple(
            (float(u1[0]), float(u1[1]), float(e1[0]), float(e1[1]),
             float(e2[0]), float(e2[1]), int(tx), int(sx))
            for u1, e1, e2, tx, sx, v in zip(f(a.tri_uv1), f(a.tri_uve1),
                                             f(a.tri_uve2), f(a.tri_tex),
                                             stex_col, f(a.tri_valid)) if v)
    return StaticScene(sph=sph, tri=tri, pln=pln, al=al, mats=mats,
                       ambient_type=int(np.asarray(a.ambient_type).reshape(())),
                       ambient_constant=tuple(f(a.ambient_constant)),
                       n_mats=mp.shape[0], tri_uv=tri_uv)


def _is_zero(v) -> bool:
    return isinstance(v, (int, float)) and float(v) == 0.0


def _lin3(c, x, y, z):
    """Trace-time-folded linear combination c[0]*x + c[1]*y + c[2]*z where c
    are Python floats: zero terms are dropped and unit factors skipped BEFORE
    lowering (compilers don't fold 0*x for floats).  Axis-aligned planes and
    axis-parallel edges — most of a Cornell box — cost 1 multiply instead
    of 5 ops.  Operands may themselves be literal 0.0 (from an earlier fold).
    """
    terms = []
    for cc, v in ((float(c[0]), x), (float(c[1]), y), (float(c[2]), z)):
        if cc == 0.0 or _is_zero(v):
            continue
        terms.append(v if cc == 1.0 else cc * v)
    if not terms:
        return 0.0
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _dota(pairs):
    """Sum of a*b products with literal-zero operands folded away."""
    terms = [a * b for a, b in pairs if not (_is_zero(a) or _is_zero(b))]
    if not terms:
        return 0.0
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


class HitUnrolled(NamedTuple):
    t: jnp.ndarray       # (N,), +inf on miss
    valid: jnp.ndarray   # (N,) bool
    point: V3
    normal: V3
    mat_id: jnp.ndarray  # (N,) float material id of the hit (0 if miss)
    prim_id: jnp.ndarray  # (N,) float primitive id (enumeration order:
    #                       spheres, triangles, planes; -1 if miss)
    channels: tuple      # per-ray tracked material constants ((N,) each)
    uv: tuple = None     # (tu, tv, tex_id) per-ray, only with `with_uv`


def intersect_scene_unrolled(ss: StaticScene, o: V3, d: V3,
                             t_min: float = T_MIN_PT,
                             mat_channels=None,
                             with_uv: bool = False) -> HitUnrolled:
    """Closest hit with the primitive loop unrolled at trace time.

    Running per-ray state: best t, best normal, and — instead of a material
    index to gather with later — the material constants the caller actually
    needs: `mat_channels` is a list over materials of k-tuples (e.g. the
    albedo rgb), and the k running channels are updated with each prim's
    constants during the masked-min scan.  Zero gathers, zero (P, N) arrays;
    XLA fuses the entire loop into one elementwise kernel.

    Shape-agnostic: works on (N,) wavefronts and on (SUB, 128) Pallas tiles
    alike (ops/pt_pallas.py reuses this exact code inside the megakernel)."""
    inf = jnp.float32(jnp.inf)
    k = len(mat_channels[0]) if mat_channels else 0
    t_best = jnp.full_like(o.x, inf)
    nx = jnp.zeros_like(o.x); ny = jnp.zeros_like(o.x)
    nz = jnp.zeros_like(o.x)
    mid = jnp.zeros_like(o.x)  # material id as float
    pid_best = jnp.full_like(o.x, -1.0)  # primitive id as float
    chans = tuple(jnp.zeros_like(o.x) for _ in range(k))
    uv_state = (jnp.zeros_like(o.x), jnp.zeros_like(o.x),
                jnp.full_like(o.x, -1.0)) if with_uv else None
    prim_counter = [0]

    def upd(hit_mask, t, nxx, nyy, nzz, m, state, uv_vals=None):
        t_best, nx, ny, nz, mid, pid_best, chans, uv_state = state
        pid = prim_counter[0]
        prim_counter[0] += 1
        closer = hit_mask & (t < t_best)
        new_chans = tuple(
            jnp.where(closer, float(mat_channels[m][i]), chans[i])
            for i in range(k))
        if uv_state is not None:
            if uv_vals is None:
                uv_vals = (0.0, 0.0, -1.0)
            uv_state = tuple(jnp.where(closer, v, s)
                             for v, s in zip(uv_vals, uv_state))
        return (jnp.where(closer, t, t_best), jnp.where(closer, nxx, nx),
                jnp.where(closer, nyy, ny), jnp.where(closer, nzz, nz),
                jnp.where(closer, float(m), mid),
                jnp.where(closer, float(pid), pid_best), new_chans,
                uv_state)

    state = (t_best, nx, ny, nz, mid, pid_best, chans, uv_state)

    for (cx, cy, cz, r, m) in ss.sph:
        ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
        b = ocx * d.x + ocy * d.y + ocz * d.z
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        a = dot3(d, d)
        disc = b * b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        inv_a = 1.0 / a
        t1 = (-b - sq) * inv_a
        t2 = (-b + sq) * inv_a
        ok = disc > 0
        t = jnp.where(ok & (t1 >= t_min), t1,
                      jnp.where(ok & (t2 >= t_min), t2, inf))
        inv_r = 1.0 / r
        px = o.x + t * d.x; py = o.y + t * d.y; pz = o.z + t * d.z
        state = upd(jnp.isfinite(t), t, (px - cx) * inv_r, (py - cy) * inv_r,
                    (pz - cz) * inv_r, m, state)

    for ti, (v1, e1, e2, nrm, m) in enumerate(ss.tri):
        # P = d x e2 (e2 constant -> linear in d; zero terms trace-folded)
        px = _lin3((0.0, e2[2], -e2[1]), d.x, d.y, d.z)
        py = _lin3((-e2[2], 0.0, e2[0]), d.x, d.y, d.z)
        pz = _lin3((e2[1], -e2[0], 0.0), d.x, d.y, d.z)
        det0 = _lin3(e1, px, py, pz)
        sign = jnp.where(det0 > 0, 1.0, -1.0)
        det = det0 * sign
        tx = (o.x - v1[0]) * sign
        ty = (o.y - v1[1]) * sign
        tz = (o.z - v1[2]) * sign
        u = _dota([(tx, px), (ty, py), (tz, pz)])
        qx = _lin3((0.0, e1[2], -e1[1]), tx, ty, tz)
        qy = _lin3((-e1[2], 0.0, e1[0]), tx, ty, tz)
        qz = _lin3((e1[1], -e1[0], 0.0), tx, ty, tz)
        v = _dota([(d.x, qx), (d.y, qy), (d.z, qz)])
        w = _lin3(e2, qx, qy, qz) / jnp.where(det == 0, 1.0, det)
        ok = ((det >= 1e-6) & (u >= 0) & (u <= det) & (v >= 0)
              & (u + v <= det) & (w >= t_min))
        uv_vals = None
        if with_uv and ti < len(ss.tri_uv) and (
                ss.tri_uv[ti][6] >= 0 or ss.tri_uv[ti][7] >= 0):
            u1x, u1y, e1x, e1y, e2x, e2y, tex = ss.tri_uv[ti][:7]
            inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
            b1 = u * inv_det
            b2 = v * inv_det
            uv_vals = (u1x + _dota([(b1, e1x), (b2, e2x)]),
                       u1y + _dota([(b1, e1y), (b2, e2y)]),
                       float(tex))
        state = upd(ok, jnp.where(ok, w, inf), nrm[0], nrm[1], nrm[2], m,
                    state, uv_vals=uv_vals)

    for (pos, nrm, inv0, inv1, m) in ss.pln:
        nd = _lin3(nrm, d.x, d.y, d.z)
        parallel = (nd < 1e-7) & (nd > -1e-8)
        dp = float(np_dot(pos, nrm))
        t = (dp - _lin3(nrm, o.x, o.y, o.z)) / jnp.where(parallel, 1.0, nd)
        rx = o.x + t * d.x - float(pos[0]) if pos[0] else o.x + t * d.x
        ry = o.y + t * d.y - float(pos[1]) if pos[1] else o.y + t * d.y
        rz = o.z + t * d.z - float(pos[2]) if pos[2] else o.z + t * d.z
        u = _lin3(inv0, rx, ry, rz)
        v = _lin3(inv1, rx, ry, rz)
        ok = (~parallel & (t >= t_min) & (u >= 0) & (u <= 1) & (v >= 0)
              & (v <= 1))
        state = upd(ok, jnp.where(ok, t, inf), nrm[0], nrm[1], nrm[2], m,
                    state)

    t_best, nx, ny, nz, mid, pid_best, chans, uv_state = state
    valid = jnp.isfinite(t_best)
    # fold miss t=inf to the origin (see intersect_scene: masked 0*inf=NaN)
    t_pt = jnp.where(valid, t_best, 0.0)
    point = V3(o.x + t_pt * d.x, o.y + t_pt * d.y, o.z + t_pt * d.z)
    return HitUnrolled(t=t_best, valid=valid, point=point,
                       normal=V3(nx, ny, nz), mat_id=mid, prim_id=pid_best,
                       channels=chans, uv=uv_state)


def intersect_area_lights_unrolled(ss: StaticScene, o: V3, d: V3,
                                   t_min: float = T_MIN_PT):
    """Unrolled `closestHitLight`; returns (t, radiance V3).  Shape-agnostic
    like intersect_scene_unrolled."""
    inf = jnp.float32(jnp.inf)
    t_best = jnp.full_like(o.x, inf)
    rx = jnp.zeros_like(o.x); ry = jnp.zeros_like(o.x)
    rz = jnp.zeros_like(o.x)
    for (pos, nrm, inv0, inv1, rad) in ss.al:
        nd = _lin3(nrm, d.x, d.y, d.z)
        parallel = (nd < 1e-7) & (nd > -1e-8)
        dp = float(np_dot(pos, nrm))
        t = (dp - _lin3(nrm, o.x, o.y, o.z)) / jnp.where(parallel, 1.0, nd)
        hx = o.x + t * d.x - float(pos[0]) if pos[0] else o.x + t * d.x
        hy = o.y + t * d.y - float(pos[1]) if pos[1] else o.y + t * d.y
        hz = o.z + t * d.z - float(pos[2]) if pos[2] else o.z + t * d.z
        u = _lin3(inv0, hx, hy, hz)
        v = _lin3(inv1, hx, hy, hz)
        ok = (~parallel & (t >= t_min) & (u >= 0) & (u <= 1) & (v >= 0)
              & (v <= 1))
        closer = ok & (t < t_best)
        t_best = jnp.where(closer, t, t_best)
        rx = jnp.where(closer, float(rad[0]), rx)
        ry = jnp.where(closer, float(rad[1]), ry)
        rz = jnp.where(closer, float(rad[2]), rz)
    return t_best, V3(rx, ry, rz)


def np_dot(a, b) -> float:
    return float(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def select_mat(mat_oh: jnp.ndarray, col: jnp.ndarray) -> jnp.ndarray:
    """(M, N) one-hot x (M,) material column -> (N,) values."""
    return jnp.sum(mat_oh * col[:, None], axis=0)


def select_mat3(mat_oh: jnp.ndarray, col: V3) -> V3:
    return V3(select_mat(mat_oh, col.x), select_mat(mat_oh, col.y),
              select_mat(mat_oh, col.z))
