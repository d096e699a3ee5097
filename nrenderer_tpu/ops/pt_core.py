"""Shared shape-agnostic path-tracing bounce body.

One implementation of the reference's per-bounce estimator
(`SimplePathTracer.cpp:144-177`) used by BOTH execution engines:

  - the XLA wavefront (renderers/simple_pt.py): (N,) component arrays,
    uniforms from jax.random
  - the GPU megakernel (ops/pt_pallas.py): one (BLOCK,) pixel block per
    program, uniforms from the counter-based `hash_uniform`

Everything here is pure jnp elementwise math over whatever shape the caller's
V3 components carry."""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import (
    StaticScene, intersect_area_lights_unrolled, intersect_scene_unrolled,
)
from .soa import V3, cross3, dot3, normalize3, where3

PI = 3.14159265358979323846


def scene_epsilon(ss: StaticScene, base: float = 1e-6) -> float:
    """Scale-aware self-intersection epsilon.

    The reference uses a fixed 1e-6 (`SimplePathTracer.cpp:108`) with float
    math; at Cornell-box coordinates (~1600 units) the float32 ulp is ~1e-4,
    so a respawned ray can falsely re-hit its own surface depending smoothly
    on the incident angle — which rendered as a visible ring on the back
    wall.  Use max(base, 2e-6 * scene_extent): ~3e-3 for the stock Cornell,
    still sub-millimeter in scene units."""
    extent = 1.0
    for (cx, cy, cz, r, _m) in ss.sph:
        extent = max(extent, abs(cx) + r, abs(cy) + r, abs(cz) + r)
    for (v1, e1, e2, _n, _m) in ss.tri:
        for k in range(3):
            extent = max(extent, abs(float(v1[k])),
                         abs(float(v1[k] + e1[k])),
                         abs(float(v1[k] + e2[k])))
    for (pos, _n, _i0, _i1, _m) in ss.pln:
        for k in range(3):
            extent = max(extent, abs(float(pos[k])))
    return max(base, 2e-6 * extent)


def hash_uniform(pixel_id: jnp.ndarray, sample, draw: int,
                 seed) -> jnp.ndarray:
    """Stateless counter-based uniform in [0,1): a lowbias32-style integer
    hash of (pixel, sample, draw-site, seed).

    Used by the GPU megakernel: a counter-based hash gives every (pixel,
    sample, bounce, site) an independent value, like the threefry streams
    of the XLA engine, at ~6 integer ops and with no state to carry."""
    dconst = (draw * 0x27D4EB2F) & 0xFFFFFFFF
    if dconst >= 1 << 31:
        dconst -= 1 << 32
    x = (pixel_id * jnp.int32(-1640531527)          # 0x9E3779B9 (wrapped)
         + sample * jnp.int32(-2048144789)          # 0x85EBCA6B
         + seed * jnp.int32(0x165667B1) + jnp.int32(dconst))
    x = x ^ jax.lax.shift_right_logical(x, 16)
    x = x * jnp.int32(0x7FEB352D)
    x = x ^ jax.lax.shift_right_logical(x, 15)
    x = x * jnp.int32(-2027558707)                  # 0x846CA68B
    x = x ^ jax.lax.shift_right_logical(x, 16)
    # top 24 bits -> [0,1)
    return (jax.lax.shift_right_logical(x, 8).astype(jnp.float32)
            * jnp.float32(2 ** -24))


def uniform_from_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 random bits -> float32 uniforms in [0, 1): take the top 24 bits
    (float32 mantissa width) and scale.  The shifted value has a zero sign
    bit, so it is viewed as int32 before the float convert."""
    shifted = jax.lax.bitcast_convert_type(
        bits >> jnp.uint32(8), jnp.int32)
    return shifted.astype(jnp.float32) * jnp.float32(2 ** -24)


def hemisphere_from_uv(u1: jnp.ndarray, u2: jnp.ndarray) -> V3:
    """Uniform hemisphere about +z from two uniforms; pdf = 1/(2 pi).
    Exactly the reference's map (`Hemisphere.hpp:25-32`)."""
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1 * u1))
    phi = 2.0 * PI * u2
    return V3(jnp.cos(phi) * r, jnp.sin(phi) * r, u1)


def onb_local(normal: V3, vec: V3) -> V3:
    """Reference Onb (`Onb.hpp:17-27`) applied to `vec` (shape-agnostic)."""
    w = normal
    big_x = jnp.abs(w.x) > 0.9
    a = V3(jnp.where(big_x, 0.0, 1.0), jnp.where(big_x, 1.0, 0.0),
           jnp.zeros_like(w.x))
    v = normalize3(cross3(w, a), eps=1e-20)
    u = cross3(w, v)
    return V3(vec.x * u.x + vec.y * v.x + vec.z * w.x,
              vec.x * u.y + vec.y * v.y + vec.z * w.y,
              vec.x * u.z + vec.y * v.z + vec.z * w.z)


def closest_hit(ss: StaticScene, o: V3, d: V3, t_min: float, mat_channels,
                tri_bvh=None, alive=None, with_uv: bool = False,
                unique_pids: bool = False):
    """Closest hit: unrolled constant-folded brute force, with the triangle
    pool optionally routed through a flattened BVH walk (`tri_bvh` =
    (FlatBVH, TrianglePack), used by the renderers when the mesh-expanded
    triangle count makes brute force lose — the acc_path_tracing plugin's
    whole reason to exist, `AccPathTracer.cpp:58-62`).

    `unique_pids`: the BVH walk reports the TRIANGLE-ARRAY index as
    prim_id while the dense pass enumerates its own prims from 0, so the
    two id spaces collide.  Callers that compare prim ids across hits
    (MLT's visibility check, `renderers/mlt.py` — reference
    `Metropolis.cpp:135-166` assigns one running id per primitive) set
    this to offset mesh ids past the dense count."""
    if tri_bvh is None:
        return intersect_scene_unrolled(ss, o, d, t_min=t_min,
                                        mat_channels=mat_channels,
                                        with_uv=with_uv)
    from .bvh import intersect_triangles_bvh
    ss_nt = ss._replace(tri=[], tri_uv=())
    hit = intersect_scene_unrolled(ss_nt, o, d, t_min=t_min,
                                   mat_channels=mat_channels,
                                   with_uv=with_uv)
    bvh, tp = tri_bvh
    out = intersect_triangles_bvh(bvh, tp, o, d, t_min=t_min,
                                  with_uv=with_uv)
    tb, nxb, nyb, nzb, matb, pidb, chb = out[:7]
    if unique_pids:
        # dense enumeration above ran WITHOUT triangles (spheres, planes)
        n_dense = len(ss.sph) + len(ss.pln)
        pidb = jnp.where(pidb >= 0, pidb + float(n_dense), pidb)
    closer = tb < hit.t
    t = jnp.where(closer, tb, hit.t)
    normal = V3(jnp.where(closer, nxb, hit.normal.x),
                jnp.where(closer, nyb, hit.normal.y),
                jnp.where(closer, nzb, hit.normal.z))
    chans = tuple(jnp.where(closer, cb, ch)
                  for cb, ch in zip(chb, hit.channels))
    point = V3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z)
    uv = hit.uv
    if with_uv:
        base = hit.uv if hit.uv is not None else (
            jnp.zeros_like(t), jnp.zeros_like(t), jnp.full_like(t, -1.0))
        uv = tuple(jnp.where(closer, ub, hb)
                   for ub, hb in zip(out[7], base))
    return hit._replace(t=t, valid=jnp.isfinite(t), point=point,
                        normal=normal,
                        mat_id=jnp.where(closer, matb, hit.mat_id),
                        prim_id=jnp.where(closer, pidb, hit.prim_id),
                        channels=chans, uv=uv)


def diffuse_bounce(ss: StaticScene, albedo_ch, o: V3, d: V3, throughput: V3,
                   radiance: V3, alive, u1, u2, t_min: float = 1e-6,
                   tri_bvh=None, with_miss: bool = False, textures=None
                   ) -> Tuple[V3, V3, V3, V3, jnp.ndarray]:
    """One bounce of the diffuse estimator; returns updated
    (o, d, throughput, radiance, alive) — plus the miss mask (alive rays
    that hit neither an object nor a light, i.e. env-map candidates; their
    o/d/throughput are left untouched) when `with_miss`.

    `u1, u2`: uniforms in [0,1) shaped like o.x (hemisphere sampling).
    `alive`: boolean mask of rays still carrying throughput.
    `textures`: tuple of (H, W, 3) arrays — diffuseMap sampling at the
    hit's interpolated UV (beyond the reference, which plumbs textures
    into shaders but never reads them — `Shader.hpp:22`)."""
    hit = closest_hit(ss, o, d, t_min, albedo_ch, tri_bvh, alive=alive,
                      with_uv=bool(textures))
    t_l, light_rad = intersect_area_lights_unrolled(ss, o, d, t_min=t_min)

    obj_first = alive & hit.valid & (hit.t < t_l)
    light_hit = alive & ~obj_first & (t_l < jnp.inf)

    lw = light_hit.astype(o.x.dtype)
    radiance = V3(radiance.x + lw * throughput.x * light_rad.x,
                  radiance.y + lw * throughput.y * light_rad.y,
                  radiance.z + lw * throughput.z * light_rad.z)

    ax, ay, az = hit.channels
    if textures:
        from .texture import resolve_diffuse
        alb = resolve_diffuse(textures, hit.uv, V3(ax, ay, az))
        ax, ay, az = alb.x, alb.y, alb.z
    local = hemisphere_from_uv(u1, u2)
    new_d = normalize3(onb_local(hit.normal, local), eps=1e-20)
    cos = dot3(hit.normal, new_d)
    # attenuation * cos / pdf = (albedo/pi) * cos * 2pi = 2 albedo cos
    scale = 2.0 * cos
    throughput = V3(throughput.x * jnp.where(obj_first, ax * scale, 1.0),
                    throughput.y * jnp.where(obj_first, ay * scale, 1.0),
                    throughput.z * jnp.where(obj_first, az * scale, 1.0))
    o = where3(obj_first, hit.point, o)
    d = where3(obj_first, new_d, d)
    if with_miss:
        return o, d, throughput, radiance, obj_first, (alive & ~obj_first
                                                       & ~light_hit)
    return o, d, throughput, radiance, obj_first


# ---------------------------------------------------------------------------
# AccPathTracer BSDFs (`acc_path_tracing/src/shaders/*`), shape-agnostic.
# Material-type dispatch is branchless: all four lobes are evaluated and
# blended by the per-ray type mask (the lanes are cheap; divergence is not).
# ---------------------------------------------------------------------------

def fresnel_conductor(cos_i, eta_r: V3, eta_i: V3) -> V3:
    """Exact complex-IOR Fresnel, componentwise RGB
    (`Conductor.cpp:12-33` / `Microfacet.cpp:34-59`)."""
    cos2 = cos_i * cos_i
    sin2 = 1.0 - cos2
    sin4 = sin2 * sin2

    def chan(er, ei):
        temp1 = er * er - ei * ei - sin2
        a2pb2 = jnp.sqrt(jnp.maximum(
            temp1 * temp1 + 4.0 * ei * ei * er * er, 0.0))
        a = jnp.sqrt(jnp.maximum(0.5 * (a2pb2 + temp1), 0.0))
        t1 = a2pb2 + cos2
        t2 = 2.0 * cos_i * a
        t3 = a2pb2 * cos2 + sin4
        t4 = t2 * sin2
        r_s = (t1 - t2) / (t1 + t2)
        r_p = r_s * (t3 - t4) / (t3 + t4)
        return 0.5 * (r_s + r_p)

    return V3(chan(eta_r.x, eta_i.x), chan(eta_r.y, eta_i.y),
              chan(eta_r.z, eta_i.z))


def conductor_scatter(d: V3, normal: V3, eta_r: V3, eta_i: V3, albedo: V3):
    """Perfect mirror with complex Fresnel (`Conductor.cpp:6-42`).
    Returns (L, attenuation V3)."""
    n = normalize3(normal, eps=1e-20)
    l = normalize3(reflect3_(d, n), eps=1e-20)
    cos_l = jnp.abs(dot3(l, n))
    f = fresnel_conductor(cos_l, eta_r, eta_i)
    att = V3(f.x * cos_l * albedo.x, f.y * cos_l * albedo.y,
             f.z * cos_l * albedo.z)
    return l, att


def reflect3_(d: V3, n: V3) -> V3:
    k = 2.0 * dot3(d, n)
    return V3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def glass_scatter(d: V3, normal: V3, ior, absorbed: V3, u_choice):
    """Dielectric reflect/refract (`Glass.cpp:15-57`) with stochastic lobe
    selection for the wavefront:

    The reference recursively traces BOTH rays and sums
    `reflex*F + refraction*(1-F)` (`AccPathTracer.cpp:152-160`).  Here one
    lobe is chosen with probability F (the Schlick term); the chosen lobe's
    weight divided by its probability makes the estimator's expectation
    identical, at slightly higher variance, while keeping the wavefront
    single-ray.  On total internal reflection we reflect with full weight
    (the reference instead assigns the `absorbed` COLOR as the reflected
    direction — `Glass.cpp:47-51` — a bug we do not reproduce).

    The refraction direction reproduces the reference's (non-Snell)
    construction: x = (1-|V.N|)/ior_rel along normalize(reflex+V), y along
    -N.  Returns (L, weight V3)."""
    n0 = normalize3(normal, eps=1e-20)
    v = d  # the reference uses the (already unit) ray direction
    vdotn0 = dot3(v, n0)
    inside = vdotn0 > 0
    n = where3(inside, -n0, n0)
    ior_rel = jnp.where(inside, 1.0 / ior, ior)

    reflex = normalize3(reflect3_(v, n), eps=1e-20)
    n12 = (ior_rel - 1.0) / (ior_rel + 1.0)
    f0 = n12 * n12
    vdotn = jnp.abs(dot3(v, n))
    one_m = 1.0 - vdotn
    f = f0 + (1.0 - f0) * (one_m ** 5)

    x_axis = normalize3(V3(reflex.x + v.x, reflex.y + v.y, reflex.z + v.z),
                        eps=1e-20)
    y_axis = -n
    x_ = one_m / ior_rel
    y_ = jnp.sqrt(jnp.maximum(1.0 - x_ * x_, 0.0))
    refraction = normalize3(
        V3(x_axis.x * x_ + y_axis.x * y_, x_axis.y * x_ + y_axis.y * y_,
           x_axis.z * x_ + y_axis.z * y_), eps=1e-20)

    tir = x_ > 1.0
    choose_reflect = tir | (u_choice < f)
    l = where3(choose_reflect, reflex, refraction)
    # weight/probability cancels to `absorbed` for both lobes; TIR reflects
    # with full weight
    return l, absorbed


def _smith_g1(v: V3, h: V3, n: V3, alpha2):
    cos_vn = dot3(v, n)
    bad = cos_vn * dot3(v, h) <= 0.0
    cos2 = cos_vn * cos_vn
    tan2 = (1.0 - cos2) / jnp.maximum(cos2, 1e-12)
    g = 2.0 / (1.0 + jnp.sqrt(1.0 + alpha2 * tan2))
    g = jnp.where(jnp.abs(cos_vn - 1.0) < 1e-7, 1.0, g)
    return jnp.where(bad, 0.0, g)


def microfacet_scatter(d: V3, normal: V3, albedo: V3, roughness, f0,
                       metalness, u1, u2):
    """GGX-style microfacet (`Microfacet.cpp:93-225`), with a real PRNG in
    place of the reference's fixed-seed sampler (`Sampler`, seed 6 — noted in
    SURVEY.md as a bug to fix).  Returns (L, attenuation V3).

    The reference divides its attenuation (F G D)/(4 cos_o) by
    pdf = D/|4 d.H|, so D cancels: attenuation = F G |d.H| / cos_o * albedo.
    """
    n = normalize3(normal, eps=1e-20)
    alpha2 = roughness * roughness
    phi = 2.0 * PI * u2
    tan_theta2 = alpha2 * u1 / jnp.maximum(1.0 - u1, 1e-12)
    cos_theta = 1.0 / jnp.sqrt(1.0 + tan_theta2)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    local = V3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)
    h = normalize3(onb_local(n, local), eps=1e-20)

    l = normalize3(reflect3_(d, h), eps=1e-20)
    v = -d
    cos_i = dot3(l, n)
    valid = (dot3(d, n) < 0.0) & (cos_i > 0.0)

    spec_f0 = V3((1.0 - metalness) * f0 + metalness * albedo.x,
                 (1.0 - metalness) * f0 + metalness * albedo.y,
                 (1.0 - metalness) * f0 + metalness * albedo.z)
    ldoth = jnp.abs(dot3(l, h))
    om = (1.0 - ldoth) ** 5
    fr = V3(spec_f0.x + (1.0 - spec_f0.x) * om,
            spec_f0.y + (1.0 - spec_f0.y) * om,
            spec_f0.z + (1.0 - spec_f0.z) * om)
    g = _smith_g1(l, h, n, alpha2) * _smith_g1(v, h, n, alpha2)
    cos_o = jnp.abs(dot3(n, v))
    w = jnp.where(valid, g * ldoth / jnp.maximum(cos_o, 1e-12), 0.0)
    att = V3(fr.x * w * albedo.x, fr.y * w * albedo.y, fr.z * w * albedo.z)
    return l, att


def plastic_scatter(d: V3, normal: V3, diffuse: V3, specular: V3, ior,
                    u1, u2, u3):
    """Plastic (type 4): Fresnel-weighted diffuse + mirror-specular blend.

    The reference SHIPS a Plastic template (`MaterialTemplates.hpp:62-65`:
    diffuseColor, specularColor, refractIndex) but no reference renderer
    implements type 4, so these semantics are this rebuild's definition
    (documented divergence, VERDICT r2 #9): a dielectric coat with
    F0 = ((ior-1)/(ior+1))^2 Schlick Fresnel picks the mirror lobe with
    probability F (weight = specularColor) and the cosine-free uniform
    hemisphere diffuse lobe otherwise (weight = 2 cos * diffuseColor, the
    same estimator as the Lambertian lobe).  The stochastic selection's
    weight/probability cancellation makes the expectation
    F * specular * mirror + (1-F) * diffuse_estimator.  `specular` arrives
    through the albedo channel slots (see scene/arrays.py `_pack_material`).
    Returns (L, weight V3)."""
    n = normalize3(normal, eps=1e-20)
    cos_i = jnp.abs(dot3(d, n))
    n12 = (ior - 1.0) / (ior + 1.0)
    f0 = n12 * n12
    f = f0 + (1.0 - f0) * (1.0 - cos_i) ** 5

    d_spec = normalize3(reflect3_(d, n), eps=1e-20)
    local = hemisphere_from_uv(u1, u2)
    d_diff = normalize3(onb_local(n, local), eps=1e-20)
    cos_d = dot3(n, d_diff)

    choose_spec = u3 < f
    l = where3(choose_spec, d_spec, d_diff)
    w = where3(choose_spec, specular,
               V3(diffuse.x * 2.0 * cos_d, diffuse.y * 2.0 * cos_d,
                  diffuse.z * 2.0 * cos_d))
    return l, w


def make_mat_channels(ss: StaticScene):
    """Per-material constant tuples for the unrolled channel tracker:
    (type, diffuse rgb, albedo rgb, ior, absorbed rgb, eta_r rgb, eta_i rgb,
     roughness, f0, metalness) = 20 channels; +1 `stex` channel (the
    material's specularMap/map_Ks texture id, -1 = none) appended ONLY when
    the scene actually carries a specular map on a UV'd face — every other
    scene carries one channel less.  The decision is a function
    of `ss` alone, so every caller sharing the StaticScene agrees on the
    channel count (bsdf_bounce detects it by len)."""
    with_stex = bool(ss.tri_uv) and any(
        float(m.get("stex", -1.0)) >= 0.0 for m in ss.mats)
    ch = []
    for m in ss.mats:
        ch.append((float(m["type"]),)
                  + tuple(float(x) for x in m["diffuse"])
                  + tuple(float(x) for x in m["albedo"])
                  + (float(m["ior"]),)
                  + tuple(float(x) for x in m["absorbed"])
                  + tuple(float(x) for x in m["eta_r"])
                  + tuple(float(x) for x in m["eta_i"])
                  + (float(m["roughness"]), float(m["f0"]),
                     float(m["metalness"]))
                  + ((float(m.get("stex", -1.0)),) if with_stex else ()))
    return ch


def bsdf_bounce(ss: StaticScene, mat_ch, o: V3, d: V3, throughput: V3,
                radiance: V3, alive, u1, u2, u3, t_min: float = 1e-6,
                tri_bvh=None, with_miss: bool = False, textures=None
                ) -> Tuple[V3, V3, V3, V3, jnp.ndarray]:
    """One bounce of the AccPathTracer estimator
    (`AccPathTracer.cpp:120-181`): closest hit, light hit, then branchless
    dispatch over material type {0 Lambertian, 1 conductor, 2 glass,
    3 microfacet} (`acc/include/shaders/ShaderCreator.hpp:17-39`).
    `with_miss`: also return the env-candidate miss mask (see
    diffuse_bounce); `textures`: diffuseMap sampling (see diffuse_bounce)."""
    hit = closest_hit(ss, o, d, t_min, mat_ch, tri_bvh, alive=alive,
                      with_uv=bool(textures))
    t_l, light_rad = intersect_area_lights_unrolled(ss, o, d, t_min=t_min)

    obj_first = alive & hit.valid & (hit.t < t_l)
    light_hit = alive & ~obj_first & (t_l < jnp.inf)

    lw = light_hit.astype(o.x.dtype)
    radiance = V3(radiance.x + lw * throughput.x * light_rad.x,
                  radiance.y + lw * throughput.y * light_rad.y,
                  radiance.z + lw * throughput.z * light_rad.z)

    (mtype, dr, dg, db, ar, ag, ab_, ior, absr, absg, absb,
     err, erg, erb, eir, eig, eib, rough, f0, metal) = hit.channels[:20]
    stex = hit.channels[20] if len(hit.channels) > 20 else None
    diffuse = V3(dr, dg, db)
    albedo = V3(ar, ag, ab_)
    if textures:
        from .texture import resolve_diffuse
        diffuse = resolve_diffuse(textures, hit.uv, diffuse)
        if stex is not None:
            # map_Ks modulates the specular tint (conductor/microfacet/
            # plastic albedo) — exceeds the reference, which loads
            # map_Ks (`ObjImporter.cpp:56-58`) but never samples it
            albedo = resolve_diffuse(
                textures, (hit.uv[0], hit.uv[1], stex), albedo)
    absorbed = V3(absr, absg, absb)
    eta_r = V3(err, erg, erb)
    eta_i = V3(eir, eig, eib)

    # Which lobes can occur is a SCENE constant (material types are static):
    # only evaluate those — an all-Lambertian mesh scene skips the conductor/
    # glass/microfacet math entirely (the reference's virtual dispatch never
    # paid for absent types either).
    present = {int(m["type"]) for m in ss.mats}
    lobes = []  # (type id, direction V3, weight V3)
    local = hemisphere_from_uv(u1, u2)
    d_diff = normalize3(onb_local(hit.normal, local), eps=1e-20)
    cos = dot3(hit.normal, d_diff)
    lobes.append((0, d_diff, V3(diffuse.x * 2.0 * cos, diffuse.y * 2.0 * cos,
                                diffuse.z * 2.0 * cos)))
    if 1 in present:
        d_cond, w_cond = conductor_scatter(d, hit.normal, eta_r, eta_i,
                                           albedo)
        lobes.append((1, d_cond, w_cond))
    if 2 in present:
        d_glass, w_glass = glass_scatter(d, hit.normal, ior, absorbed, u3)
        lobes.append((2, d_glass, w_glass))
    if 3 in present or not present.issubset({0, 1, 2, 3, 4}):
        d_micro, w_micro = microfacet_scatter(d, hit.normal, albedo, rough,
                                              f0, metal, u1, u2)
        lobes.append((3, d_micro, w_micro))
    if 4 in present:
        # Plastic: specularColor rides the albedo channels (arrays.py)
        d_pl, w_pl = plastic_scatter(d, hit.normal, diffuse, albedo, ior,
                                     u1, u2, u3)
        lobes.append((4, d_pl, w_pl))

    new_d, w = lobes[0][1], lobes[0][2]
    for i, (type_id, ld, lw) in enumerate(lobes[1:], start=1):
        sel = mtype >= type_id - 0.5
        if i < len(lobes) - 1:  # last listed lobe catches higher types
            sel = sel & (mtype < type_id + 0.5)
        new_d = where3(sel, ld, new_d)
        w = where3(sel, lw, w)

    throughput = V3(throughput.x * jnp.where(obj_first, w.x, 1.0),
                    throughput.y * jnp.where(obj_first, w.y, 1.0),
                    throughput.z * jnp.where(obj_first, w.z, 1.0))
    o = where3(obj_first, hit.point, o)
    d = where3(obj_first, new_d, d)
    if with_miss:
        return o, d, throughput, radiance, obj_first, (alive & ~obj_first
                                                       & ~light_hit)
    return o, d, throughput, radiance, obj_first


def finish_ambient(ss: StaticScene, throughput: V3, radiance: V3,
                   alive) -> V3:
    """Depth-cap contribution: surviving paths see ambient.constant
    (`trace` line 145)."""
    if any(c != 0.0 for c in ss.ambient_constant):
        aw = alive.astype(radiance.x.dtype)
        radiance = V3(
            radiance.x + aw * throughput.x * float(ss.ambient_constant[0]),
            radiance.y + aw * throughput.y * float(ss.ambient_constant[1]),
            radiance.z + aw * throughput.z * float(ss.ambient_constant[2]))
    return radiance
