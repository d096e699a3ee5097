"""RayCast renderer: single-bounce Phong/Lambert direct lighting.

Rebuild of the ray_cast plugin (`components/ray_cast/src/RayCastRenderer.cpp`):
one hard-coded point light (`pointLightBuffer[0]`), a shadow ray with
epsilon 0.01, Phong/Lambert shading by material type {0: Lambertian,
1: Phong} (`ray_cast/include/shaders/ShaderCreator.hpp:15-30`), clamp +
sqrt gamma, and the bottom-up pixel write folded into a final flip.

Design: the whole image is ONE jitted batch in component-SoA layout
(ops/soa.py) — primary rays, the dense closest-hit, the shadow-ray pass, and
branchless material shading all evaluate as (H*W)-wide ops; there is no
per-pixel loop."""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.camera import CameraParams, make_camera, shoot_v3
from ..ops.intersect import (
    T_MIN_RAYCAST, intersect_scene, make_scene_soa, select_mat, select_mat3,
)
from ..ops.soa import V3, dot3, normalize3, reflect3, to_array, where3
from ..scene.arrays import SceneArrays, build_scene_arrays
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import register_renderer


@partial(jax.jit, static_argnums=(2, 3))
def render_raycast(scene_arrays: SceneArrays, cam: CameraParams,
                   width: int, height: int) -> jnp.ndarray:
    """Returns an (H, W, 3) image, row 0 = BOTTOM (caller flips).

    Lighting: the reference shades `pointLightBuffer[0]` ONLY
    (`RayCastRenderer.cpp:70`); the rebuild sums every valid point,
    directional, and spot light with per-light shadow rays (documented
    divergence — the reference declares the structs in `Light.hpp:52-67`
    and the `.scn` grammar parses them, but no shipped renderer reads
    them).  Identical to the reference on the stock one-point-light
    scenes."""
    scene = make_scene_soa(scene_arrays)
    jj = jnp.tile(jnp.arange(width, dtype=jnp.float32), (height,))
    ii = jnp.repeat(jnp.arange(height, dtype=jnp.float32), width)
    o, d = shoot_v3(cam, jj / width, ii / height)

    hit = intersect_scene(scene, o, d, t_min=T_MIN_RAYCAST)
    # ray_cast normalizes normals in its intersections; do it at shading time
    n = normalize3(hit.normal, eps=1e-12)

    # branchless Phong/Lambert over the material table
    mt = scene.mat
    diffuse_c = select_mat3(hit.mat_oh, mt.diffuse)
    specular_c = select_mat3(hit.mat_oh, mt.specular)
    spec_ex = select_mat(hit.mat_oh, mt.specular_ex)
    is_phong = select_mat(hit.mat_oh, (mt.type == 1).astype(jnp.float32))

    def shade(out, lit_mask, valid, radiance, scale=1.0):
        """Phong/Lambert response to light arriving along -`out`."""
        facing = dot3(out, n) > 0
        cos_on = dot3(out, n)
        r = reflect3(out, n)
        vr = dot3(-d, r)
        # |pow(v.r, ex)| (`Phong.cpp:29-30`); |v.r|^ex avoids the NaN
        # that C++ pow(negative, fractional) would produce
        spec_w = jnp.power(jnp.maximum(jnp.abs(vr), 1e-30), spec_ex)
        w = (hit.valid & facing & lit_mask & valid).astype(
            jnp.float32) * scale
        return V3(
            w * radiance[0] * (diffuse_c.x * cos_on
                               + is_phong * specular_c.x * spec_w),
            w * radiance[1] * (diffuse_c.y * cos_on
                               + is_phong * specular_c.y * spec_w),
            w * radiance[2] * (diffuse_c.z * cos_on
                               + is_phong * specular_c.z * spec_w))

    def occluded_within(out, dist):
        shadow = intersect_scene(scene, hit.point, out, t_min=T_MIN_RAYCAST)
        return (~shadow.valid) | (shadow.t > dist)

    zero = jnp.zeros_like(hit.point.x)
    acc = V3(zero, zero, zero)

    for i in range(scene_arrays.pl_valid.shape[0]):
        lp = scene_arrays.pl_pos[i]
        to_light = V3(lp[0] - hit.point.x, lp[1] - hit.point.y,
                      lp[2] - hit.point.z)
        dist = jnp.sqrt(dot3(to_light, to_light))
        out = V3(to_light.x / dist, to_light.y / dist, to_light.z / dist)
        c = shade(out, occluded_within(out, dist),
                  scene_arrays.pl_valid[i], scene_arrays.pl_intensity[i])
        acc = V3(acc.x + c.x, acc.y + c.y, acc.z + c.z)

    for i in range(scene_arrays.dl_valid.shape[0]):
        dd = scene_arrays.dl_dir[i]
        inv = 1.0 / jnp.sqrt(jnp.maximum(
            dd[0] ** 2 + dd[1] ** 2 + dd[2] ** 2, 1e-20))
        out = V3(jnp.broadcast_to(-dd[0] * inv, zero.shape),
                 jnp.broadcast_to(-dd[1] * inv, zero.shape),
                 jnp.broadcast_to(-dd[2] * inv, zero.shape))
        c = shade(out, occluded_within(out, jnp.inf),
                  scene_arrays.dl_valid[i], scene_arrays.dl_irradiance[i])
        acc = V3(acc.x + c.x, acc.y + c.y, acc.z + c.z)

    for i in range(scene_arrays.sl_valid.shape[0]):
        lp = scene_arrays.sl_pos[i]
        to_light = V3(lp[0] - hit.point.x, lp[1] - hit.point.y,
                      lp[2] - hit.point.z)
        dist = jnp.sqrt(dot3(to_light, to_light))
        out = V3(to_light.x / dist, to_light.y / dist, to_light.z / dist)
        sd = scene_arrays.sl_dir[i]
        sinv = 1.0 / jnp.sqrt(jnp.maximum(
            sd[0] ** 2 + sd[1] ** 2 + sd[2] ** 2, 1e-20))
        # cone falloff: smooth between hotSpot (full) and fallout (zero),
        # angles in radians (`Light.hpp:64-65` defaults pi/4, pi/3)
        cos_theta = -(out.x * sd[0] + out.y * sd[1] + out.z * sd[2]) * sinv
        cos_hot = jnp.cos(scene_arrays.sl_cone[i][0])
        cos_fall = jnp.cos(scene_arrays.sl_cone[i][1])
        cone = jnp.clip((cos_theta - cos_fall)
                        / jnp.maximum(cos_hot - cos_fall, 1e-6), 0.0, 1.0)
        c = shade(out, occluded_within(out, dist),
                  scene_arrays.sl_valid[i], scene_arrays.sl_intensity[i],
                  scale=cone)
        acc = V3(acc.x + c.x, acc.y + c.y, acc.z + c.z)

    color = V3(*(jnp.sqrt(jnp.clip(c, 0.0, 1.0)) for c in acc))
    return to_array(color).reshape(height, width, 3)


@register_renderer("RayCast", description=(
    "A simple ray cast renderer.\n"
    "Phong/Lambertian direct lighting from one point light, with shadows."))
class RayCastRenderer(RenderComponent):
    def render(self, scene: Scene) -> RenderResult:
        from ..server.registry import get_server
        from ..utils.timing import PhaseTimer
        timer = PhaseTimer()
        w = scene.render_option.width
        h = scene.render_option.height
        with timer.phase("scene-prep"):
            arrays = build_scene_arrays(scene)
            cam = make_camera(scene.camera)
        with timer.phase("render(+compile)"):
            img = np.asarray(render_raycast(arrays, cam, w, h))
        img = img[::-1]  # bottom-up scan -> row 0 = top
        get_server().logger.log("phases: " + timer.summary())
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)
