"""GeometryPreview: render-free scene/geometry preview.

Headless analogue of the reference viewport's PREVIEW wireframe mode
(`code/app/src/ui/views/ScreenView.cpp:11-52,224-306`): a
camera-matched GL wireframe with per-selection highlight colors shown
before/without running a renderer, so the user can check framing and
geometry placement instantly.  Without a GL surface the equivalent is a
single-pass depth+normal raycast:

  - one `intersect_scene` batch (no lights, no shadows, no bounces) shades
    every hit as headlit normal color tinted per MATERIAL index — distinct
    materials get distinct hues, the headless stand-in for the wireframe's
    selection-highlight palette;
  - area lights render as emissive white patches (the reference previews
    lights as star/loop figures, `Asset.cpp:125-135`);
  - resolution is capped (default 256 on the long side) and meshes are
    face-decimated to NR_PREVIEW_MAX_FACES (default 1024), so the pass
    compiles and runs in well under a second even for edited bunny scenes
    — geometry counts are trace-time constants, and the preview must stay
    instant across edits.

The `edit` CLI posts this to the Screen on every applied edit before the
full re-render starts (the reference shows PREVIEW while RESULT is stale).
"""
from __future__ import annotations

import copy
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.camera import CameraParams, make_camera, shoot_v3
from ..ops.intersect import (T_MIN_RAYCAST, intersect_area_lights,
                             intersect_scene, make_scene_soa, select_mat3)
from ..ops.soa import V3, dot3, normalize3, to_array
from ..scene.arrays import SceneArrays, build_scene_arrays
from ..scene.model import Mesh, Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import register_renderer

MAX_SIDE = 256          # preview framebuffer cap (long side)
MAX_FACES_DEFAULT = 1024  # per-mesh face cap before decimation


@partial(jax.jit, static_argnums=(2, 3))
def render_preview(scene_arrays: SceneArrays, cam: CameraParams,
                   width: int, height: int) -> jnp.ndarray:
    """(H, W, 3) headlit normal/material-tint preview, row 0 = BOTTOM."""
    scene = make_scene_soa(scene_arrays)
    jj = jnp.tile(jnp.arange(width, dtype=jnp.float32), (height,))
    ii = jnp.repeat(jnp.arange(height, dtype=jnp.float32), width)
    o, d = shoot_v3(cam, (jj + 0.5) / width, (ii + 0.5) / height)

    hit = intersect_scene(scene, o, d, t_min=T_MIN_RAYCAST)
    n = normalize3(hit.normal, eps=1e-12)
    ndl = dot3(n, d)
    # two-sided: flip normals facing away from the camera
    flip = jnp.where(ndl > 0, -1.0, 1.0)
    n = V3(n.x * flip, n.y * flip, n.z * flip)
    headlight = jnp.abs(ndl)

    # per-material tint: golden-ratio hue walk over the material table —
    # the headless stand-in for the wireframe's selection palette
    mt = scene.mat
    midx = jnp.arange(mt.type.shape[0], dtype=jnp.float32)
    h6 = (midx * 0.618034 % 1.0) * 6.0
    tint = V3(jnp.clip(jnp.abs(h6 - 3.0) - 1.0, 0.3, 1.0),
              jnp.clip(2.0 - jnp.abs(h6 - 2.0), 0.3, 1.0),
              jnp.clip(2.0 - jnp.abs(h6 - 4.0), 0.3, 1.0))
    tint = select_mat3(hit.mat_oh, tint)

    lit = 0.35 + 0.65 * headlight
    w = hit.valid.astype(jnp.float32)
    base = V3(*(w * lit * (0.55 * (0.5 + 0.5 * c) + 0.45 * t)
                for c, t in zip(n, tint)))

    # area lights draw as emissive white patches when nearer than geometry
    t_l, _ = intersect_area_lights(scene, o, d, t_min=T_MIN_RAYCAST)
    lt = (t_l < hit.t) & jnp.isfinite(t_l)
    bg = 0.08  # miss: dark background
    color = V3(*(jnp.where(lt, 1.0, jnp.where(hit.valid, c, bg))
                 for c in base))
    color = V3(*(jnp.sqrt(jnp.clip(c, 0.0, 1.0)) for c in color))
    return to_array(color).reshape(height, width, 3)


def _decimate_mesh(mesh: Mesh, max_faces: int) -> Mesh:
    idx = np.asarray(mesh.position_indices).reshape(-1, 3)
    faces = idx.shape[0]
    if faces <= max_faces:
        return mesh
    k = -(-faces // max_faces)  # every k-th face keeps the silhouette
    take = lambda a: (np.asarray(a).reshape(-1, 3)[::k].reshape(-1)
                      if len(a) else a)
    return Mesh(positions=mesh.positions, normals=mesh.normals,
                uvs=mesh.uvs, position_indices=take(mesh.position_indices),
                normal_indices=take(mesh.normal_indices),
                uv_indices=take(mesh.uv_indices), material=mesh.material)


def preview_scene(scene: Scene) -> Scene:
    """Shallow preview copy: meshes decimated to the face cap; everything
    else shared.  Returns `scene` itself when nothing needs decimating."""
    max_faces = int(os.environ.get("NR_PREVIEW_MAX_FACES",
                                   str(MAX_FACES_DEFAULT)))
    if all(len(m.position_indices) // 3 <= max_faces
           for m in scene.mesh_buffer):
        return scene
    s = copy.copy(scene)
    s.mesh_buffer = [_decimate_mesh(m, max_faces) for m in scene.mesh_buffer]
    return s


def preview_size(width: int, height: int, cap: int = MAX_SIDE):
    long_side = max(width, height, 1)
    if long_side <= cap:
        return max(width, 1), max(height, 1)
    return (max(1, round(width * cap / long_side)),
            max(1, round(height * cap / long_side)))


@register_renderer("GeometryPreview", description=(
    "Instant render-free geometry preview.\n"
    "Depth/normal raycast with per-material tint; the headless analogue "
    "of the viewport's wireframe PREVIEW mode."))
class GeometryPreviewRenderer(RenderComponent):
    def render(self, scene: Scene) -> RenderResult:
        w, h = preview_size(scene.render_option.width,
                            scene.render_option.height)
        arrays = build_scene_arrays(preview_scene(scene))
        cam = make_camera(scene.camera)
        img = np.asarray(render_preview(arrays, cam, w, h))[::-1]
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)
