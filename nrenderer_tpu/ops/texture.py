"""Surface texture sampling.

The reference imports `map_Kd` textures (`ObjImporter.cpp`), stores them on
materials, and plumbs them into every shader constructor (`Shader.hpp:22`)
— but no shade() ever reads them.  The rebuild completes the path: mesh UVs
flow through SceneArrays (`scene/arrays.py` tri_uv*) and the unrolled
intersector tracks the hit's interpolated UV + texture id, which this
module resolves to a diffuse color.

Texture count is a trace-time constant, so the per-texture gathers unroll
and blend with a select chain — no dynamic dispatch, same pattern as the
material-type lobes in `pt_core.bsdf_bounce`.
"""
from __future__ import annotations

import jax.numpy as jnp

from .soa import V3, where3


def sample_texture(tex: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> V3:
    """Nearest-neighbor lookup with wrap; OBJ convention (v=0 is the BOTTOM
    row of the image, which loaders store last).  tex: (H, W, 3)."""
    h, w = tex.shape[0], tex.shape[1]
    # Keep % for genuine out-of-[0,1] tiling, but CLAMP the boundary texel:
    # u=1.0 / v=0.0 must land on the last column / bottom row, not wrap to
    # the opposite edge (floor((1-0.0)*h) % h hit row 0, the TOP,
    # for v=0 exactly — same clamp-after-flip recipe as sample_env_map).
    u = jnp.where((u < 0.0) | (u > 1.0), u - jnp.floor(u), u)
    v = jnp.where((v < 0.0) | (v > 1.0), v - jnp.floor(v), v)
    x = jnp.clip(jnp.floor(u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.floor((1.0 - v) * h).astype(jnp.int32), 0, h - 1)
    idx = y * w + x
    flat = tex.reshape(-1, 3)
    return V3(jnp.take(flat[:, 0], idx, mode="clip"),
              jnp.take(flat[:, 1], idx, mode="clip"),
              jnp.take(flat[:, 2], idx, mode="clip"))


def resolve_diffuse(textures, uv, diffuse: V3) -> V3:
    """Replace `diffuse` with the sampled texel where the hit carries a
    texture id.  `textures`: tuple of (H, W, 3) arrays (static length);
    `uv`: (tu, tv, tid) from `intersect_scene_unrolled(..., with_uv=True)`."""
    if not textures or uv is None:
        return diffuse
    tu, tv, tid = uv
    out = diffuse
    for i, tex in enumerate(textures):
        texel = sample_texture(tex, tu, tv)
        out = where3((tid > i - 0.5) & (tid < i + 0.5), texel, out)
    return out
