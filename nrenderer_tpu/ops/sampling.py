"""Counter-based random sampling for render kernels.

Replaces the reference's `thread_local` time-seeded sampler objects
(`simple_path_tracing/include/samplers/*`, seeded `time(0)+counter`,
`Marsaglia.hpp:17-20`) with stateless JAX PRNG: every pixel/sample/bounce gets
an independent stream derived by `fold_in`, so renders are reproducible and
race-free by construction (SURVEY.md §5.2).

Distributions mirror the reference samplers:
  - uniform_square: [-1, 1]^2            (`UniformInSquare.hpp:11-24`)
  - uniform_circle: unit disk            (`UniformInCircle.hpp` — the reference
    uses rejection with a typo'd test; we use the exact polar map)
  - hemisphere: uniform hemisphere about +z, pdf = 1/(2 pi)
    (`Hemisphere.hpp:11-33`: z = e1, r = sqrt(1 - e1^2), angle = 2 pi e2)
  - sphere: uniform sphere (Marsaglia)   (`Marsaglia.hpp:11-35`)
  - cosine_hemisphere: cosine-weighted (used by MLT's VecCosine and by NEE)
"""
from __future__ import annotations

import os
from typing import Tuple

import jax
import jax.numpy as jnp

from .vecmath import cross, dot, normalize

PI = jnp.pi


def make_base_key(seed: int, impl: str = None):
    """Base PRNG key for a render.

    Default impl is `rbg` (XLA's RngBitGenerator, which the backend lowers
    to its own generator instead of threefry's ~20 ALU ops).  Override
    with NR_PRNG=threefry2x32 for the counter-based reference-quality stream;
    rendering only needs statistical quality, and every (pixel, sample,
    bounce) still gets an independent folded stream either way."""
    impl = impl or os.environ.get("NR_PRNG", "rbg")
    try:
        return jax.random.key(seed, impl=impl)
    except Exception:
        return jax.random.PRNGKey(seed)


def uniform_square(key, shape=()) -> jnp.ndarray:
    """(..., 2) uniform in [-1, 1]^2 (pixel jitter, UniformInSquare)."""
    return jax.random.uniform(key, shape + (2,), minval=-1.0, maxval=1.0)


def uniform_circle(key, shape=()) -> jnp.ndarray:
    """(..., 2) uniform in the unit disk (thin-lens aperture sampling)."""
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(jax.random.uniform(k1, shape))
    phi = jax.random.uniform(k2, shape, maxval=2.0 * PI)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def hemisphere(key, shape=()) -> jnp.ndarray:
    """(..., 3) uniform on the +z hemisphere; pdf = 1/(2 pi).

    Exactly the reference's map (`Hemisphere.hpp:25-32`): z = e1,
    r = sqrt(1 - e1^2), (x, y) = r (cos, sin)(2 pi e2)."""
    k1, k2 = jax.random.split(key)
    e1 = jax.random.uniform(k1, shape)
    e2 = jax.random.uniform(k2, shape)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - e1 * e1))
    phi = 2.0 * PI * e2
    return jnp.stack([jnp.cos(phi) * r, jnp.sin(phi) * r, e1], axis=-1)


def sphere(key, shape=()) -> jnp.ndarray:
    """(..., 3) uniform on the unit sphere."""
    k1, k2 = jax.random.split(key)
    z = jax.random.uniform(k1, shape, minval=-1.0, maxval=1.0)
    phi = jax.random.uniform(k2, shape, maxval=2.0 * PI)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def cosine_hemisphere(key, shape=()) -> jnp.ndarray:
    """(..., 3) cosine-weighted on the +z hemisphere; pdf = cos(theta)/pi."""
    k1, k2 = jax.random.split(key)
    e1 = jax.random.uniform(k1, shape)
    e2 = jax.random.uniform(k2, shape)
    r = jnp.sqrt(e1)
    phi = 2.0 * PI * e2
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - e1))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


# ---------------------------------------------------------------------------
# Component-SoA variants (hot-path layout; see ops/soa.py)
# ---------------------------------------------------------------------------

def hemisphere_v3(key, shape=()) -> "V3":
    """V3 of uniform hemisphere samples about +z; pdf = 1/(2 pi)."""
    from .soa import V3
    k1, k2 = jax.random.split(key)
    e1 = jax.random.uniform(k1, shape)
    e2 = jax.random.uniform(k2, shape)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - e1 * e1))
    phi = 2.0 * PI * e2
    return V3(jnp.cos(phi) * r, jnp.sin(phi) * r, e1)


def cosine_hemisphere_v3(key, shape=()) -> "V3":
    """V3 cosine-weighted samples about +z; pdf = cos/pi."""
    from .soa import V3
    k1, k2 = jax.random.split(key)
    e1 = jax.random.uniform(k1, shape)
    e2 = jax.random.uniform(k2, shape)
    r = jnp.sqrt(e1)
    phi = 2.0 * PI * e2
    return V3(r * jnp.cos(phi), r * jnp.sin(phi),
              jnp.sqrt(jnp.maximum(0.0, 1.0 - e1)))


def onb_v3(normal):
    """SoA orthonormal basis matching the reference Onb (`Onb.hpp:17-27`)."""
    from .soa import V3, cross3, normalize3
    w = normal
    big_x = jnp.abs(w.x) > 0.9
    a = V3(jnp.where(big_x, 0.0, 1.0), jnp.where(big_x, 1.0, 0.0),
           jnp.zeros_like(w.x))
    v = normalize3(cross3(w, a))
    u = cross3(w, v)
    return u, v, w


def onb_local_v3(normal, vec):
    """`Onb::local`: vec.x*u + vec.y*v + vec.z*w in SoA form."""
    from .soa import V3
    u, v, w = onb_v3(normal)
    return V3(vec.x * u.x + vec.y * v.x + vec.z * w.x,
              vec.x * u.y + vec.y * v.y + vec.z * w.y,
              vec.x * u.z + vec.y * v.z + vec.z * w.z)


def onb(normal: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Orthonormal basis (u, v, w=normal) matching the reference's Onb
    (`simple_path_tracing/include/Onb.hpp:17-27`):

        a = |w.x| > 0.9 ? (0,1,0) : (1,0,0)
        v = normalize(cross(w, a));  u = cross(w, v)
    """
    w = normal
    a = jnp.where(jnp.abs(w[..., 0:1]) > 0.9,
                  jnp.array([0.0, 1.0, 0.0], dtype=w.dtype),
                  jnp.array([1.0, 0.0, 0.0], dtype=w.dtype))
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_local(normal: jnp.ndarray, vec: jnp.ndarray) -> jnp.ndarray:
    """Transform `vec` from the ONB local frame (z = normal) to world:
    `Onb::local` = x*u + y*v + z*w."""
    u, v, w = onb(normal)
    return (vec[..., 0:1] * u + vec[..., 1:2] * v + vec[..., 2:3] * w)
