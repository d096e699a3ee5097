"""Environment-map sampling.

The reference declares `Ambient::ENVIROMENT_MAP` (`Scene.hpp:29-38`) and the
UI lets users attach a map, but no shipped renderer ever samples it (verified:
no component reads `ambient.environmentMap`).  The rebuild implements it
properly: misses look up an equirectangular (lat/long) map by ray direction.
"""
from __future__ import annotations

import jax.numpy as jnp

from .vecmath import normalize

PI = jnp.pi


def sample_env_map(env: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Equirectangular lookup: env (He, We, 3), d (..., 3) unit directions.
    +y maps to the top row; phi = atan2(z, x)."""
    he, we = env.shape[0], env.shape[1]
    dn = normalize(d, eps=1e-12)
    u = 0.5 + jnp.arctan2(dn[..., 2], dn[..., 0]) / (2.0 * PI)
    v = 0.5 - jnp.arcsin(jnp.clip(dn[..., 1], -1.0, 1.0)) / PI
    x = jnp.clip((u * we).astype(jnp.int32), 0, we - 1)
    y = jnp.clip((v * he).astype(jnp.int32), 0, he - 1)
    flat = env.reshape(-1, 3)
    return jnp.take(flat, y * we + x, axis=0, mode="clip")


def sample_env_map_v3(env: jnp.ndarray, d) -> "V3":
    """SoA variant: d is a V3 of (N,) components; returns V3 radiance."""
    from .soa import V3, normalize3
    he, we = env.shape[0], env.shape[1]
    dn = normalize3(d, eps=1e-12)
    u = 0.5 + jnp.arctan2(dn.z, dn.x) / (2.0 * PI)
    v = 0.5 - jnp.arcsin(jnp.clip(dn.y, -1.0, 1.0)) / PI
    x = jnp.clip((u * we).astype(jnp.int32), 0, we - 1)
    y = jnp.clip((v * he).astype(jnp.int32), 0, he - 1)
    idx = y * we + x
    flat = env.reshape(-1, 3)
    return V3(jnp.take(flat[:, 0], idx, mode="clip"),
              jnp.take(flat[:, 1], idx, mode="clip"),
              jnp.take(flat[:, 2], idx, mode="clip"))
