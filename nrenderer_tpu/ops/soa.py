"""Component-SoA vector math — the data layout for ray batches.

A `(N, 3)` array interleaves the 3 vector components in the minor
dimension, so every elementwise op strides over mixed components.  Storing
each component as its own `(N,)` array makes every elementwise op a dense,
contiguous stream, and lets the same bounce code run on (N,) wavefronts and
on the megakernel's per-thread pixel blocks.  This module is the foundation
the render kernels are written against.

`V3` is a pytree (NamedTuple) of three same-shaped arrays with operator
overloads, so kernel code reads like the glm math it replaces
(`code/include/geometry/vec.hpp`) while staying layout-optimal."""
from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Scalar = Union[float, jnp.ndarray]


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- shape plumbing -----------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.x)

    def astype(self, dtype):
        return V3(self.x.astype(dtype), self.y.astype(dtype),
                  self.z.astype(dtype))

    def reshape(self, *shape):
        return V3(self.x.reshape(*shape), self.y.reshape(*shape),
                  self.z.reshape(*shape))


def v3(x, y, z) -> V3:
    return V3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))


def splat(arr) -> V3:
    """From a length-3 (or (..., 3)) array: components along the last axis."""
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])


def to_array(v: V3) -> jnp.ndarray:
    """Back to (..., 3) (host hand-off / film assembly only — not hot path)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def dot3(a: V3, b: V3) -> jnp.ndarray:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross3(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def norm3(a: V3) -> jnp.ndarray:
    return jnp.sqrt(dot3(a, a))


def normalize3(a: V3, eps: float = 0.0) -> V3:
    n2 = dot3(a, a)
    if eps:
        # floor inside the f32 NORMAL range: eps^2 can be subnormal, which
        # flush-to-zero arithmetic turns into rsqrt(0)=inf -> NaN
        n2 = jnp.maximum(n2, max(eps * eps, 1.2e-38))
    inv = jax.lax.rsqrt(n2)
    return V3(a.x * inv, a.y * inv, a.z * inv)


def where3(cond, a: V3, b: V3) -> V3:
    return V3(jnp.where(cond, a.x, b.x), jnp.where(cond, a.y, b.y),
              jnp.where(cond, a.z, b.z))


def reflect3(d: V3, n: V3) -> V3:
    """d - 2*dot(d,n)*n (`vec.hpp:57-59`)."""
    k = 2.0 * dot3(d, n)
    return V3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def lerp3(a: V3, b: V3, t) -> V3:
    return V3(a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
              a.z + (b.z - a.z) * t)


def select_prim(one_hot: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """Gather-free attribute selection: `one_hot` (P, N) float mask with one 1
    per column, `table` (P,) per-prim attribute -> (N,) selected values.
    Lowered as a broadcast-multiply + reduction over the small P axis, with
    no dynamic gather."""
    return jnp.sum(one_hot * table[:, None], axis=0)


def select_prim3(one_hot: jnp.ndarray, table: V3) -> V3:
    return V3(select_prim(one_hot, table.x), select_prim(one_hot, table.y),
              select_prim(one_hot, table.z))


def one_hot_argmin(t: jnp.ndarray) -> jnp.ndarray:
    """(P, N) -> (P, N) float one-hot of the per-column argmin (first wins)."""
    idx = jnp.argmin(t, axis=0)                      # (N,)
    p = t.shape[0]
    iota = jnp.arange(p, dtype=idx.dtype)[:, None]   # (P, 1)
    return (iota == idx[None, :]).astype(t.dtype)
