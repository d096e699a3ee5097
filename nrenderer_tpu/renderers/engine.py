"""The one place that picks a path-tracing engine.

Every path tracer and the benchmark call `choose_engine`.  It decides from
what the code can see — the platform, dense scene versus mesh, ambient
type, lens and textures — and from nothing else:

  - "megakernel": the GPU megakernel (`ops.pt_pallas`), for dense scenes
    with constant ambient, a pinhole camera and no textures, on the GPU;
  - "xla": the XLA wavefront (`renderers._wavefront`), everywhere else.
"""
from __future__ import annotations

import jax

MEGAKERNEL = "megakernel"
XLA = "xla"


def choose_engine(ss, *, mesh: bool, has_lens: bool, textures,
                  platform: str = None) -> str:
    """`ss`: the StaticScene; `mesh`: triangles go through a mesh
    accelerator; `textures`: the scene's surface textures (or None)."""
    platform = platform or jax.default_backend()
    n_prims = len(ss.sph) + len(ss.pln) + len(ss.tri)
    if (platform == "gpu" and not mesh and ss.ambient_type == 0
            and not has_lens and not textures and n_prims > 0):
        return MEGAKERNEL
    return XLA
