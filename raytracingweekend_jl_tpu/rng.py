"""Counter-based stateless RNG streams.

The reference uses one mutable ``Xoroshiro128Plus`` per OS thread
(reference: src/init.jl:2-12, src/rand.jl:2-13), which makes every sample
schedule-dependent. This design replaces that with JAX's
counter-based threefry keys: every consumption site derives its key by
``fold_in``-ing a static *purpose* tag plus its (chunk, sample, bounce)
coordinates, so any pixel/sample/bounce draw is reproducible independent of
device count, sharding, or execution order of everything else.

Rejection loops (reference: src/rand.jl:15-22, :31-38) are replaced by
closed-form, branch-free, differentiable samplers in ``ops/sampling.py``.
"""

from __future__ import annotations

import jax

# Static purpose tags — one per consumption site class
# (reference consumption sites enumerated in SURVEY.md §2.5).
PIXEL_JITTER = 0x01  # src/render.jl:34-35
LENS = 0x02          # src/camera.jl:44
SCATTER_DIR = 0x03   # src/material.jl:14,32 (unit-sphere vector)
SCHLICK = 0x04       # src/material.jl:47 (reflect-vs-refract coin)
SCENE_GEN = 0x05     # src/scenes.jl:57-70


def purpose_key(key: jax.Array, purpose: int, *coords: int) -> jax.Array:
    """Derive the stream for one (purpose, coords...) consumption site."""
    key = jax.random.fold_in(key, purpose)
    for c in coords:
        key = jax.random.fold_in(key, c)
    return key
