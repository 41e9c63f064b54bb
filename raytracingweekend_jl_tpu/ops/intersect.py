"""Batched ray–sphere intersection sweep (XLA path).

The reference intersects one ray against one sphere at a time with a half-b
quadratic exploiting unit ray directions (``a == 1``), then linearly scans the
sphere list tracking the closest hit (reference: src/hit.jl:12-50). The
array formulation computes the whole ``[R] x [N]`` sweep at once and
reduces with a fused argmin:

- the two ray⊗sphere inner products are expressed as ``[R,3] @ [3,N]``
  contractions, one XLA op each;
- ``|oc|^2`` is expanded as ``|o|^2 - 2 o·c + (|c|^2 - r^2)`` with the
  per-sphere constant ``|c|^2 - r^2`` computed once per call — numerically
  *better* than the naive float32 ``oc·oc`` for huge ground spheres because the
  large ``|c|^2`` and ``r^2`` cancel in a single precomputed term;
- root selection (near root first, then far; each tested against
  ``[tmin, tmax]`` — reference src/hit.jl:22-29) happens per pair, and the
  closest-hit scan becomes a min+argmin over the sphere axis.

Signed radii need no special casing: the discriminant uses ``r^2`` and the
normal ``(p - c)/r`` flips automatically (reference: src/hit.jl:33).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene import Scene

#: Shadow-acne epsilon (reference: src/ray_color.jl:19 uses T(1e-4)).
DEFAULT_TMIN = 1e-4
#: Stand-in for the reference's ``typemax(T)`` tmax.
BIG = 3.0e38


class HitResult(NamedTuple):
    """SoA hit record batch — the wavefront counterpart of the reference's
    ``HitRecord`` (src/structs.jl:16-29). Normal/front-face/material lookups are
    deferred to the shading stage to keep the sweep's working set minimal."""

    t: jnp.ndarray    # [R] distance of closest hit (== tmax where no hit)
    index: jnp.ndarray  # [R] int32 sphere index of closest hit (0 where no hit)
    hit: jnp.ndarray  # [R] bool, True where some sphere was hit in (tmin, tmax)


def intersect_spheres(origin: jnp.ndarray, direction: jnp.ndarray, scene: Scene,
                      tmin: float = DEFAULT_TMIN, tmax: float = BIG) -> HitResult:
    """Closest-hit sweep of ``R`` rays against all scene spheres.

    Args:
      origin:    [R,3] ray origins.
      direction: [R,3] *unit* ray directions (invariant guaranteed by the
                 camera and every scatter function, as in the reference).
      scene:     SoA scene (padded spheres have radius 0 → can never hit).
      tmin/tmax: acceptance interval, open at both ends exactly like the
                 reference's ``root < tmin || tmax < root`` rejection
                 (src/hit.jl:23-27 rejects only strictly-outside roots, i.e.
                 the interval is closed; we match closed).
    """
    dtype = origin.dtype
    big = jnp.asarray(tmax, dtype)

    centers = scene.center.astype(dtype)          # [N,3]
    # Per-sphere constant |c|^2 - r^2, computed inside the traced function so
    # gradients flow into centers and radii.
    ck = jnp.sum(centers * centers, axis=-1) - scene.radius.astype(dtype) ** 2  # [N]

    # Per-ray scalars.
    od = jnp.sum(origin * direction, axis=-1)     # [R]  o·d
    oo = jnp.sum(origin * origin, axis=-1)        # [R]  |o|^2

    # Ray⊗sphere contractions [R,3] @ [3,N]. HIGHEST precision is mandatory:
    # a default-precision dot may demote its operands (bfloat16 or TF32),
    # whose short mantissa corrupts hit distances by ~1% (visibly wrong
    # images against the sweep kernel and the CPU goldens).
    cd = jnp.dot(direction, centers.T, precision=jax.lax.Precision.HIGHEST)
    oc = jnp.dot(origin, centers.T, precision=jax.lax.Precision.HIGHEST)

    # half_b = oc_vec·d with oc_vec = o - c  (reference: src/hit.jl:16)
    half_b = od[:, None] - cd
    # c = |oc_vec|^2 - r^2 (reference: src/hit.jl:17), stable expansion.
    c = oo[:, None] - 2.0 * oc + ck[None, :]

    disc = half_b * half_b - c                    # (reference: src/hit.jl:18, a == 1)
    # Grad-safe sqrt: tangent hits (disc == 0) count as misses — a
    # measure-zero deviation from the reference's `disc < 0 -> miss`
    # (src/hit.jl:19) that buys NaN-free reverse mode.
    sqrtd = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))

    root_near = -half_b - sqrtd                   # (reference: src/hit.jl:23)
    root_far = -half_b + sqrtd                    # (reference: src/hit.jl:25)

    valid = disc > 0
    near_ok = valid & (root_near >= tmin) & (root_near <= tmax)
    far_ok = valid & (root_far >= tmin) & (root_far <= tmax)
    t_cand = jnp.where(near_ok, root_near, jnp.where(far_ok, root_far, big))

    # Closest-hit reduction over the sphere axis (replaces the reference's
    # shrinking-`closest` linear scan, src/hit.jl:38-50).
    idx = jnp.argmin(t_cand, axis=-1).astype(jnp.int32)
    t = jnp.min(t_cand, axis=-1)
    hit = t < big
    return HitResult(t=t, index=idx, hit=hit)
