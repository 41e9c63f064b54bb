"""Fused scatter/shading stage — masked-blend material dispatch.

The reference dispatches ``scatter`` dynamically on the material type of the
hit object (reference: src/material.jl:13-53). With only three material kinds,
the array form here computes all three candidate scatter directions for every
ray with shared random draws and blends by the integer material code — fully
branch-free, vectorised, and differentiable through every continuous quantity
(normals, hit points, albedos, fuzz, Schlick reflectance), with the discrete
choices (material code, reflect-vs-refract coin, front-face flip) detached,
matching the straight-through approach of differentiable ray tracers
(RayTracer.jl, PAPERS.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene import Scene, LAMBERTIAN, METAL
from .vecmath import (dot, normalize, reflect, refract, reflectance, safe_sqrt,
                      NEAR_ZERO_EPS)
from .sampling import unit_sphere_directions


class ScatterResult(NamedTuple):
    """Batch counterpart of the reference's ``Scatter`` (src/structs.jl:37-44).

    The reference's ``reflected`` flag is always true in book 1
    (SURVEY.md §2.6) so absorption is represented only by depth exhaustion;
    we mirror that by having no absorb flag at all."""

    origin: jnp.ndarray       # [R,3] new ray origins (the hit points)
    direction: jnp.ndarray    # [R,3] new unit ray directions
    attenuation: jnp.ndarray  # [R,3] throughput multiplier


def _per_ray_draws(keys: jax.Array, dtype):
    """Counter-based per-ray randoms from a batch of per-ray keys.

    Each ray's unit-sphere sample and Schlick coin come from its own key
    (derived by the caller from stable coordinates like (slot, sample, bounce))
    so the draws are invariant to where the ray currently sits in the
    wavefront array — the property that makes compaction, persistent
    regeneration, and resharding reproducible (SURVEY.md §2.5's counter-based
    RNG design).
    """
    def one_ray(k):
        kd, kc = jax.random.split(k)
        return jax.random.normal(kd, (3,), dtype=dtype), \
            jax.random.uniform(kc, (), dtype=dtype)

    g, xi = jax.vmap(one_ray)(keys)
    sq = jnp.sum(g * g, axis=-1, keepdims=True)
    u = g * jax.lax.rsqrt(jnp.maximum(sq, jnp.asarray(1e-20, dtype)))
    return u, xi


def slot_keys(key: jax.Array, slots: jnp.ndarray) -> jax.Array:
    """[R] per-ray keys from a base key + slot ids (``fold_in`` per ray)."""
    return jax.vmap(jax.random.fold_in, (None, 0))(key, slots)


def sum_rows(index: jnp.ndarray, rows: jnp.ndarray, n: int) -> jnp.ndarray:
    """Per-sphere sums ``out[j] = sum(rows[index == j])`` of ``[R,F]`` rows
    into ``[n,F]``: the transpose of :func:`gather_rows`, and how every
    per-sphere cotangent sum of the package is formed.

    One ``[R,n]^T @ [R,F]`` one-hot matrix product (f32, no TF32) rather
    than a scatter-add: on an H100 the recorded gradient step at the
    flagship runs 3x faster with it, although a lone scatter-add of the same
    size is not slower (PERF.md), and it is the closer of the two to float64
    sums."""
    onehot = (index[:, None] == jnp.arange(n, dtype=index.dtype)[None, :]
              ).astype(rows.dtype)
    return jax.lax.dot_general(onehot, rows, (((0,), (0,)), ((), ())),
                               precision=jax.lax.Precision.HIGHEST)


@jax.custom_vjp
def gather_rows(table: jnp.ndarray, index: jnp.ndarray) -> jnp.ndarray:
    """``table[index]`` for a small ``[N,F]`` table and ``[R]`` indices: a
    plain gather, whose transpose is :func:`sum_rows`."""
    return table[index]


def _gather_rows_fwd(table, index):
    return table[index], (table, index)


def _gather_rows_bwd(res, g):
    table, index = res
    return sum_rows(index, g, table.shape[0]).astype(table.dtype), None


gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)


def gather_sphere_attrs(scene: Scene, index: jnp.ndarray, dtype):
    """Fetch per-ray sphere attributes ``(center, radius, albedo, fuzz, ir, mat)``
    from the sphere SoA: one :func:`gather_rows` of the float columns
    ``center.xyz | radius | albedo.rgb | fuzz | ir`` (a 488-row table at the
    flagship, which stays in cache) and a plain gather of ``mat``."""
    table = jnp.concatenate([scene.center, scene.radius[:, None], scene.albedo,
                             scene.fuzz[:, None], scene.ir[:, None]], axis=1)
    rows = gather_rows(table, index).astype(dtype)
    return (rows[:, 0:3], rows[:, 3], rows[:, 4:7], rows[:, 7], rows[:, 8],
            scene.mat[index])


def scatter(scene: Scene, origin: jnp.ndarray, direction: jnp.ndarray,
            t: jnp.ndarray, index: jnp.ndarray, key: jax.Array,
            ray_keys: jax.Array | None = None,
            attrs: tuple | None = None) -> ScatterResult:
    """Scatter ``R`` rays that hit sphere ``index`` at parameter ``t``.

    Rays that did not hit anything receive well-defined (finite) garbage here;
    the integrator masks them out. ``t`` must already be finite for such rays.

    ``ray_keys``: optional [R] per-ray key batch; when given, randomness is
    keyed per ray (position-independent — required for exact compaction /
    persistent regeneration); when None, draws are positional (one shaped draw
    for the whole batch — cheapest). ``attrs``: optionally pre-fetched
    (center, radius, albedo, fuzz, ir, mat) rows, skipping the gather.
    """
    dtype = origin.dtype
    one = jnp.asarray(1.0, dtype)

    # Hit point and outward normal (reference: src/hit.jl:3,32-34).
    p = origin + t[..., None] * direction
    if attrs is None:
        attrs = gather_sphere_attrs(scene, index, dtype)
    center, radius, albedo, fuzz, ir, mat = attrs
    # Signed radius: negative radius flips the outward normal → hollow shells
    # (reference: src/hit.jl:33, src/scenes.jl:35-36).
    inv_r = jnp.where(radius == 0, 0.0, jnp.reciprocal(jnp.where(radius == 0, one, radius)))
    n_out = (p - center) * inv_r[..., None]
    front_face = dot(direction, n_out) < 0                  # (reference: src/hit.jl:7)
    n = jnp.where(front_face[..., None], n_out, -n_out)     # (reference: src/hit.jl:8)

    if ray_keys is None:
        k_dir, k_coin = jax.random.split(key)
        u = unit_sphere_directions(k_dir, t.shape, dtype=dtype)  # shared unit sample
        xi = jax.random.uniform(k_coin, t.shape, dtype=dtype)    # Schlick coin
    else:
        u, xi = _per_ray_draws(ray_keys, dtype)

    # --- Lambertian (reference: src/material.jl:13-23) ---
    lam_raw = n + u
    lam_degenerate = jnp.sum(lam_raw * lam_raw, axis=-1) < NEAR_ZERO_EPS
    lam_dir = jnp.where(lam_degenerate[..., None], n, normalize(lam_raw))

    # --- Metal (reference: src/material.jl:25-34; fuzz NOT clamped) ---
    refl = reflect(direction, n)
    metal_dir = normalize(refl + fuzz[..., None] * u)

    # --- Dielectric (reference: src/material.jl:41-53) ---
    eta_ratio = jnp.where(front_face, jnp.reciprocal(ir), ir)
    cos_theta = jnp.minimum(-dot(direction, n), one)
    sin_theta = safe_sqrt(one - cos_theta * cos_theta)
    cannot_refract = eta_ratio * sin_theta > one
    schlick = reflectance(cos_theta, eta_ratio)
    reflect_choice = cannot_refract | (schlick > xi)
    refr_dir = refract(direction, n, eta_ratio)
    diel_dir = jnp.where(reflect_choice[..., None], refl, refr_dir)

    # --- Masked-blend dispatch (replaces Julia dynamic dispatch, SURVEY.md §1) ---
    new_dir = jnp.where((mat == LAMBERTIAN)[..., None], lam_dir,
                        jnp.where((mat == METAL)[..., None], metal_dir, diel_dir))
    # Dielectric rows store albedo (1,1,1) (src/material.jl:42), so a single
    # attribute fetch covers all three materials.
    return ScatterResult(origin=p, direction=new_dir, attenuation=albedo)
