"""SoA scene representation — the differentiable parameter pytree.

The reference stores the scene as an AoS ``Vector{Hittable}`` of boxed spheres
with per-object material objects and dynamic dispatch
(reference: src/structs.jl:10,31-35). Here the scene is a structure-of-arrays
pytree: dense, statically shaped, replicated per chip, and directly usable as
the differentiable ``params`` of an inverse-rendering step.

Material dispatch (reference: dynamic multiple dispatch on ``Material`` subtypes,
src/material.jl) becomes an integer code array + masked blend in the integrator.

Signed-radius semantics are preserved: a negative radius flips the outward
normal ``(p - center)/radius`` and therefore ``front_face`` — the reference's
hollow-glass trick (reference: src/hit.jl:33, src/scenes.jl:35-36).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# Material codes (replaces reference's Material type hierarchy, src/structs.jl:13).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

#: Pad sphere count to a multiple of this so scenes of similar size share
#: one compiled program (``trim_scene`` drops the padding for a single render).
SPHERE_PAD = 128


class Scene(NamedTuple):
    """Dense sphere-scene pytree. All arrays share the leading axis ``N``.

    Padding entries have ``radius == 0`` and ``mat == LAMBERTIAN``; a zero
    radius can never produce a valid hit because the discriminant
    ``half_b^2 - (|oc|^2 - r^2)`` then requires the ray origin to sit exactly on
    the (degenerate) sphere — and padding centers are placed far away.
    """

    center: jnp.ndarray  # [N, 3] sphere centers (differentiable)
    radius: jnp.ndarray  # [N] signed radii (differentiable; <0 = hollow shell)
    albedo: jnp.ndarray  # [N, 3] (differentiable; dielectrics store (1,1,1), src/material.jl:42)
    fuzz: jnp.ndarray    # [N] metal fuzz (NOT clamped to 1 — ref allows [0,5], src/scenes.jl:70)
    ir: jnp.ndarray      # [N] index of refraction for dielectrics
    mat: jnp.ndarray     # [N] int32 material codes

    @property
    def n_spheres(self) -> int:
        return self.center.shape[0]


#: Padding spheres sit at this distance so even their |center|^2 stays well
#: inside float32 exact-integer range.
_PAD_DISTANCE = 1e4


def trim_scene(scene: Scene, multiple: int = 8) -> Scene:
    """Drop trailing zero-radius padding spheres (bitwise-safe: a padding
    sphere's discriminant is always negative, so removing it changes no hit,
    no RNG draw, and no radiance bit). Keeps ``N`` a multiple of ``multiple``
    for the sweep kernels' unrolled loops.

    Only usable with CONCRETE scenes (returns the input unchanged when any
    leaf is a tracer — e.g. under ``jax.grad``, where the gradient pytree
    must keep the caller's shapes). Forward drivers call this so a 2-sphere
    scene does not pay a 128-sphere sweep (SPHERE_PAD) per bounce.
    """
    import jax
    if any(isinstance(leaf, jax.core.Tracer) for leaf in scene):
        return scene
    r = np.asarray(scene.radius)
    nz = np.flatnonzero(r != 0)
    n = int(nz[-1]) + 1 if nz.size else 1
    n = min(scene.n_spheres, max(multiple, -(-n // multiple) * multiple))
    if n == scene.n_spheres:
        return scene
    return Scene(center=scene.center[:n], radius=scene.radius[:n],
                 albedo=scene.albedo[:n], fuzz=scene.fuzz[:n],
                 ir=scene.ir[:n], mat=scene.mat[:n])


def make_scene(spheres: list[dict], dtype=jnp.float32, pad_to: int | None = SPHERE_PAD) -> Scene:
    """Build a padded SoA :class:`Scene` from a list of sphere dicts.

    Each dict has keys ``center`` (3-seq), ``radius``, ``mat`` and the
    material-specific fields ``albedo`` (lambertian/metal), ``fuzz`` (metal),
    ``ir`` (dielectric).
    """
    n = len(spheres)
    n_pad = n
    if pad_to:
        n_pad = max(pad_to, -(-n // pad_to) * pad_to)

    center = np.full((n_pad, 3), _PAD_DISTANCE, dtype=np.float64)
    radius = np.zeros((n_pad,), dtype=np.float64)
    albedo = np.ones((n_pad, 3), dtype=np.float64)
    fuzz = np.zeros((n_pad,), dtype=np.float64)
    ir = np.ones((n_pad,), dtype=np.float64)
    mat = np.zeros((n_pad,), dtype=np.int32)

    for i, s in enumerate(spheres):
        center[i] = np.asarray(s["center"], dtype=np.float64)
        radius[i] = s["radius"]
        mat[i] = s["mat"]
        if s["mat"] == DIELECTRIC:
            albedo[i] = (1.0, 1.0, 1.0)  # exact reference semantics, src/material.jl:42
            ir[i] = s["ir"]
        else:
            albedo[i] = np.asarray(s["albedo"], dtype=np.float64)
            if s["mat"] == METAL:
                fuzz[i] = s.get("fuzz", 0.0)

    return Scene(
        center=jnp.asarray(center, dtype=dtype),
        radius=jnp.asarray(radius, dtype=dtype),
        albedo=jnp.asarray(albedo, dtype=dtype),
        fuzz=jnp.asarray(fuzz, dtype=dtype),
        ir=jnp.asarray(ir, dtype=dtype),
        mat=jnp.asarray(mat),
    )


def sphere(center, radius, mat, albedo=(1.0, 1.0, 1.0), fuzz=0.0, ir=1.0) -> dict:
    """Convenience constructor mirroring the reference's ``Sphere(center, r, material)``."""
    return dict(center=tuple(center), radius=float(radius), mat=int(mat),
                albedo=tuple(albedo), fuzz=float(fuzz), ir=float(ir))


def lambertian(center, radius, albedo) -> dict:
    """Reference: ``Sphere(c, r, Lambertian(albedo))`` (src/material.jl:3-5)."""
    return sphere(center, radius, LAMBERTIAN, albedo=albedo)


def metal(center, radius, albedo, fuzz=0.0) -> dict:
    """Reference: ``Sphere(c, r, Metal(albedo, fuzz))`` (src/material.jl:25-29)."""
    return sphere(center, radius, METAL, albedo=albedo, fuzz=fuzz)


def dielectric(center, radius, ir) -> dict:
    """Reference: ``Sphere(c, r, Dielectric(ir))`` (src/material.jl:37-39)."""
    return sphere(center, radius, DIELECTRIC, ir=ir)
