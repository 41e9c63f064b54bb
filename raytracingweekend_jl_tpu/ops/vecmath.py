"""Vector math on stacked ``[..., 3]`` arrays — the array counterpart of the
reference's ``Vec3`` layer (reference: src/vec.jl:1-22, src/light.jl:1-25).

The reference operates on one ``SVector{3,T}`` at a time; here the unit of work
is a *batch* of vectors laid out as ``[..., 3]`` (or fully SoA as three planes),
so every helper here is shape-polymorphic over leading batch dims and safe under
``jit`` / ``vmap`` / ``grad``.
"""

from __future__ import annotations

import jax.numpy as jnp

# Reference thresholds (src/vec.jl:20, src/ray_color.jl:19).
NEAR_ZERO_EPS = 1e-5
#: Guard used inside rsqrt-based normalisation so grads never see 0/0.
_SAFE_EPS = 1e-20


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis (reference: v ⋅ v, src/vec.jl:19)."""
    return jnp.sum(a * b, axis=-1)


def squared_length(v: jnp.ndarray) -> jnp.ndarray:
    """``|v|^2`` (reference: squared_length, src/vec.jl:19)."""
    return dot(v, v)


def near_zero(v: jnp.ndarray) -> jnp.ndarray:
    """True where ``|v|^2 < 1e-5`` (reference: near_zero, src/vec.jl:20)."""
    return squared_length(v) < NEAR_ZERO_EPS


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Unit-normalise over the trailing axis.

    Uses an epsilon-guarded rsqrt so that masked-out lanes holding degenerate
    vectors cannot poison gradients with NaN (a JAX ``where`` pitfall the
    reference never faces because it branches dynamically).
    """
    sq = squared_length(v)
    inv = jnp.where(sq > 0, jnp.reciprocal(jnp.sqrt(jnp.maximum(sq, _SAFE_EPS))), 0.0)
    return v * inv[..., None].astype(v.dtype)


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt that is 0 with a *zero* gradient for x <= 0.

    ``sqrt`` has an infinite derivative at 0; under masked (``where``) control
    flow that manifests as ``0 * inf = NaN`` in reverse mode even for lanes the
    forward pass never uses. Every sqrt fed by a clamped/discriminant quantity
    must go through this.
    """
    pos = x > 0
    return jnp.sqrt(jnp.where(pos, x, 1.0)) * pos


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of ``v`` about unit normal ``n`` (reference: src/light.jl:6)."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(d: jnp.ndarray, n: jnp.ndarray, eta_ratio: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction, returning a *unit* direction (reference: src/light.jl:12-17).

    ``eta_ratio`` is eta_incident / eta_transmitted, broadcast over the batch.
    Matches the reference exactly: cos-theta clamped to 1, ``sqrt(abs(...))``
    for the parallel component, and a final normalise.
    """
    one = jnp.asarray(1.0, d.dtype)
    cos_theta = jnp.minimum(-dot(d, n), one)
    r_perp = eta_ratio[..., None] * (d + cos_theta[..., None] * n)
    r_par = -safe_sqrt(jnp.abs(one - squared_length(r_perp)))[..., None] * n
    return normalize(r_perp + r_par)


def reflectance(cos_theta: jnp.ndarray, eta_ratio: jnp.ndarray) -> jnp.ndarray:
    """Schlick's reflectance approximation (reference: src/light.jl:19-25)."""
    r0 = (1.0 - eta_ratio) / (1.0 + eta_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5


def gamma2_encode(linear: jnp.ndarray) -> jnp.ndarray:
    """Gamma-2 encode = sqrt (reference: rgb_gamma2, src/vec.jl:22)."""
    return jnp.sqrt(jnp.maximum(linear, 0.0))


def color_vec3_in_rgb(v: jnp.ndarray) -> jnp.ndarray:
    """Debug visualisation of a vector field as RGB: ``0.5*normalize(v)+0.5``
    (reference: color_vec3_in_rgb, src/ray_color.jl:8 — used to render
    normals / hit points as colors while debugging integrators)."""
    return 0.5 * normalize(v) + 0.5
