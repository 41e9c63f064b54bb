"""Closest-hit ray-sphere sweep as a Pallas kernel for NVIDIA Hopper
(``backend="triton"``).

The XLA path (ops/intersect.py) writes the sweep as two ``[R,3] @ [3,N]``
contractions plus ``[R,N]`` elementwise root selection and a min/argmin over
the sphere axis. At the flagship size (2.07 M rays x 488 spheres) each of
those ``[R,N]`` f32 planes is about 4 GB of device memory traffic per bounce,
for work that is pure f32 ALU reduced to one ``(t, index)`` per ray.

This kernel keeps everything in registers. A program owns a power-of-two
block of rays and holds their origin, direction and running ``(t, index)``;
a ``fori_loop`` walks the sphere table (``cx, cy, cz, |c|^2 - r^2``, about
8 KB at the flagship, so it stays in L1) a few spheres per iteration, each
read as a scalar that all threads share, computes every ray's candidate
root with the same half-b quadratic as the XLA path, and merges it into the
running pair with a strict ``<`` in ascending sphere order —
``jnp.argmin``'s lowest-index tie rule. Each ray's reduction stays in its
own thread, so there is no cross-lane argmin. Rays are padded to the block;
spheres are padded to the unroll factor with entries whose ``|c|^2 - r^2``
is ``BIG``, which can never produce a positive discriminant. Arithmetic is
f32 throughout (no TF32: there is no matrix product). It rounds like XLA's
elementwise form of the same expressions, not like the cuBLAS products of
the plain path, so the two differ in the last bits (PERF.md).

Differentiability: ``jax.custom_vjp`` whose backward pass is *implicit
differentiation* of ``|o + t d - c|^2 = r^2`` at the winning sphere (plain
JAX, O(R), no sphere sweep):

    dt/do = -p/(p.d),  dt/dd = -t p/(p.d),  dt/dc = p/(p.d),  dt/dr = r/(p.d)

with ``p = o + t d - c``; scene cotangents are summed per winning sphere
by :func:`ops.materials.sum_rows`, and the argmin choice is detached, as in
the XLA path.

``interpret=True`` runs the kernel in the Pallas interpreter — the only way
it runs without a card, and only ever an explicit argument (tests).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...scene import Scene
from ..intersect import HitResult, DEFAULT_TMIN, BIG
from ..materials import sum_rows

#: Rays per program (power of two), warps per program, and spheres per
#: iteration of the sphere loop (the table is padded to a multiple of it).
#: Chosen on an H100 at the flagship width, where they beat a
#: [rays, chunk] tile with an in-tile argmin (PERF.md).
BLOCK_RAYS = 256
NUM_WARPS = 4
UNROLL = 4


def _sweep_kernel(cx_ref, cy_ref, cz_ref, ck_ref,
                  ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                  t_ref, idx_ref, *, n_spheres: int, unroll: int,
                  tmin: float):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    big = jnp.float32(BIG)

    def one(s, best_t, best_i):
        # Scalar loads: every thread reads the same sphere (an L1 broadcast).
        cx, cy, cz, ck = cx_ref[s], cy_ref[s], cz_ref[s], ck_ref[s]
        # Half-b quadratic with a == 1 and the stable |oc|^2 expansion,
        # term for term as ops/intersect.py (reference: src/hit.jl:12-29).
        hb = od - (dx * cx + dy * cy + dz * cz)
        c = oo - 2.0 * (ox * cx + oy * cy + oz * cz) + ck
        disc = hb * hb - c
        valid = disc > 0
        sq = jnp.sqrt(jnp.where(valid, disc, 1.0))
        near = -hb - sq
        far = -hb + sq
        near_ok = valid & (near >= tmin) & (near <= big)
        far_ok = valid & (far >= tmin) & (far <= big)
        t = jnp.where(near_ok, near, jnp.where(far_ok, far, big))
        # Strict < in ascending sphere order: jnp.argmin's lowest-index
        # tie rule (reference: the shrinking-closest scan, src/hit.jl:38-50).
        better = t < best_t
        return jnp.where(better, t, best_t), jnp.where(better, s, best_i)

    def body(j, carry):
        best_t, best_i = carry
        for k in range(unroll):
            best_t, best_i = one(j * unroll + k, best_t, best_i)
        return best_t, best_i

    init = (jnp.full(ox.shape, big, jnp.float32),
            jnp.zeros(ox.shape, jnp.int32))
    best_t, best_i = jax.lax.fori_loop(0, n_spheres // unroll, body, init)
    t_ref[...] = best_t
    idx_ref[...] = best_i


def sphere_table(centers: jnp.ndarray, ck: jnp.ndarray, multiple: int = UNROLL):
    """Sphere planes ``(cx, cy, cz, ck)`` padded to a multiple of
    ``multiple``. Padding entries have ``ck = BIG``: ``c = |o|^2 - 2 o.c +
    BIG`` makes the discriminant hugely negative, so they never win."""
    n = centers.shape[0]
    n_pad = -(-n // multiple) * multiple - n
    planes = [centers[:, 0], centers[:, 1], centers[:, 2]]
    planes = [jnp.pad(p.astype(jnp.float32), (0, n_pad)) for p in planes]
    planes.append(jnp.pad(ck.astype(jnp.float32), (0, n_pad),
                          constant_values=BIG))
    return planes


@partial(jax.jit, static_argnames=("tmin", "interpret", "block", "num_warps",
                                   "unroll"))
def sweep_forward(origin, direction, centers, ck, tmin, interpret=False,
                  block=BLOCK_RAYS, num_warps=NUM_WARPS, unroll=UNROLL):
    """``(t, index)`` of the closest hit for float32 ``[R,3]`` rays; no VJP.
    ``block`` must be a power of two."""
    R = origin.shape[0]
    r_pad = -(-R // block) * block - R
    rays = [jnp.pad(x, (0, r_pad)) for x in
            (origin[:, 0], origin[:, 1], origin[:, 2],
             direction[:, 0], direction[:, 1], direction[:, 2])]
    spheres = sphere_table(centers, ck, unroll)
    n_spheres = spheres[0].shape[0]
    rp = R + r_pad

    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    sph_spec = pl.BlockSpec((n_spheres,), lambda i: (0,))
    t, idx = pl.pallas_call(
        partial(_sweep_kernel, n_spheres=n_spheres, unroll=unroll, tmin=tmin),
        grid=(rp // block,),
        in_specs=[sph_spec] * 4 + [ray_spec] * 6,
        out_specs=[ray_spec, ray_spec],
        out_shape=[jax.ShapeDtypeStruct((rp,), jnp.float32),
                   jax.ShapeDtypeStruct((rp,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="sphere_sweep",
    )(*spheres, *rays)
    return t[:R], idx[:R]


@partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _sweep(origin, direction, scene_params, tmin, interpret):
    centers, radius = scene_params
    ck = jnp.sum(centers * centers, axis=-1) - radius * radius
    return sweep_forward(origin, direction, centers, ck, tmin, interpret)


def _sweep_fwd(origin, direction, scene_params, tmin, interpret):
    t, idx = _sweep(origin, direction, scene_params, tmin, interpret)
    return (t, idx), (origin, direction, scene_params, t, idx)


def _sweep_bwd(tmin, interpret, residuals, cotangents):
    origin, direction, (centers, radius), t, idx = residuals
    g_t, _ = cotangents  # idx is integer — no cotangent

    hit = t < BIG
    t_safe = jnp.where(hit, t, 0.0)
    c_sel = centers[idx]
    r_sel = radius[idx]
    p = origin + t_safe[:, None] * direction - c_sel     # surface offset vector
    pd = jnp.sum(p * direction, axis=-1)
    # Guard tangential hits (p.d == 0) and masked lanes.
    ok = hit & (jnp.abs(pd) > 1e-12)
    scale = jnp.where(ok, g_t / jnp.where(ok, pd, 1.0), 0.0)

    d_origin = -scale[:, None] * p
    d_direction = -(scale * t_safe)[:, None] * p
    d_sph = sum_rows(idx, jnp.concatenate(
        [scale[:, None] * p, (scale * r_sel)[:, None]], axis=1),
        centers.shape[0])
    return d_origin, d_direction, (d_sph[:, :3].astype(centers.dtype),
                                   d_sph[:, 3].astype(radius.dtype))


_sweep.defvjp(_sweep_fwd, _sweep_bwd)


def intersect_spheres_pallas(origin: jnp.ndarray, direction: jnp.ndarray,
                             scene: Scene, tmin: float = DEFAULT_TMIN,
                             interpret: bool = False) -> HitResult:
    """Drop-in replacement for :func:`ops.intersect.intersect_spheres` backed
    by the sweep kernel (float32 only)."""
    t, idx = _sweep(origin, direction, (scene.center, scene.radius), tmin,
                    interpret)
    return HitResult(t=t, index=idx, hit=t < BIG)
