"""Recorded-path differentiable trace — custom VJP without remat recompute.

The remat grad path (``trace(remat=True)`` under ``jax.grad``) pays three
passes per bounce: forward, checkpoint recompute, and the XLA-transposed
backward — plus whatever residuals XLA elects to stash. This module replaces
XLA's loop transpose with a hand-rolled two-phase scheme built on the fact
that a path is fully determined by tiny per-bounce records:

1. **Record phase** (inside ``custom_vjp`` fwd, no AD): the plain wavefront
   loop — sweep + shade — additionally stores each bounce's INPUT
   state ``(origin, direction, throughput)`` and sweep result ``(t, index,
   alive)``: 12 floats per ray per bounce, ~400 MB at a 512k-ray chunk.
2. **Reverse phase** (bwd): one ``lax.scan`` over bounces in reverse. Each
   step calls ``jax.vjp`` of a LOCAL bounce function — sky accumulation +
   scatter — linearized at the recorded state, with NO sphere sweep: the hit
   distance re-enters as the closed-form root of the sphere equation at the
   recorded winning index (root chosen nearest the recorded t, selection
   detached), so cotangents flow to origins, directions, centers, and radii
   through the same implicit-differentiation math as the sweep kernel's VJP
   (ops/pallas/intersect_kernel.py) while the discrete choices
   (winner, alive transitions, Schlick coin) replay as constants.

Scatter RNG is positional and bounce-keyed (``fold_in(key, b)``), so the
reverse phase's re-draws are bit-identical to the record phase's — the
counter-based RNG design (SURVEY.md §2.5) is what makes path replay exact.

Result: backward cost ~= one forward trace + a sweep-free local-VJP sweep,
instead of ~3 forward traces. Gradient semantics match ``trace``'s
(interior/detached-discrete, reference integrator semantics of
src/ray_color.jl:14-38); equality with the remat path is tested to FD
tolerance in tests/test_grad.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..scene import Scene
from .intersect import DEFAULT_TMIN
from .integrator import _pick_intersector, skycolor, DEFAULT_MAX_DEPTH
from .materials import scatter, gather_sphere_attrs


def _float0_like(x):
    """Cotangent for a non-differentiable (int/key) primal leaf."""
    return np.zeros(np.shape(x), dtype=jax.dtypes.float0)


def _implicit_t(org, d, center, radius, t_rec, hit):
    """Differentiable hit distance: closed-form quadratic root at the
    recorded winning sphere, selecting the root nearest the recorded t
    (detached selection). Gradients match implicit differentiation of
    ``|o + t d - c|^2 = r^2``."""
    oc = org - center
    hb = jnp.sum(oc * d, axis=-1)
    cq = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = jnp.maximum(hb * hb - cq, 1e-12)  # hit lanes have disc > 0
    sq = jnp.sqrt(disc)
    r1 = -hb - sq
    r2 = -hb + sq
    use_near = jnp.abs(jax.lax.stop_gradient(r1) - t_rec) <= \
        jnp.abs(jax.lax.stop_gradient(r2) - t_rec)
    t = jnp.where(use_near, r1, r2)
    return jnp.where(hit, t, 1.0)


def _bounce_local(scene: Scene, org, d, thr, t_rec, idx, alive, hit, key_b,
                  tmin, implicit_t: bool):
    """One bounce as a local differentiable function of (scene, org, d, thr)
    with the sweep's discrete outputs (idx, hit, alive) as constants.
    Returns (org', d', thr', rad_increment).

    ``implicit_t=False`` (record phase): use the sweep's t verbatim — the
    primal trajectory is then bit-compatible with ``trace``'s (recomputing t
    with different float32 expansions shifts hit points by the ground
    sphere's ~1e6-scale cancellation error, enough to cause acne-style path
    divergence). ``implicit_t=True`` (backward): re-derive t from the sphere
    equation so cotangents flow to origins/directions/centers/radii; the
    VALUE still matches the recorded t to float error, it is only the
    linearization that needs the closed form."""
    dtype = org.dtype
    attrs = gather_sphere_attrs(scene, idx, dtype)
    center, radius = attrs[0], attrs[1]

    miss_now = alive & ~hit
    rad_inc = jnp.where(miss_now[..., None], thr * skycolor(d), 0.0)

    if implicit_t:
        t_safe = _implicit_t(org, d, center, radius, t_rec, hit)
    else:
        t_safe = t_rec
    s = scatter(scene, org, d, t_safe, idx, key_b, attrs=attrs)

    live_hit = (alive & hit)[..., None]
    org2 = jnp.where(live_hit, s.origin, org)
    d2 = jnp.where(live_hit, s.direction, d)
    thr2 = jnp.where(live_hit, thr * s.attenuation, thr)
    return org2, d2, thr2, rad_inc


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def trace_recorded(scene: Scene, origin: jnp.ndarray, direction: jnp.ndarray,
                   key: jax.Array, max_depth: int = DEFAULT_MAX_DEPTH,
                   tmin: float = DEFAULT_TMIN,
                   use_pallas: bool | None = None) -> jnp.ndarray:
    """Differentiable radiance ``[R,3]`` — drop-in for ``trace`` under grad."""
    radiance, _ = _record_forward(scene, origin, direction, key, max_depth,
                                  tmin, use_pallas)
    return radiance


@partial(jax.jit, static_argnames=("max_depth", "tmin", "use_pallas"))
def _record_forward(scene, origin, direction, key, max_depth, tmin,
                    use_pallas):
    dtype = origin.dtype
    R = origin.shape[0]
    intersect = _pick_intersector(use_pallas)

    def body(b, state):
        org, d, thr, rad, alive, rec = state
        res, _ = intersect(org, d, scene, tmin)
        hit = res.hit
        t_rec = jnp.where(hit, res.t, jnp.asarray(1.0, dtype))
        # Record this bounce's INPUT state + sweep outcome.
        rec_o, rec_d, rec_t, rec_th, rec_i, rec_a, rec_h = rec
        rec = (rec_o.at[b].set(org), rec_d.at[b].set(d),
               rec_t.at[b].set(t_rec), rec_th.at[b].set(thr),
               rec_i.at[b].set(res.index), rec_a.at[b].set(alive),
               rec_h.at[b].set(hit))

        key_b = jax.random.fold_in(key, b)
        org, d, thr, rad_inc = _bounce_local(scene, org, d, thr, t_rec,
                                             res.index, alive, hit, key_b,
                                             tmin, implicit_t=False)
        return org, d, thr, rad + rad_inc, alive & hit, rec

    rec0 = (jnp.zeros((max_depth, R, 3), dtype),
            jnp.zeros((max_depth, R, 3), dtype),
            jnp.ones((max_depth, R), dtype),
            jnp.ones((max_depth, R, 3), dtype),
            jnp.zeros((max_depth, R), jnp.int32),
            jnp.zeros((max_depth, R), bool),
            jnp.zeros((max_depth, R), bool))
    init = (origin, direction, jnp.ones((R, 3), dtype),
            jnp.zeros((R, 3), dtype), jnp.ones((R,), bool), rec0)
    _, _, _, radiance, _, rec = jax.lax.fori_loop(0, max_depth, body, init)
    return radiance, rec


def _trace_recorded_fwd(scene, origin, direction, key, max_depth, tmin,
                        use_pallas):
    radiance, rec = _record_forward(scene, origin, direction, key, max_depth,
                                    tmin, use_pallas)
    return radiance, (scene, key, rec)


def _trace_recorded_bwd(max_depth, tmin, use_pallas, residuals, g_rad):
    scene, key, rec = residuals
    rec_o, rec_d, rec_t, rec_th, rec_i, rec_a, rec_h = rec
    # Accumulate float fields only inside the scan (integer leaves keep int
    # zeros as carry placeholders; they are converted to float0 cotangents at
    # the end, as custom_vjp requires).
    zero_scene = jax.tree.map(jnp.zeros_like, scene)

    bounces = jnp.arange(max_depth - 1, -1, -1)

    def back(carry, b):
        g_org, g_d, g_thr, g_scene = carry
        key_b = jax.random.fold_in(key, b)

        def local(scene_, org_, d_, thr_):
            return _bounce_local(scene_, org_, d_, thr_, rec_t[b], rec_i[b],
                                 rec_a[b], rec_h[b], key_b, tmin,
                                 implicit_t=True)

        _, vjp_fn = jax.vjp(local, scene, rec_o[b], rec_d[b], rec_th[b])
        gs, go, gd, gt = vjp_fn((g_org, g_d, g_thr, g_rad))
        g_scene = jax.tree.map(
            lambda a, c: a + c if jnp.issubdtype(a.dtype, jnp.floating)
            else a, g_scene, gs)
        return (go, gd, gt, g_scene), None

    R = rec_o.shape[1]
    dtype = rec_o.dtype
    init = (jnp.zeros((R, 3), dtype), jnp.zeros((R, 3), dtype),
            jnp.zeros((R, 3), dtype), zero_scene)
    (g_org0, g_d0, _, g_scene), _ = jax.lax.scan(back, init, bounces)
    g_scene = jax.tree.map(
        lambda a: a if jnp.issubdtype(a.dtype, jnp.floating)
        else _float0_like(a), g_scene)
    return g_scene, g_org0, g_d0, _float0_like(key)


trace_recorded.defvjp(_trace_recorded_fwd, _trace_recorded_bwd)


# ---------------------------------------------------------------------------
# Staged recorded trace: compacted tail bounces
# ---------------------------------------------------------------------------
#
# Flagship occupancy (trace_occupancy, t_cam1): alive fractions per bounce are
# [1.0, .84, .37, .22, .14, ...] — mean path length 3.15 of 16, so a
# full-width fixed-depth record phase wastes ~5x of its sweeps on dead lanes.
# The staged variant records bounces [0, B) at full width R, then compacts the
# survivors (one argsort + gathers — NOT the 14-operand sort that made
# per-bounce compaction a wash) and records bounces [B, max_depth) at a
# STATIC reduced width R2. The reverse scan mirrors the two widths, so both
# record AND reverse work drop by ~(B + (16-B)*R2/R)/16.
#
# CONTRACT: lanes alive at bounce B beyond the R2 budget are dropped (their
# tail contributes black — equivalent to a per-lane depth limit of B). The
# alive count at B is returned so callers can police the budget; with
# B=4, R2=R/4 the flagship has ~1.8x headroom (alive(4)=0.14). This is an
# OPT-IN fast path (grad_bench / perf-aware callers), not the default.

def _bounce_record_body(scene, intersect, key, tmin, dtype):
    """Shared record-phase bounce: sweep, record, advance. Returns a fori
    body over state (org, d, thr, rad, alive, rec)."""

    def body(b, state):
        org, d, thr, rad, alive, rec = state
        res, _ = intersect(org, d, scene, tmin)
        hit = res.hit
        t_rec = jnp.where(hit, res.t, jnp.asarray(1.0, dtype))
        rec_o, rec_d, rec_t, rec_th, rec_i, rec_a, rec_h, b0 = rec
        j = b - b0
        rec = (rec_o.at[j].set(org), rec_d.at[j].set(d),
               rec_t.at[j].set(t_rec), rec_th.at[j].set(thr),
               rec_i.at[j].set(res.index), rec_a.at[j].set(alive),
               rec_h.at[j].set(hit), b0)
        key_b = jax.random.fold_in(key, b)
        org, d, thr, rad_inc = _bounce_local(scene, org, d, thr, t_rec,
                                             res.index, alive, hit, key_b,
                                             tmin, implicit_t=False)
        return org, d, thr, rad + rad_inc, alive & hit, rec

    return body


def _empty_rec(n, R, dtype, b0):
    return (jnp.zeros((n, R, 3), dtype), jnp.zeros((n, R, 3), dtype),
            jnp.ones((n, R), dtype), jnp.ones((n, R, 3), dtype),
            jnp.zeros((n, R), jnp.int32), jnp.zeros((n, R), bool),
            jnp.zeros((n, R), bool), b0)


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8))
def trace_recorded_staged(scene: Scene, origin, direction, key,
                          max_depth: int = DEFAULT_MAX_DEPTH,
                          tmin: float = DEFAULT_TMIN,
                          use_pallas: bool | None = None,
                          stage_bounce: int = 4,
                          stage_width: int = 0):
    """(radiance [R,3], alive_count_at_stage) — staged recorded trace.

    ``stage_width`` is the STATIC tail width R2 (0 => R//4). The second
    output is the number of lanes alive entering the tail stage; if it
    exceeds ``stage_width`` the overflow lanes' tails were truncated (see
    module contract note)."""
    out, _ = _record_forward_staged(scene, origin, direction, key, max_depth,
                                    tmin, use_pallas, stage_bounce,
                                    stage_width)
    return out


@partial(jax.jit, static_argnames=("max_depth", "tmin", "use_pallas",
                                   "B", "R2"))
def _record_forward_staged(scene, origin, direction, key, max_depth, tmin,
                           use_pallas, B, R2):
    dtype = origin.dtype
    R = origin.shape[0]
    R2 = R2 or R // 4
    if not 1 <= R2 <= R:
        raise ValueError(
            f"stage_width={R2} must be in [1, R={R}] (0 selects R//4; "
            f"R < 4 makes that default degenerate — pass it explicitly)")
    B = min(B, max_depth)
    intersect = _pick_intersector(use_pallas)
    body = _bounce_record_body(scene, intersect, key, tmin, dtype)

    init = (origin, direction, jnp.ones((R, 3), dtype),
            jnp.zeros((R, 3), dtype), jnp.ones((R,), bool),
            _empty_rec(B, R, dtype, 0))
    org, d, thr, rad, alive, rec1 = jax.lax.fori_loop(0, B, body, init)
    alive_count = jnp.sum(alive.astype(jnp.int32))

    if B == max_depth:
        sel = jnp.zeros((R2,), jnp.int32)
        rec2 = _empty_rec(0, R2, dtype, B)
        return (rad, alive_count), (scene, key, rec1, rec2, sel)

    # Compact: alive lanes first (stable), take the static-width prefix.
    order = jnp.argsort(~alive, stable=True)
    sel = order[:R2].astype(jnp.int32)
    init2 = (org[sel], d[sel], thr[sel], jnp.zeros((R2, 3), dtype),
             alive[sel], _empty_rec(max_depth - B, R2, dtype, B))
    _, _, _, rad2, _, rec2 = jax.lax.fori_loop(B, max_depth, body, init2)
    rad = rad.at[sel].add(rad2)
    return (rad, alive_count), (scene, key, rec1, rec2, sel)


def _staged_fwd(scene, origin, direction, key, max_depth, tmin, use_pallas,
                stage_bounce, stage_width):
    out, res = _record_forward_staged(scene, origin, direction, key, max_depth,
                                      tmin, use_pallas, stage_bounce,
                                      stage_width)
    return out, res


def _reverse_scan(scene, key, rec, tmin, g_org, g_d, g_thr, g_rad, g_scene):
    """Reversed per-bounce local-VJP scan over one record block."""
    rec_o, rec_d, rec_t, rec_th, rec_i, rec_a, rec_h, b0 = rec
    n = rec_o.shape[0]
    if n == 0:
        return g_org, g_d, g_thr, g_scene
    bounces = jnp.arange(n - 1, -1, -1)

    def back(carry, j):
        g_org, g_d, g_thr, g_scene = carry
        key_b = jax.random.fold_in(key, b0 + j)

        def local(scene_, org_, d_, thr_):
            return _bounce_local(scene_, org_, d_, thr_, rec_t[j], rec_i[j],
                                 rec_a[j], rec_h[j], key_b, tmin,
                                 implicit_t=True)

        _, vjp_fn = jax.vjp(local, scene, rec_o[j], rec_d[j], rec_th[j])
        gs, go, gd, gt = vjp_fn((g_org, g_d, g_thr, g_rad))
        g_scene = jax.tree.map(
            lambda a, c: a + c if jnp.issubdtype(a.dtype, jnp.floating)
            else a, g_scene, gs)
        return (go, gd, gt, g_scene), None

    (g_org, g_d, g_thr, g_scene), _ = jax.lax.scan(
        back, (g_org, g_d, g_thr, g_scene), bounces)
    return g_org, g_d, g_thr, g_scene


def _staged_bwd(max_depth, tmin, use_pallas, stage_bounce, stage_width,
                residuals, cotangents):
    scene, key, rec1, rec2, sel = residuals
    g_rad, _g_count = cotangents
    R = rec1[0].shape[1]
    R2 = sel.shape[0]
    dtype = rec1[0].dtype
    zero_scene = jax.tree.map(jnp.zeros_like, scene)

    # Tail stage first (reduced width; its rad was scatter-added at sel, so
    # its radiance cotangent is the gather g_rad[sel]).
    z2 = jnp.zeros((R2, 3), dtype)
    g_org2, g_d2, g_thr2, g_scene = _reverse_scan(
        scene, key, rec2, tmin, z2, z2, z2, g_rad[sel], zero_scene)

    # Scatter the tail's state cotangents back to full width, then reverse
    # the head stage.
    zR = jnp.zeros((R, 3), dtype)
    g_org = zR.at[sel].set(g_org2)
    g_d = zR.at[sel].set(g_d2)
    g_thr = zR.at[sel].set(g_thr2)
    g_org, g_d, g_thr, g_scene = _reverse_scan(
        scene, key, rec1, tmin, g_org, g_d, g_thr, g_rad, g_scene)

    g_scene = jax.tree.map(
        lambda a: a if jnp.issubdtype(a.dtype, jnp.floating)
        else _float0_like(a), g_scene)
    return g_scene, g_org, g_d, _float0_like(key)


trace_recorded_staged.defvjp(_staged_fwd, _staged_bwd)
