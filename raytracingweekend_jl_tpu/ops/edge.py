"""Boundary-aware gradients — silhouette/visibility terms for geometry.

The interior (reparameterized) path derivative that `grad.py` computes is
provably blind to visibility discontinuities: the closest-hit argmin
(reference root selection: src/hit.jl:23-29) makes radiance a *piecewise*
function of sphere centers/radii, and the pieces' boundaries — silhouettes —
carry the dominant gradient for geometry fitting (measured: FD ~200x larger
and differently signed than interior AD at silhouettes, optimize.py).

This module supplies the missing boundary term with a **straight-through
finite-width edge blend** (the "finite-width edge term around the detached
argmin" family; cousins: SoftRas-style coverage relaxations and the
boundary-integral estimators of differentiable ray tracing — PAPERS.md):

1. Per ray and bounce, a signed *silhouette coordinate* per sphere:
   ``s_j = disc_j / (2 |r_j|)`` — to first order the distance (scene units)
   of the ray line from sphere j's silhouette (disc = r^2 - m^2 with m the
   ray-center miss distance, so near the edge ``disc ≈ 2 r (r - m)``).
   ``s_j > 0`` inside the silhouette cone, ``< 0`` outside, ``= 0`` exactly
   at the grazing ray. Differentiable w.r.t. center_j and radius_j.
2. One **edge sphere** e per ray: the *relevant* sphere (in front of the
   closest hit, i.e. capable of changing visibility) whose silhouette the
   ray passes nearest.
3. Two complete path hypotheses, continued to full depth with common
   random numbers:
   ``L_with``   — the ray interacts with e at this bounce (the real path
                  when e is the winner; a forced graze otherwise);
   ``L_without``— sphere e is deleted at this bounce (the real path when
                  e is NOT the winner).
   By construction the hard bounce is ``select(winner==e, with, without)``.
4. A *zero-in-primal* correction per edge bounce:

       L += (w - stop_grad(w)) * (L_with - L_without),
       w = smoothstep(s_e / sigma)        (COMPACT support — see below)

   The primal stays the hard render; the gradient gains
   ``w'(s_e/sigma)/sigma * ds_e/dθ * (L_with - L_without)`` — a
   band-smeared estimate of the silhouette boundary integral, correct in
   sign and O(sigma)-biased in magnitude. Handles sphere-vs-sky AND
   sphere-vs-sphere (occlusion) boundaries; applied at the first
   ``edge_bounces`` bounces it also captures *secondary* visibility
   (contact shadows / reflected silhouettes), which measured as the
   dominant term for spheres resting on the ground scene.

Weight function: a smoothstep with support exactly [-sigma, sigma], NOT a
sigmoid — with infinite tails every deep-interior ray (s ~ r/2 >> sigma)
leaks a tiny same-signed ``w' * ds/dc * (sphere - background)`` flux; for
x/y motion the tails cancel by disc antisymmetry, but for z motion
(apparent size) ``ds/dc`` has one sign over the whole disc and the summed
tail measured a spurious -2.0 z-gradient vs FD +0.33 on a floating-sphere
probe. Compact support kills the tail exactly.

Cost: ~(1 + 2*edge_bounces) trace-equivalents per sample. This is the
geometry-fitting gradient path (optimize.fit_scene geom="edge"); the
appearance-only production paths (persist/fused kernel pairs) are
unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..scene import Scene
from .integrator import skycolor, DEFAULT_MAX_DEPTH
from .intersect import DEFAULT_TMIN, BIG, HitResult, intersect_spheres
from .materials import scatter, slot_keys


def silhouette_coords(origin: jnp.ndarray, direction: jnp.ndarray,
                      scene: Scene, tmin: float = DEFAULT_TMIN,
                      tmax: float = BIG):
    """Per-(ray, sphere) silhouette geometry for the edge blend.

    Returns ``(res, s, t_int, rooted)``:
      res:   the hard closest-hit result (same math as intersect_spheres —
             recomputed here so winner/t/s are mutually consistent).
      s:     [R,N] signed silhouette coordinate ``disc/(2|r|)`` (scene
             units); padding spheres (r == 0) get -1e9 (never an edge).
      t_int: [R,N] the interaction parameter of the (possibly hypothetical)
             interaction with each sphere: the reference's root selection
             where a real in-range root exists (src/hit.jl:23-29), else the
             UNclipped perpendicular-foot parameter ``-half_b`` — the
             continuous extension of the hit across the silhouette. A
             sphere wholly behind the ray keeps its negative foot so
             relevance tests reject it (clipping it to tmin made the
             without-branch hallucinate hits at t=tmin for every sphere
             the ray's LINE crosses behind the origin — e.g. the ground
             sphere for sky rays).
      rooted: [R,N] bool — a REAL in-range root exists (the hard-candidate
             mask; ``t_cand = where(rooted, t_int, big)`` reproduces
             intersect_spheres exactly).
    """
    dtype = origin.dtype
    big = jnp.asarray(tmax, dtype)

    centers = scene.center.astype(dtype)                       # [N,3]
    radius = scene.radius.astype(dtype)                        # [N]
    ck = jnp.sum(centers * centers, axis=-1) - radius ** 2     # [N]

    od = jnp.sum(origin * direction, axis=-1)                  # [R]
    oo = jnp.sum(origin * origin, axis=-1)                     # [R]
    cd = jnp.dot(direction, centers.T,
                 precision=jax.lax.Precision.HIGHEST)          # [R,N]
    oc = jnp.dot(origin, centers.T,
                 precision=jax.lax.Precision.HIGHEST)          # [R,N]

    half_b = od[:, None] - cd
    c = oo[:, None] - 2.0 * oc + ck[None, :]
    disc = half_b * half_b - c

    sqrtd = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
    root_near = -half_b - sqrtd
    root_far = -half_b + sqrtd
    valid = disc > 0
    near_ok = valid & (root_near >= tmin) & (root_near <= tmax)
    far_ok = valid & (root_far >= tmin) & (root_far <= tmax)
    t_cand = jnp.where(near_ok, root_near, jnp.where(far_ok, root_far, big))

    idx = jnp.argmin(t_cand, axis=-1).astype(jnp.int32)
    t = jnp.min(t_cand, axis=-1)
    res = HitResult(t=t, index=idx, hit=t < big)

    # Signed silhouette coordinate; NaN-safe division for padding (r == 0).
    pad = radius == 0
    denom = jnp.where(pad, 1.0, 2.0 * jnp.abs(radius))[None, :]
    s = jnp.where(pad[None, :], -1e9, disc / denom)

    # Hypothetical interaction parameter: real root where one exists in
    # range, else the (unclipped) perpendicular foot.
    rooted = near_ok | far_ok
    t_int = jnp.where(near_ok, root_near,
                      jnp.where(far_ok, root_far, -half_b))
    return res, s, t_int, rooted


def pixel_angle(cam, f32_h: float) -> jnp.ndarray:
    """Angular height of one pixel (radians) — the footprint scale for
    auto-sigma. The film spans |vertical| at the focus plane, which sits
    |llc + h/2 + v/2 - origin| from the eye."""
    center = (cam.lower_left_corner + 0.5 * cam.horizontal
              + 0.5 * cam.vertical - cam.origin)
    focus = jnp.sqrt(jnp.sum(center * center))
    vh = jnp.sqrt(jnp.sum(cam.vertical * cam.vertical))
    return vh / (f32_h * focus)


def _smoothstep_band(s: jnp.ndarray, sig) -> jnp.ndarray:
    """C1 coverage weight with support exactly [-sig, sig] (module
    docstring: a sigmoid's infinite tails bias the z gradient)."""
    x = jnp.clip((s / sig + 1.0) * 0.5, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


@partial(jax.jit, static_argnames=("max_depth", "tmin", "sigma", "sigma_px",
                                   "edge_bounces"))
def trace_edge(scene: Scene, origin: jnp.ndarray, direction: jnp.ndarray,
               key: jax.Array, max_depth: int = DEFAULT_MAX_DEPTH,
               tmin: float = DEFAULT_TMIN, sigma: float | None = None,
               sigma_px: float = 1.0,
               pix_angle: jnp.ndarray | None = None,
               edge_bounces: int = 2) -> jnp.ndarray:
    """Trace ``R`` primary rays to radiance ``[R,3]`` with boundary-aware
    gradients for the first ``edge_bounces`` bounces (module docstring).

    The primal equals a hard render whose RNG is slot-keyed per ray (the
    ``trace(keyed=True)`` stream family); gradients additionally carry the
    straight-through silhouette terms. ``sigma`` is the edge band
    half-width in scene units; ``None`` auto-scales per ray to ``sigma_px``
    pixel footprints at the interaction distance (pass ``pix_angle`` from
    :func:`pixel_angle`).
    """
    dtype = origin.dtype
    R = origin.shape[0]
    slots = jnp.arange(R, dtype=jnp.int32)
    one = jnp.asarray(1.0, dtype)
    big = jnp.asarray(BIG, dtype)
    if sigma is None and pix_angle is None:
        raise ValueError("sigma=None needs pix_angle (see pixel_angle()) "
                         "for the footprint scale")

    def cont_body(b, state):
        """One plain (interior-only) bounce for a [2R] branch pair, with
        the MAIN path's slot keys on both halves (common random numbers —
        the winner half replays the hard path draw-for-draw)."""
        org, d, thr, rad, alive = state
        r2 = intersect_spheres(org, d, scene, tmin=tmin)
        key_b = jax.random.fold_in(key, b)
        rk = slot_keys(key_b, jnp.tile(slots, 2))
        miss_now = alive & ~r2.hit
        rad = rad + jnp.where(miss_now[:, None], thr * skycolor(d), 0.0)
        t_safe = jnp.where(r2.hit, r2.t, one)
        sc = scatter(scene, org, d, t_safe, r2.index, key_b, ray_keys=rk)
        live = (alive & r2.hit)[:, None]
        return (jnp.where(live, sc.origin, org),
                jnp.where(live, sc.direction, d),
                jnp.where(live, thr * sc.attenuation, thr),
                rad, alive & r2.hit)

    cont = jax.checkpoint(cont_body, prevent_cse=False)

    # ---- Main wavefront with per-bounce edge corrections ----
    org, d = origin, direction
    thr = jnp.ones((R, 3), dtype)
    rad = jnp.zeros((R, 3), dtype)
    alive = jnp.ones((R,), bool)
    corr = jnp.zeros((R, 3), dtype)

    for b in range(min(edge_bounces, max_depth)):
        res, s_all, t_int, rooted = silhouette_coords(org, d, scene, tmin)

        # Edge-sphere selection (detached — discrete choice). Relevant =
        # can flip visibility here: interaction in front of (or at) the
        # current winner; slack admits the winner itself despite fp.
        relevant = ((t_int >= tmin)
                    & (t_int <= res.t[:, None] * (1 + 1e-6) + 1e-6))
        closeness = jnp.where(relevant, -jnp.abs(s_all), -jnp.inf)
        e = jax.lax.stop_gradient(
            jnp.argmax(closeness, axis=-1).astype(jnp.int32))
        has_edge = jnp.isfinite(jnp.max(closeness, axis=-1)) & alive

        s_e = jnp.take_along_axis(s_all, e[:, None], axis=1)[:, 0]
        t_e = jnp.take_along_axis(t_int, e[:, None], axis=1)[:, 0]
        winner_is_e = res.hit & (res.index == e)

        if sigma is None:
            sig = jnp.maximum(sigma_px * pix_angle
                              * jax.lax.stop_gradient(t_e), 1e-4)
        else:
            sig = jnp.asarray(sigma, dtype)
        w_soft = _smoothstep_band(s_e, sig)

        key_b = jax.random.fold_in(key, b)
        rk = slot_keys(key_b, slots)

        # WITH: interact with sphere e at t_e. Effective signed radius
        # sign(r_e)*|p-c_e| keeps scatter()'s normal (p-c)/r_eff unit even
        # for grazing (non-root) interactions; real winners keep the exact
        # radius (primal bit-fidelity with the hard path).
        c_e = scene.center[e].astype(dtype)
        r_e = scene.radius[e].astype(dtype)
        p_w = org + t_e[:, None] * d
        dist = jnp.sqrt(jnp.maximum(
            jnp.sum((p_w - c_e) ** 2, axis=-1), 1e-12))
        r_eff = jnp.where(winner_is_e, r_e,
                          jnp.where(r_e < 0, -dist, dist))
        attrs_e = (c_e, r_eff, scene.albedo[e].astype(dtype),
                   scene.fuzz[e].astype(dtype), scene.ir[e].astype(dtype),
                   scene.mat[e])
        sc_w = scatter(scene, org, d, t_e, e, key_b, ray_keys=rk,
                       attrs=attrs_e)
        st_with = (sc_w.origin, sc_w.direction, thr * sc_w.attenuation,
                   jnp.zeros((R, 3), dtype), alive)

        # WITHOUT: delete e for this bounce — re-reduce the hard
        # candidates (rooted mask == intersect_spheres' validity, so this
        # argmin is EXACTLY the no-e closest hit) with e masked out.
        t_cand_wo = jnp.where(rooted, t_int, big)
        mask_e = (jnp.arange(scene.n_spheres, dtype=jnp.int32)[None, :]
                  == e[:, None])
        t_cand_wo = jnp.where(mask_e, big, t_cand_wo)
        idx_wo = jnp.argmin(t_cand_wo, axis=-1).astype(jnp.int32)
        t_wo = jnp.min(t_cand_wo, axis=-1)
        hit_wo = t_wo < big
        t_wo_safe = jnp.where(hit_wo, t_wo, one)
        sc_wo = scatter(scene, org, d, t_wo_safe, idx_wo, key_b,
                        ray_keys=rk)
        sky_wo = jnp.where((alive & ~hit_wo)[:, None],
                           thr * skycolor(d), 0.0)
        st_without = (jnp.where(hit_wo[:, None], sc_wo.origin, org),
                      jnp.where(hit_wo[:, None], sc_wo.direction, d),
                      jnp.where(hit_wo[:, None], thr * sc_wo.attenuation,
                                thr),
                      sky_wo, alive & hit_wo)

        # Branch continuations to full depth (rad planes start at this
        # bounce's emission, thr planes carry the branch attenuation — the
        # final rad planes ARE the branch radiances from here on).
        both = tuple(jnp.concatenate([a, bb], axis=0)
                     for a, bb in zip(st_with, st_without))
        _, _, _, rad_pair, _ = jax.lax.fori_loop(b + 1, max_depth, cont,
                                                 both)
        L_with, L_without = rad_pair[:R], rad_pair[R:]

        w_st = (w_soft - jax.lax.stop_gradient(w_soft)) * has_edge
        corr = corr + w_st[:, None] * (L_with - L_without)

        # Main state advances by the HARD select of the two branch states
        # (exact: the with-branch is the real bounce when e wins, the
        # without-branch is the real bounce otherwise).
        w_sel = winner_is_e[:, None]
        rad = rad + jnp.where(winner_is_e[:, None], 0.0, sky_wo)
        org = jnp.where(w_sel, st_with[0], st_without[0])
        d = jnp.where(w_sel, st_with[1], st_without[1])
        thr = jnp.where(w_sel, st_with[2], st_without[2])
        alive = jnp.where(winner_is_e, st_with[4], st_without[4])

    # ---- Remaining bounces: plain interior-only wavefront ----
    def main_body(b, state):
        org, d, thr, rad, alive = state
        r2 = intersect_spheres(org, d, scene, tmin=tmin)
        key_b = jax.random.fold_in(key, b)
        rk = slot_keys(key_b, slots)
        miss_now = alive & ~r2.hit
        rad = rad + jnp.where(miss_now[:, None], thr * skycolor(d), 0.0)
        t_safe = jnp.where(r2.hit, r2.t, one)
        sc = scatter(scene, org, d, t_safe, r2.index, key_b, ray_keys=rk)
        live = (alive & r2.hit)[:, None]
        return (jnp.where(live, sc.origin, org),
                jnp.where(live, sc.direction, d),
                jnp.where(live, thr * sc.attenuation, thr),
                rad, alive & r2.hit)

    main = jax.checkpoint(main_body, prevent_cse=False)
    _, _, _, rad, _ = jax.lax.fori_loop(min(edge_bounces, max_depth),
                                        max_depth, main,
                                        (org, d, thr, rad, alive))
    return rad + corr


def render_radiance_edge(scene: Scene, cam, image_width: int,
                         n_samples: int = 1, *,
                         image_height: int | None = None,
                         max_depth: int = DEFAULT_MAX_DEPTH,
                         tmin: float = DEFAULT_TMIN,
                         seed: int | jax.Array = 0,
                         sigma: float | None = None,
                         sigma_px: float = 1.0,
                         edge_bounces: int = 2,
                         pixel_chunk: int | None = None,
                         remat_chunks: bool = False) -> jnp.ndarray:
    """Boundary-aware differentiable render ``[H,W,3]`` (linear radiance).

    Sampling conventions mirror render.py's pass loop (centered global
    sample 0, U[0,1)/W|H jitter, LENS/SCATTER purpose keys) so the primal
    agrees statistically with the production forward; the gradient carries
    silhouette boundary terms for the first ``edge_bounces`` bounces. One
    pass per sample (this is a geometry-fit path, not the throughput path).

    ``pixel_chunk`` bounds the [R, N] silhouette sweep's working set (the
    edge path materializes ~6 ray-x-sphere planes): a flagship 512-sphere
    scene at 230k rays is ~2.8 GB unchunked. Chunk RNG folds the chunk id,
    so chunked and unchunked renders agree statistically, not bitwise.

    ``remat_chunks`` checkpoints each (chunk, sample) trace: reverse mode
    then keeps only the [chunk, 3] radiance per trace and recomputes the
    [R, N] silhouette residuals in the backward — O(1) residual memory in
    n_pix*spp at ~2x forward compute. Without it the residuals of EVERY
    chunk and sample coexist in the backward (960x540x8spp measured OOM
    on a 16 GiB chip; 640x360x4 fits).
    """
    import numpy as np
    from .. import rng
    from ..camera import get_rays
    from ..render import pixel_coords, image_height_for
    from ..scene import trim_scene

    scene = trim_scene(scene)
    H = (image_height if image_height is not None
         else image_height_for(image_width))
    W = image_width
    n_pix = H * W
    dtype = cam.origin.dtype
    u, v = pixel_coords(W, H, dtype=dtype)
    key = (seed if isinstance(seed, jax.Array)
           else jax.random.PRNGKey(seed))
    scale = jnp.asarray([1.0 / float(np.float32(W)),
                         1.0 / float(np.float32(H))], dtype)
    pa = None if sigma is not None else pixel_angle(cam, float(np.float32(H)))

    if pixel_chunk is None or pixel_chunk >= n_pix:
        if remat_chunks and n_pix > (1 << 16):
            # Silently no-opping would hand the caller the exact OOM the
            # flag exists to prevent: one chunk = one
            # checkpoint region = the whole forward's residuals anyway.
            raise ValueError(
                "remat_chunks=True needs pixel_chunk < n_pix to have any "
                f"effect (n_pix={n_pix}); pass e.g. pixel_chunk="
                f"{1 << 16}")
        chunks = [(slice(0, n_pix), key)]
    else:
        n_chunks = -(-n_pix // pixel_chunk)
        chunks = [(slice(c * pixel_chunk, min((c + 1) * pixel_chunk, n_pix)),
                   jax.random.fold_in(key, c)) for c in range(n_chunks)]

    def chunk_sum(scene, uc, vc, ckey):
        acc = jnp.zeros((uc.shape[0], 3), dtype)
        for s0 in range(n_samples):
            key_p = jax.random.fold_in(ckey, s0)
            jit_uv = jax.random.uniform(
                rng.purpose_key(key_p, rng.PIXEL_JITTER),
                (uc.shape[0], 2), dtype=dtype)
            jit_uv = jnp.where(s0 == 0, 0.0, jit_uv * scale)
            o, d = get_rays(cam, uc + jit_uv[:, 0], vc + jit_uv[:, 1],
                            rng.purpose_key(key_p, rng.LENS))
            acc = acc + trace_edge(scene, o, d,
                                   rng.purpose_key(key_p, rng.SCATTER_DIR),
                                   max_depth=max_depth, tmin=tmin,
                                   sigma=sigma, sigma_px=sigma_px,
                                   pix_angle=pa,
                                   edge_bounces=edge_bounces)
        return acc

    if remat_chunks and len(chunks) > 1:
        # lax.scan over checkpointed equal-size chunks: SEQUENTIAL by
        # construction, so the backward holds one chunk's recompute region
        # at a time (independent checkpoint calls were measured to
        # co-schedule, holding every chunk's recompute region at once).
        pc = pixel_chunk
        n_chunks = -(-n_pix // pc)
        pad = n_chunks * pc - n_pix
        u_st = jnp.pad(u, (0, pad)).reshape(n_chunks, pc)
        v_st = jnp.pad(v, (0, pad)).reshape(n_chunks, pc)
        keys = jnp.stack([k for _, k in chunks])

        def body(carry, xs):
            uc, vc, ckey = xs
            return carry, chunk_sum(scene, uc, vc, ckey)

        _, out = jax.lax.scan(jax.checkpoint(body, prevent_cse=False),
                              0.0, (u_st, v_st, keys))
        out = out.reshape(n_chunks * pc, 3)[:n_pix]
        return (out / n_samples).reshape(H, W, 3)

    pieces = [chunk_sum(scene, u[sl], v[sl], ckey) for sl, ckey in chunks]
    out = pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=0)
    return (out / n_samples).reshape(H, W, 3)
