"""Wavefront path integrator.

The reference's ``ray_color`` is a *recursive* per-ray function: miss → sky,
hit → scatter and recurse with multiplied attenuation, depth 16 then black
(reference: src/ray_color.jl:14-38). Recursion is hostile to XLA; the
integrator here is the standard wavefront rewrite: a ``lax.fori_loop``
over bounces carrying SoA per-ray state
``(origin, direction, throughput, radiance, alive)`` with masked updates:

    miss  : radiance += throughput * skycolor(dir); alive = False
    hit   : throughput *= attenuation; (origin, dir) = scatter(...)
    depth : after ``max_depth`` scatters surviving rays contribute black,
            exactly like the reference's ``depth <= 0 -> black`` base case.

Equivalence argument: unrolling the reference recursion gives
``color = (prod of attenuations until first miss) * sky``, or 0 if no miss
within ``max_depth`` scatters — precisely what the loop accumulates.

For reverse-mode AD the loop body is wrapped in ``jax.checkpoint`` so the
backward sweep rematerialises per-bounce state instead of stashing all 16
bounce frontiers in device memory.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from ..scene import Scene
from .intersect import intersect_spheres, DEFAULT_TMIN, BIG
from .materials import scatter, slot_keys


def _pick_intersector(use_pallas: bool | None = None):
    """Resolve the intersection backend as a function returning
    ``(HitResult, None)`` (the second slot is the pre-fetched attribute
    tuple ``scatter`` accepts; no sweep here fetches attributes).

    ``use_pallas=None`` asks :func:`utils.platform.use_sweep_kernel`, the one
    place that decides whether the Pallas sweep kernel runs; True/False pin
    it. Float64 rays always take the XLA sweep: the kernel is f32 by design,
    and f64 is the oracle/precision-anchor path (reference
    src/proto/proto.jl:15) — a dtype route, not a fallback. All variants are
    differentiable.
    """
    if use_pallas is None:
        from ..utils.platform import use_sweep_kernel
        use_pallas = use_sweep_kernel()
    if use_pallas:
        from .pallas.intersect_kernel import intersect_spheres_pallas

        def pallas_isect(org, d, scene, tmin):
            if org.dtype == jnp.float64:
                return intersect_spheres(org, d, scene, tmin=tmin), None
            return intersect_spheres_pallas(org, d, scene, tmin=tmin), None

        return pallas_isect

    def xla_isect(org, d, scene, tmin):
        return intersect_spheres(org, d, scene, tmin=tmin), None

    return xla_isect


#: Reference default bounce depth (src/ray_color.jl:14); 4 is insufficient for
#: hollow glass (README.md:208-210).
DEFAULT_MAX_DEPTH = 16


def _check_film(f32_w: float, f32_h: float) -> None:
    """The persistent renderer regenerates samples in place and needs the
    film size for jitter scaling; the 0.0 defaults would give NaN rays for
    every regenerated sample (1/0 jitter scale) instead of an error. Fail
    loudly at trace time."""
    if not (f32_w > 0 and f32_h > 0):
        raise ValueError(
            f"f32_w/f32_h must be the positive film size in pixels, got "
            f"({f32_w}, {f32_h}) — pass float(image_width), "
            f"float(image_height)")


_WHITE = (1.0, 1.0, 1.0)
_SKYBLUE = (0.5, 0.7, 1.0)


def skycolor(direction: jnp.ndarray) -> jnp.ndarray:
    """Vertical white→skyblue lerp on dir.y (reference: src/ray_color.jl:1-6)."""
    dtype = direction.dtype
    t = 0.5 * (direction[..., 1] + 1.0)
    white = jnp.asarray(_WHITE, dtype)
    skyblue = jnp.asarray(_SKYBLUE, dtype)
    return (1.0 - t)[..., None] * white + t[..., None] * skyblue


@partial(jax.jit, static_argnames=("max_depth", "tmin", "remat", "keyed",
                                   "use_pallas", "tile_skip"))
def trace(scene: Scene, origin: jnp.ndarray, direction: jnp.ndarray,
          key: jax.Array, max_depth: int = DEFAULT_MAX_DEPTH,
          tmin: float = DEFAULT_TMIN, remat: bool = False,
          keyed: bool = False, use_pallas: bool | None = None,
          tile_skip: int = 0) -> jnp.ndarray:
    """Trace ``R`` primary rays to radiance ``[R,3]``.

    Args:
      scene: SoA scene pytree (differentiable).
      origin/direction: [R,3] primary rays (directions unit).
      key: per-(chunk) RNG key; bounce b consumes ``fold_in(key, b)``.
      max_depth: maximum scatter events (reference default 16).
      remat: checkpoint the bounce body (use True under ``grad``).
      keyed: per-ray slot-keyed RNG (position-independent draws; bit-matches
        ``trace_compacted``; slightly more expensive than positional draws).
      use_pallas: pin the sweep kernel on/off (None: platform default).
      tile_skip: when > 0, the wavefront is processed in tiles of this many
        rays, each bounce guarded by a per-tile scalar ``lax.cond`` on an
        any-alive reduction — fully-dead tiles (pixel-coherent sky regions
        die at bounce 1; flagship mean path length is 3.15 of 16, so most
        late-bounce tiles are dead) cost nothing, in the forward, the
        remat recompute, AND the transposed backward, because ``cond``
        transposes to a cond. Unlike ``trace_compacted`` this stays
        reverse-differentiable (fixed-trip ``fori_loop``, no sort, no
        ``while_loop``). Tile RNG is folded with the tile index, so images
        differ from ``tile_skip=0`` only in stream layout (statistical
        equivalence; see tests).
    """
    if tile_skip and keyed:
        raise ValueError("tile_skip uses per-tile positional RNG; keyed=True "
                         "is not supported together with it")
    dtype = origin.dtype
    R = origin.shape[0]
    slots = jnp.arange(R, dtype=jnp.int32) if keyed else None
    intersect = _pick_intersector(use_pallas)

    def bounce_math(org, d, thr, rad, alive, res, attrs, key_b, rk):
        # Miss: accumulate sky once, then the ray dies
        # (reference: src/ray_color.jl:35-37).
        miss_now = alive & ~res.hit
        rad = rad + jnp.where(miss_now[..., None], thr * skycolor(d), 0.0)

        # Hit: scatter. Clamp t for non-hitting rays to keep every lane finite
        # (NaN-under-where guard for reverse mode).
        t_safe = jnp.where(res.hit, res.t, jnp.asarray(1.0, dtype))
        s = scatter(scene, org, d, t_safe, res.index, key_b, ray_keys=rk,
                    attrs=attrs)

        live_hit = (alive & res.hit)[..., None]
        org = jnp.where(live_hit, s.origin, org)
        d = jnp.where(live_hit, s.direction, d)
        thr = jnp.where(live_hit, thr * s.attenuation, thr)
        alive = alive & res.hit
        return org, d, thr, rad, alive

    if tile_skip:
        n_tiles = -(-R // tile_skip)
        Rp = n_tiles * tile_skip
        pad = Rp - R

        def body(b, state):
            org, d, thr, rad, alive = state
            key_b = jax.random.fold_in(key, b)
            alive_t = alive.reshape(n_tiles, tile_skip)
            tile_alive = jnp.any(alive_t, axis=1)
            tkeys = jax.vmap(jax.random.fold_in, (None, 0))(
                key_b, jnp.arange(n_tiles, dtype=jnp.int32))

            def tile_body(_, xs):
                o_t, d_t, thr_t, rad_t, al_t, flag, tk = xs

                def do(args):
                    o_t, d_t, thr_t, rad_t, al_t = args
                    res, attrs = intersect(o_t, d_t, scene, tmin)
                    return bounce_math(o_t, d_t, thr_t, rad_t, al_t, res,
                                       attrs, tk, None)

                out = jax.lax.cond(flag, do, lambda a: a,
                                   (o_t, d_t, thr_t, rad_t, al_t))
                return None, out

            shp3 = (n_tiles, tile_skip, 3)
            _, (o2, d2, th2, ra2, al2) = jax.lax.scan(
                tile_body, None,
                (org.reshape(shp3), d.reshape(shp3), thr.reshape(shp3),
                 rad.reshape(shp3), alive_t, tile_alive, tkeys))
            return (o2.reshape(Rp, 3), d2.reshape(Rp, 3), th2.reshape(Rp, 3),
                    ra2.reshape(Rp, 3), al2.reshape(Rp))

        origin = jnp.pad(origin, ((0, pad), (0, 0)))
        direction = jnp.pad(direction, ((0, pad), (0, 0)))
        direction = direction.at[R:, 1].set(1.0) if pad else direction
        init_alive = jnp.arange(Rp) < R
        R_run = Rp
    else:
        def body(b, state):
            org, d, thr, rad, alive = state
            res, attrs = intersect(org, d, scene, tmin)
            key_b = jax.random.fold_in(key, b)
            rk = slot_keys(key_b, slots) if slots is not None else None
            return bounce_math(org, d, thr, rad, alive, res, attrs, key_b, rk)

        init_alive = jnp.ones((R,), dtype=bool)
        R_run = R

    if remat:
        body = jax.checkpoint(body, prevent_cse=False)

    init = (origin, direction,
            jnp.ones((R_run, 3), dtype),   # throughput
            jnp.zeros((R_run, 3), dtype),  # radiance
            init_alive)
    _, _, _, radiance, _ = jax.lax.fori_loop(0, max_depth, body, init)
    # Rays still alive after max_depth contribute black
    # (reference: src/ray_color.jl:15-17) — nothing to add.
    return radiance[:R]


@partial(jax.jit, static_argnames=("max_depth", "tmin", "tile", "compact_every",
                                   "use_pallas"))
def trace_compacted(scene: Scene, origin: jnp.ndarray, direction: jnp.ndarray,
                    key: jax.Array, max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN, tile: int = 16384,
                    compact_every: int = 4,
                    use_pallas: bool | None = None) -> jnp.ndarray:
    """Forward-only wavefront trace with tile skipping + periodic compaction.

    Matches :func:`trace` with ``keyed=True`` ray-for-ray to <=1 ulp (per-ray
    randomness is slot-keyed so ray position is immaterial; the residual ulp
    comes from XLA fusing the two programs differently), with two
    dead-work eliminations on top:

    - every bounce, each ray tile is guarded by a scalar ``lax.cond`` on a
      per-tile any-alive reduction — XLA compiles that to real control flow,
      so fully-dead tiles cost nothing. Primary rays are pixel-coherent (sky
      regions die together), so this fires even before any reordering;
    - every ``compact_every`` bounces, a stable multi-operand ``lax.sort``
      keyed on deadness packs survivors into a dense prefix, turning the
      straggler pattern back into fully-dead tiles. Sorting every bounce is
      counterproductive — the 14-operand sort costs about as much as a sparse
      bounce sweep — so the default re-packs every 4th bounce.

    A ``while_loop`` with a global any-alive condition exits as soon as the
    whole wavefront dies, so this path is NOT reverse-differentiable — the
    grad path uses :func:`trace` (remat=True). The combination replaces the
    reference's dynamic recursion exit (src/ray_color.jl:31), which a
    fixed-trip SIMD wavefront cannot express per lane. Flagship-scene mean
    path length is 3.15 of 16 bounces (measured via ``trace_occupancy``,
    t_cam1; alive fractions [1, .84, .37, .22, .14, ...]), bounding the
    ideal gain at ~5x.
    """
    dtype = origin.dtype
    R0 = origin.shape[0]
    n_tiles = -(-R0 // tile)
    R = n_tiles * tile
    pad = R - R0
    intersect = _pick_intersector(use_pallas)

    org = jnp.pad(origin, ((0, pad), (0, 0)))
    d = jnp.pad(direction, ((0, pad), (0, 0)), constant_values=0.0)
    d = d.at[R0:, 1].set(1.0) if pad else d  # harmless unit dirs for padding
    thr = jnp.ones((R, 3), dtype)
    rad = jnp.zeros((R, 3), dtype)
    alive = (jnp.arange(R) < R0)
    # Slot = original ray id; padding gets R0 (dropped by the final scatter).
    slot = jnp.minimum(jnp.arange(R, dtype=jnp.int32), R0)

    def compact(st):
        org, d, thr, rad, alive, slot = st
        dead = (~alive).astype(jnp.int32)
        ops = (dead,
               org[:, 0], org[:, 1], org[:, 2],
               d[:, 0], d[:, 1], d[:, 2],
               thr[:, 0], thr[:, 1], thr[:, 2],
               rad[:, 0], rad[:, 1], rad[:, 2],
               slot)
        s = jax.lax.sort(ops, dimension=0, is_stable=True, num_keys=1)
        col3 = lambda a, b, c: jnp.stack([a, b, c], axis=-1)
        return (col3(s[1], s[2], s[3]), col3(s[4], s[5], s[6]),
                col3(s[7], s[8], s[9]), col3(s[10], s[11], s[12]),
                s[0] == 0, s[13])

    key_of_bounce = lambda b: jax.random.fold_in(key, b)

    def bounce(carry):
        b, st = carry
        st = jax.lax.cond((b > 0) & (b % compact_every == 0),
                          compact, lambda s: s, st)
        org, d, thr, rad, alive, slot = st
        # Per-tile any-alive flags: dead tiles are skipped outright.
        alive_t = alive.reshape(n_tiles, tile)
        tile_alive = jnp.any(alive_t, axis=1)
        key_b = key_of_bounce(b)

        def scan_body(_, xs):
            o_t, d_t, thr_t, rad_t, al_t, slot_t, flag = xs

            def do(args):
                o_t, d_t, thr_t, rad_t, al_t, slot_t = args
                res, attrs = intersect(o_t, d_t, scene, tmin)
                miss_now = al_t & ~res.hit
                rad_t = rad_t + jnp.where(miss_now[..., None],
                                          thr_t * skycolor(d_t), 0.0)
                t_safe = jnp.where(res.hit, res.t, jnp.asarray(1.0, dtype))
                s = scatter(scene, o_t, d_t, t_safe, res.index, key_b,
                            ray_keys=slot_keys(key_b, slot_t), attrs=attrs)
                live_hit = (al_t & res.hit)[..., None]
                return (jnp.where(live_hit, s.origin, o_t),
                        jnp.where(live_hit, s.direction, d_t),
                        jnp.where(live_hit, thr_t * s.attenuation, thr_t),
                        rad_t, al_t & res.hit)

            out = jax.lax.cond(flag, do, lambda a: a[:5],
                               (o_t, d_t, thr_t, rad_t, al_t, slot_t))
            return None, out

        _, (o2, d2, th2, ra2, al2) = jax.lax.scan(
            scan_body, None,
            (org.reshape(n_tiles, tile, 3), d.reshape(n_tiles, tile, 3),
             thr.reshape(n_tiles, tile, 3), rad.reshape(n_tiles, tile, 3),
             alive_t, slot.reshape(n_tiles, tile), tile_alive))
        st = (o2.reshape(R, 3), d2.reshape(R, 3), th2.reshape(R, 3),
              ra2.reshape(R, 3), al2.reshape(R), slot)
        return b + 1, st

    def keep_going(carry):
        b, st = carry
        return (b < max_depth) & jnp.any(st[4])

    _, (org, d, thr, rad, alive, slot) = jax.lax.while_loop(
        keep_going, bounce, (jnp.int32(0), (org, d, thr, rad, alive, slot)))

    # Un-permute: radiance back to original ray order (padding slot R0 drops).
    out = jnp.zeros((R0, 3), dtype)
    return out.at[slot].add(rad, mode="drop")


@partial(jax.jit, static_argnames=("n_samples", "max_depth", "tmin",
                                   "f32_w", "f32_h", "use_pallas"))
def persistent_render_sum(scene: Scene, cam, u: jnp.ndarray, v: jnp.ndarray,
                          key: jax.Array, n_samples: int, sample_offset,
                          max_depth: int = DEFAULT_MAX_DEPTH,
                          tmin: float = DEFAULT_TMIN, f32_w: float = 0.0,
                          f32_h: float = 0.0,
                          use_pallas: bool | None = None) -> jnp.ndarray:
    """Persistent-wavefront renderer: radiance *sum* ``[n_pix,3]`` over
    ``n_samples`` samples per pixel.

    The fixed-depth wavefront (:func:`trace`) wastes ~4/5 of its sweeps on
    dead lanes (flagship mean path length 3.15 of 16 bounces), and generic
    compaction pays more in sort/copy traffic than it recovers. The fix here:
    every lane is *pinned to its pixel* and, the moment its
    ray terminates (sky hit or depth exhaustion), the SAME lane immediately
    starts the NEXT SAMPLE of the SAME pixel — no sort, no gather/scatter, no
    cross-lane communication, and the lane's radiance accumulator already is
    the pixel accumulator. Occupancy stays ~100% until the final per-pixel
    stragglers, so total sweep work approaches the ideal
    sum-over-paths-of-path-length bound.

    RNG is fully counter-based: camera draws keyed by (pixel-slot, sample),
    scatter draws by (slot, sample, bounce) — reproducible regardless of how
    lanes interleave their samples. Semantics match the reference integrator
    exactly: depth budget ``max_depth`` scatters then black
    (src/ray_color.jl:14-38), centered global sample 0 (src/render.jl:30-32),
    jitter U[0,1)/W in u and U[0,1)/H in v (src/render.jl:34-35), thin-lens offsets. Forward-only (while_loop).
    """
    from ..camera import make_rays
    from .sampling import concentric_disk_map, per_ray_uniforms
    from .. import rng as rngmod

    if max_depth <= 0 or n_samples <= 0:
        return jnp.zeros((u.shape[0], 3), u.dtype)

    _check_film(f32_w, f32_h)
    dtype = u.dtype
    R = u.shape[0]
    slots = jnp.arange(R, dtype=jnp.int32)
    intersect = _pick_intersector(use_pallas)
    key_cam = rngmod.purpose_key(key, rngmod.PIXEL_JITTER)
    key_sc = rngmod.purpose_key(key, rngmod.SCATTER_DIR)
    jitter_scale = jnp.asarray([1.0 / f32_w, 1.0 / f32_h], dtype)

    def fold2(base, a, b_):
        k = jax.vmap(jax.random.fold_in, (None, 0))(base, a)
        return jax.vmap(jax.random.fold_in)(k, b_)

    def gen_rays(sample_ids):
        keys = fold2(key_cam, slots, sample_ids)
        u4 = per_ray_uniforms(keys, 4, dtype=dtype)
        jit_uv = jnp.where((sample_ids == 0)[:, None], 0.0,
                           u4[:, 0:2] * jitter_scale)
        disk = concentric_disk_map(u4[:, 2:4] * 2.0 - 1.0)
        return make_rays(cam, u + jit_uv[:, 0], v + jit_uv[:, 1], disk)

    sample_ids = jnp.full((R,), sample_offset, jnp.int32)
    org, d = gen_rays(sample_ids)
    init = (org, d,
            jnp.ones((R, 3), dtype),    # throughput
            jnp.zeros((R, 3), dtype),   # radiance sum over all samples
            jnp.zeros((R,), jnp.int32),  # scatters done for current ray
            sample_ids,
            jnp.ones((R,), bool),       # lane active
            jnp.int32(0))               # safety iteration counter

    last_sample = sample_offset + n_samples - 1

    def cond(st):
        return jnp.any(st[6]) & (st[7] < n_samples * max_depth)

    def body(st):
        org, d, thr, rad, bounces, sample_ids, active, it = st
        res, attrs = intersect(org, d, scene, tmin)

        hit = active & res.hit
        miss = active & ~res.hit
        rad = rad + jnp.where(miss[:, None], thr * skycolor(d), 0.0)

        t_safe = jnp.where(res.hit, res.t, jnp.asarray(1.0, dtype))
        keys_sc = jax.vmap(jax.random.fold_in)(fold2(key_sc, slots, sample_ids),
                                               bounces)
        sc = scatter(scene, org, d, t_safe, res.index, key_sc, ray_keys=keys_sc,
                     attrs=attrs)

        new_b = bounces + 1
        cont = hit & (new_b < max_depth)
        exhausted = hit & ~cont

        org = jnp.where(cont[:, None], sc.origin, org)
        d = jnp.where(cont[:, None], sc.direction, d)
        thr = jnp.where(cont[:, None], thr * sc.attenuation, thr)
        bounces = jnp.where(cont, new_b, bounces)

        # Regenerate: same pixel, next sample, in place.
        need = miss | exhausted
        next_sample = sample_ids + 1
        can = need & (next_sample <= last_sample)
        norg, nd = gen_rays(next_sample)
        org = jnp.where(can[:, None], norg, org)
        d = jnp.where(can[:, None], nd, d)
        thr = jnp.where(can[:, None], 1.0, thr)
        bounces = jnp.where(can, 0, bounces)
        sample_ids = jnp.where(can, next_sample, sample_ids)
        active = (active & ~need) | can
        return org, d, thr, rad, bounces, sample_ids, active, it + 1

    st = jax.lax.while_loop(cond, body, init)
    return st[3]


@partial(jax.jit, static_argnames=("max_depth", "tmin", "tile"))
def trace_occupancy(scene: Scene, origin: jnp.ndarray, direction: jnp.ndarray,
                    key: jax.Array, max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN, tile: int = 16384):
    """Per-bounce wavefront occupancy statistics (observability, SURVEY.md §5:
    'bounce-occupancy, compaction ratio logged per wavefront iteration' — the
    reference logs nothing).

    Returns ``(alive_counts[max_depth], active_tiles[max_depth])`` where
    ``alive_counts[b]`` is the number of live rays entering bounce ``b`` and
    ``active_tiles[b]`` the number of ray tiles that would execute without any
    re-packing (pixel-coherence skip only). ``compaction_ratio[b] =
    alive_counts[b] / (active_tiles[b] * tile)`` measures how much a prefix
    re-pack would still help at that bounce.
    """
    dtype = origin.dtype
    R = origin.shape[0]
    n_tiles = -(-R // tile)
    pad = n_tiles * tile - R

    def body(b, state):
        org, d, alive, counts, tiles = state
        counts = counts.at[b].set(jnp.sum(alive.astype(jnp.int32)))
        alive_p = jnp.pad(alive, (0, pad))
        tiles = tiles.at[b].set(jnp.sum(jnp.any(
            alive_p.reshape(n_tiles, tile), axis=1).astype(jnp.int32)))
        res = intersect_spheres(org, d, scene, tmin=tmin)
        t_safe = jnp.where(res.hit, res.t, jnp.asarray(1.0, dtype))
        s = scatter(scene, org, d, t_safe, res.index, jax.random.fold_in(key, b))
        live_hit = (alive & res.hit)[..., None]
        org = jnp.where(live_hit, s.origin, org)
        d = jnp.where(live_hit, s.direction, d)
        return org, d, alive & res.hit, counts, tiles

    init = (origin, direction, jnp.ones((R,), bool),
            jnp.zeros((max_depth,), jnp.int32), jnp.zeros((max_depth,), jnp.int32))
    _, _, _, counts, tiles = jax.lax.fori_loop(0, max_depth, body, init)
    return counts, tiles
