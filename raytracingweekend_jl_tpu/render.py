"""Render driver — the host-facing ``render`` entry point.

Reference semantics reproduced exactly (reference: src/render.jl:8-44):

- ``image_height = image_width * 9 // 16`` (hardcoded 16:9, src/render.jl:11-12)
  unless an explicit height is given;
- pixel coordinates ``u = (j+1)/W``, ``v = (H-1-i)/H`` for 0-based (i, j) with
  a Y-flip so row 0 is the top of the image (src/render.jl:26-27);
- first sample per pixel centered, samples ≥ 2 jittered by ``U[0,1)/W``
  horizontally and ``U[0,1)/H`` vertically (src/render.jl:29-36);
- accumulate radiance, divide by n_samples, gamma-2 encode (src/render.jl:38-40).

Structure: all pixels of a chunk are traced as one wavefront per sample, the
sample loop is a ``lax.fori_loop`` inside a single jitted program, and pixel
chunking bounds live ray state in device memory. The reference's
``Threads.@threads`` row fork (src/render.jl:23) has no analog here — see
``parallel/`` for the multi-chip shard_map version of this driver.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import rng
from .camera import Camera, get_rays
from .ops.integrator import (trace, trace_compacted, persistent_render_sum,
                             DEFAULT_MAX_DEPTH)
from .ops.intersect import DEFAULT_TMIN
from .ops.vecmath import gamma2_encode
from .scene import Scene


def image_height_for(image_width: int) -> int:
    """Reference: ``image_width ÷ (16//9)`` (src/render.jl:11-12)."""
    return image_width * 9 // 16


def pixel_coords(image_width: int, image_height: int, dtype=jnp.float32):
    """Flattened ``[H*W]`` film coordinates (u, v) in reference convention.

    Julia's 1-based loops give ``u = j/W`` for j in 1..W and
    ``v = (H-i)/H`` for i in 1..H (src/render.jl:26-27); with 0-based indices
    that is ``u = (j+1)/W`` and ``v = (H-1-i)/H``. Row i=0 is the image top.
    """
    j = np.arange(image_width, dtype=np.float64)
    i = np.arange(image_height, dtype=np.float64)
    u = (j + 1.0) / image_width
    v = (image_height - 1.0 - i) / image_height
    uu, vv = np.meshgrid(u, v)  # [H, W]
    return jnp.asarray(uu.ravel(), dtype), jnp.asarray(vv.ravel(), dtype)


def pick_samples_per_pass(n_pix: int, n_samples: int,
                          rays_per_pass: int = 1 << 21) -> int:
    """Largest divisor of ``n_samples`` whose merged wavefront stays under
    ``rays_per_pass`` rays. Big wavefronts are the accelerator analog of the
    reference's busy 16-thread row loop: device occupancy and compaction
    granularity both need millions of rays in flight."""
    best = 1
    for d in range(1, n_samples + 1):
        if n_samples % d == 0 and n_pix * d <= rays_per_pass:
            best = d
    return best


def render_tile_sum(scene: Scene, cam: Camera, u: jnp.ndarray, v: jnp.ndarray,
                    key: jax.Array, n_samples: int, sample_offset, max_depth: int,
                    tmin: float, remat: bool, f32_w: float, f32_h: float,
                    compact: bool = False, samples_per_pass: int = 1,
                    persistent: bool = False,
                    tile_skip: int = 0,
                    recorded: bool = False,
                    recorded_stage: tuple | None = None,
                    remat_passes: bool = False) -> jnp.ndarray:
    """Radiance *sum* ``[Rc,3]`` of ``n_samples`` samples for one pixel tile.

    The building block shared by the single-device driver and the shard_map
    driver (parallel/shard.py). ``sample_offset`` is the tile's first *global*
    sample index — only global sample 0 takes the centered (un-jittered) path
    (reference: src/render.jl:30-32), so sample-axis sharding preserves the
    reference's sampling pattern. ``key`` must already be tile-specific.

    ``persistent`` selects the persistent-wavefront integrator
    (ops/integrator.persistent_render_sum: lanes pinned to pixels start the
    next sample in place when a ray dies); it is forward-only.

    ``samples_per_pass`` merges that many samples of every pixel into ONE
    wavefront (pixels x samples along the ray axis) so each trace call carries
    millions of rays; with ``samples_per_pass == 1`` the RNG stream layout is
    exactly the classic one-sample-per-pass scheme.
    """
    if persistent:
        return persistent_render_sum(scene, cam, u, v, key, n_samples,
                                     sample_offset, max_depth, tmin,
                                     f32_w, f32_h)
    dtype = u.dtype
    n_pix = u.shape[0]
    spp = samples_per_pass
    if n_samples % spp != 0:
        raise ValueError(f"samples_per_pass={spp} must divide n_samples={n_samples}")
    n_pass = n_samples // spp
    scale = jnp.asarray([1.0 / f32_w, 1.0 / f32_h], dtype)

    def pass_body(p, accum):
        s0 = sample_offset + p * spp  # global index of this pass's first sample
        key_p = jax.random.fold_in(key, s0)
        # Per-ray global sample ids, sample-major: [spp * n_pix].
        sid = s0 + jnp.repeat(jnp.arange(spp, dtype=jnp.int32), n_pix)
        # Supersampling jitter: global sample 0 centered, others jittered
        # by U[0,1)/W horizontally and U[0,1)/H vertically, exactly the
        # reference (du/f32_image_width, dv/f32_image_HEIGHT —
        # src/render.jl:34-35; the divisors stay Float32 even in Float64
        # renders, src/render.jl:13-14).
        jit_uv = jax.random.uniform(rng.purpose_key(key_p, rng.PIXEL_JITTER),
                                    (spp * n_pix, 2), dtype=dtype)
        jit_uv = jnp.where((sid == 0)[:, None], 0.0, jit_uv * scale)
        us = jnp.tile(u, spp) + jit_uv[:, 0]
        vs = jnp.tile(v, spp) + jit_uv[:, 1]
        origin, direction = get_rays(cam, us, vs, rng.purpose_key(key_p, rng.LENS))
        trace_key = rng.purpose_key(key_p, rng.SCATTER_DIR)
        if compact:
            # Forward-only fast path: active-ray compaction + keyed RNG
            # (matches trace(keyed=True) to <=1 ulp).
            radiance = trace_compacted(scene, origin, direction, trace_key,
                                       max_depth=max_depth, tmin=tmin)
        elif recorded:
            # Recorded-path custom VJP: no remat recompute, sweep-free
            # backward (ops/grad_trace.py) — the production grad path.
            # recorded_stage=(B, div): opt-in staged variant — tail bounces
            # >= B run at width R//div over the compacted survivors (see the
            # budget contract in ops/grad_trace.py).
            if recorded_stage is not None:
                from .ops.grad_trace import trace_recorded_staged
                stage_b, stage_div = recorded_stage
                stage_width = max(origin.shape[0] // stage_div, 1)
                radiance, alive_count = trace_recorded_staged(
                    scene, origin, direction, trace_key, max_depth, tmin,
                    None, stage_b, stage_width)
                # Budget contract (ops/grad_trace.py): survivors beyond
                # stage_width at stage_bounce get their tails truncated,
                # silently biasing image AND gradients. Surface it.
                jax.lax.cond(
                    alive_count > stage_width,
                    lambda c: jax.debug.print(
                        "WARNING trace_recorded_staged: {} lanes alive at "
                        "stage bounce exceed stage_width={} — overflow "
                        "tails truncated (biased radiance/gradients); "
                        "raise stage_width or lower stage_bounce", c,
                        stage_width),
                    lambda c: None, alive_count)
            else:
                from .ops.grad_trace import trace_recorded
                radiance = trace_recorded(scene, origin, direction, trace_key,
                                          max_depth, tmin, None)
        else:
            radiance = trace(scene, origin, direction, trace_key,
                             max_depth=max_depth, tmin=tmin, remat=remat,
                             tile_skip=tile_skip)
        return accum + radiance.reshape(spp, n_pix, 3).sum(axis=0)

    if remat_passes and n_pass > 1:
        # Reverse-mode keeps EVERY pass's custom-VJP residuals (the path
        # records) alive until the backward — at high spp that is
        # n_pass x whole-image records and OOMs (46 GB at flagship
        # spp=16). Checkpointing the pass body stores only the radiance
        # accumulator per pass and RECOMPUTES each pass's record in the
        # backward: one extra record forward per pass buys O(1) residual
        # memory in spp.
        body = jax.checkpoint(pass_body)
    else:
        body = pass_body
    return jax.lax.fori_loop(
        0, n_pass, body, jnp.zeros((n_pix, 3), dtype))


@partial(jax.jit, static_argnames=("n_samples", "max_depth", "tmin", "remat",
                                   "f32_w", "f32_h", "compact", "samples_per_pass",
                                   "persistent", "tile_skip", "recorded",
                                   "recorded_stage", "remat_passes"))
def _render_chunk(scene: Scene, cam: Camera, u: jnp.ndarray, v: jnp.ndarray,
                  key: jax.Array, n_samples: int, max_depth: int, tmin: float,
                  remat: bool, f32_w: float, f32_h: float,
                  compact: bool = False, samples_per_pass: int = 1,
                  persistent: bool = False,
                  tile_skip: int = 0,
                  recorded: bool = False,
                  recorded_stage: tuple | None = None,
                  remat_passes: bool = False) -> jnp.ndarray:
    """Mean radiance ``[Rc,3]`` for one pixel chunk, all samples."""
    acc = render_tile_sum(scene, cam, u, v, key, n_samples, 0, max_depth,
                          tmin, remat, f32_w, f32_h, compact, samples_per_pass,
                          persistent, tile_skip, recorded, recorded_stage,
                          remat_passes)
    return acc / n_samples


def render_radiance(scene: Scene, cam: Camera, image_width: int = 400,
                    n_samples: int = 1, *, image_height: int | None = None,
                    max_depth: int = DEFAULT_MAX_DEPTH, tmin: float = DEFAULT_TMIN,
                    seed: int | jax.Array = 0, dtype=None,
                    pixel_chunk: int | None = None, remat: bool = False,
                    compact: bool = False, persistent: bool = False,
                    rays_per_pass: int | None = None,
                    tile_skip: int = 0,
                    recorded: bool = False,
                    recorded_stage: tuple | None = None,
                    remat_passes: bool = False) -> jnp.ndarray:
    """Linear mean radiance ``[H,W,3]`` (no gamma). Differentiable w.r.t. ``scene``.

    ``dtype`` (the reference's ``elem_type`` switch) defaults to the camera's
    element type so float64 and float32 renders compose without extra
    plumbing.
    """
    if dtype is None:
        dtype = cam.origin.dtype
    # Drop trailing zero-radius padding (bitwise no-op, scene.trim_scene):
    # make_scene pads every scene to SPHERE_PAD=128, so without this a
    # 2-sphere render sweeps 64x dead spheres per bounce. No-op under
    # autodiff tracers (gradient pytrees keep the caller's shapes).
    from .scene import trim_scene
    scene = trim_scene(scene)
    H = image_height if image_height is not None else image_height_for(image_width)
    W = image_width
    u, v = pixel_coords(W, H, dtype=dtype)
    if isinstance(seed, jax.Array) and (
            jnp.issubdtype(seed.dtype, jax.dtypes.prng_key)
            or (seed.dtype == jnp.uint32 and seed.shape == (2,))):
        # typed PRNG key, or a legacy uint32[2] raw key (the historical
        # jax.random.PRNGKey format) — both accepted per the annotation.
        key = seed
    else:
        key = jax.random.PRNGKey(seed)

    n_pix = H * W
    if pixel_chunk is None or pixel_chunk >= n_pix:
        spp_pass = 1 if rays_per_pass is None else \
            pick_samples_per_pass(n_pix, n_samples, rays_per_pass)
        out = _render_chunk(scene, cam, u, v, key, n_samples, max_depth,
                            tmin, remat, float(np.float32(W)), float(np.float32(H)),
                            compact, spp_pass, persistent,
                            tile_skip=tile_skip, recorded=recorded,
                            recorded_stage=recorded_stage,
                            remat_passes=remat_passes)
    else:
        # Pad to a chunk multiple so every chunk compiles to the same program.
        n_chunks = -(-n_pix // pixel_chunk)
        pad = n_chunks * pixel_chunk - n_pix
        u_p = jnp.pad(u, (0, pad))
        v_p = jnp.pad(v, (0, pad))
        spp_pass = 1 if rays_per_pass is None else \
            pick_samples_per_pass(pixel_chunk, n_samples, rays_per_pass)
        pieces = []
        for c in range(n_chunks):
            sl = slice(c * pixel_chunk, (c + 1) * pixel_chunk)
            pieces.append(_render_chunk(
                scene, cam, u_p[sl], v_p[sl], jax.random.fold_in(key, c),
                n_samples, max_depth, tmin, remat,
                float(np.float32(W)), float(np.float32(H)), compact, spp_pass,
                persistent, tile_skip=tile_skip, recorded=recorded,
                recorded_stage=recorded_stage,
                remat_passes=remat_passes))
        out = jnp.concatenate(pieces, axis=0)[:n_pix]
    return out.reshape(H, W, 3)


def render(scene: Scene, cam: Camera, image_width: int = 400, n_samples: int = 1,
           **kwargs) -> jnp.ndarray:
    """Gamma-2 encoded image ``[H,W,3]`` in [0,1] — reference ``render``
    (src/render.jl:8-9) re-idiomized; returns a float array rather than a
    ``Matrix{RGB}``."""
    return gamma2_encode(render_radiance(scene, cam, image_width, n_samples, **kwargs))
