"""shard_map render and training step — the multi-chip driver.

This is the accelerator replacement of the reference's fork-join row loop
(reference: src/render.jl:23-42): pixel *tiles* are sharded over the mesh's
``tiles`` axis, samples-per-pixel over the ``samples`` axis, and the per-shard
partial radiance sums are combined with a single ``psum`` over ``samples``
(SURVEY.md §2.4: the comm module the reference never needed).

Determinism contract: tiles are fixed-size blocks of ``tile_size`` pixels and
each tile's RNG key is folded with its *global* tile id — so resharding the
``tiles`` axis is bit-identical for a fixed ``tile_size`` (unlike the
reference, whose images are only reproducible for a fixed thread count,
SURVEY.md §2.5). Resharding the ``samples`` axis changes the float summation
order (per-shard partial sums then a psum), so across sample-shard counts the
image is equal only up to float accumulation order (~1e-5, see
tests/test_parallel.py).

The whole driver is differentiable: ``shard_map`` has transpose rules, so
``jax.grad`` of a loss of the sharded image produces gradients for the
replicated scene pytree with the cross-shard reduction inserted by XLA (the
gradient all-reduce of BASELINE.json's north star).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import rng
from ..camera import Camera
from ..ops.integrator import DEFAULT_MAX_DEPTH
from ..ops.intersect import DEFAULT_TMIN
from ..render import render_tile_sum, pixel_coords, image_height_for
from ..scene import Scene
from .mesh import TILES_AXIS, SAMPLES_AXIS

#: Default pixels per tile. Tiles are the unit of RNG keying (global tile id),
#: so the tile size is part of an image's identity. 8192 keeps many tiles per
#: device on small images; a GPU is only filled by tiles of 2^18 pixels or
#: more, so pass ``tile_size`` for large renders.
DEFAULT_TILE = 8192


def _padded_coords(image_width: int, image_height: int, tile_size: int,
                   n_tile_shards: int, dtype):
    """Flattened film coords padded so tiles divide evenly across shards."""
    u, v = pixel_coords(image_width, image_height, dtype=dtype)
    n_pix = image_width * image_height
    tiles_total = -(-n_pix // tile_size)
    tiles_total = -(-tiles_total // n_tile_shards) * n_tile_shards
    pad = tiles_total * tile_size - n_pix
    # Padding pixels render the (0,0) film corner; their output is dropped.
    return jnp.pad(u, (0, pad)), jnp.pad(v, (0, pad)), tiles_total, pad


@partial(jax.jit, static_argnames=("mesh", "image_width", "image_height",
                                   "n_samples", "tile_size", "max_depth",
                                   "tmin", "remat", "compact",
                                   "samples_per_pass", "persistent",
                                   "recorded", "reduce_mean"))
def _sharded_radiance(scene: Scene, cam: Camera, key: jax.Array, *,
                      mesh: Mesh, image_width: int, image_height: int,
                      n_samples: int, tile_size: int, max_depth: int,
                      tmin: float, remat: bool, compact: bool = False,
                      samples_per_pass: int = 1,
                      persistent: bool = False,
                      recorded: bool = False,
                      sample_offset=0,
                      reduce_mean: bool = True) -> jnp.ndarray:
    dtype = cam.origin.dtype
    n_tile_shards = mesh.shape[TILES_AXIS]
    n_sample_shards = mesh.shape[SAMPLES_AXIS]
    if n_samples % n_sample_shards != 0:
        raise ValueError(f"n_samples={n_samples} must divide evenly over "
                         f"{n_sample_shards} sample shards")
    local_spp = n_samples // n_sample_shards

    u, v, tiles_total, _ = _padded_coords(image_width, image_height, tile_size,
                                          n_tile_shards, dtype)
    tiles_per_shard = tiles_total // n_tile_shards
    f32_w = float(np.float32(image_width))
    f32_h = float(np.float32(image_height))

    def shard_fn(scene, cam, key, u_loc, v_loc):
        tile_shard = jax.lax.axis_index(TILES_AXIS)
        sample_shard = jax.lax.axis_index(SAMPLES_AXIS)
        # Global first-sample id of this shard: the caller's offset (spp-
        # chunked checkpointing renders chunk c at offset c*spp_chunk so the
        # union over chunks is sample-exact) plus the sample-shard offset.
        shard_offset = sample_offset + sample_shard * local_spp

        u_tiles = u_loc.reshape(tiles_per_shard, tile_size)
        v_tiles = v_loc.reshape(tiles_per_shard, tile_size)

        def tile_body(i, acc):
            # Global tile id ⇒ device-count-invariant RNG streams.
            global_tile = tile_shard * tiles_per_shard + i
            tile_key = rng.purpose_key(key, rng.PIXEL_JITTER + 0x10, global_tile)
            tile_sum = render_tile_sum(scene, cam, u_tiles[i], v_tiles[i],
                                       tile_key, local_spp, shard_offset,
                                       max_depth, tmin, remat, f32_w, f32_h,
                                       compact, samples_per_pass, persistent,
                                       recorded=recorded)
            return jax.lax.dynamic_update_slice(acc, tile_sum[None], (i, 0, 0))

        acc = jax.lax.fori_loop(
            0, tiles_per_shard, tile_body,
            jnp.zeros((tiles_per_shard, tile_size, 3), dtype))
        # Reduce the sample axis: one psum, the only cross-device comm.
        acc = jax.lax.psum(acc, SAMPLES_AXIS)
        return acc.reshape(tiles_per_shard * tile_size, 3)

    out = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(TILES_AXIS), P(TILES_AXIS)),
        out_specs=P(TILES_AXIS),
        check_vma=False,
    )(scene, cam, key, u, v)
    n_pix = image_width * image_height
    out = out[:n_pix].reshape(image_height, image_width, 3)
    return out / n_samples if reduce_mean else out


def render_radiance_sharded(scene: Scene, cam: Camera, image_width: int = 400,
                            n_samples: int = 1, *, mesh: Mesh,
                            image_height: int | None = None,
                            tile_size: int = DEFAULT_TILE,
                            max_depth: int = DEFAULT_MAX_DEPTH,
                            tmin: float = DEFAULT_TMIN,
                            seed: int | jax.Array = 0,
                            remat: bool = False, compact: bool = False,
                            persistent: bool = False,
                            rays_per_pass: int | None = None,
                            recorded: bool = False,
                            sample_offset: int = 0,
                            reduce_mean: bool = True
                            ) -> jnp.ndarray:
    """Mesh-sharded linear radiance ``[H,W,3]`` — the multi-chip ``render``.

    ``compact``/``rays_per_pass`` mirror the single-chip driver: forward-only
    active-ray compaction and merged pixels-x-samples wavefronts per shard.
    ``sample_offset``/``reduce_mean=False`` serve the spp-chunked checkpoint
    driver (utils/checkpoint.render_checkpointed_sharded): chunk c renders
    global samples [offset, offset+n) and returns the radiance SUM so chunks
    accumulate sample-exactly.
    """
    H = image_height if image_height is not None else image_height_for(image_width)
    key = seed if isinstance(seed, jax.Array) and jnp.issubdtype(seed.dtype, jax.dtypes.prng_key) \
        else jax.random.PRNGKey(seed)
    spp_pass = 1
    if rays_per_pass is not None:
        from ..render import pick_samples_per_pass
        local_spp = n_samples // max(mesh.shape[SAMPLES_AXIS], 1)
        spp_pass = pick_samples_per_pass(tile_size, max(local_spp, 1), rays_per_pass)
    return _sharded_radiance(scene, cam, key, mesh=mesh, image_width=image_width,
                             image_height=H, n_samples=n_samples,
                             tile_size=tile_size, max_depth=max_depth,
                             tmin=tmin, remat=remat, compact=compact,
                             samples_per_pass=spp_pass, persistent=persistent,
                             recorded=recorded,
                             sample_offset=sample_offset,
                             reduce_mean=reduce_mean)


def sharded_train_step(scene: Scene, cam: Camera, target: jnp.ndarray,
                       image_width: int, n_samples: int, *, mesh: Mesh,
                       lr: float = 0.01, tile_size: int = DEFAULT_TILE,
                       seed: int | jax.Array = 0,
                       grad_mode: str = "recorded"
                       ) -> tuple[jnp.ndarray, Scene]:
    """One sharded inverse-rendering SGD step.

    Forward renders the sharded image, computes an MSE loss against ``target``,
    and backprops through the shard_map — the scene-parameter gradients are
    all-reduced across shards by the shard_map transpose (north-star gradient
    path). Returns ``(loss, updated_scene)``. Each shard tile runs the XLA
    recorded integrator (ops/grad_trace.py), the only ``grad_mode``.
    """
    from ..grad import DIFF_FIELDS

    if grad_mode != "recorded":
        raise ValueError(f"unknown grad_mode {grad_mode!r}")

    def loss_fn(diff_params):
        s = scene._replace(**diff_params)
        # The recorded custom VJPs compose with the shard_map transpose —
        # each shard replays its own paths, and the scene cotangents are
        # all-reduced exactly as before.
        img = render_radiance_sharded(s, cam, image_width, n_samples, mesh=mesh,
                                      image_height=target.shape[0],
                                      tile_size=tile_size, seed=seed,
                                      recorded=True)
        return jnp.mean((img - target) ** 2)

    params = {f: getattr(scene, f) for f in DIFF_FIELDS}
    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params = {f: params[f] - lr * grads[f] for f in DIFF_FIELDS}
    return loss, scene._replace(**new_params)
