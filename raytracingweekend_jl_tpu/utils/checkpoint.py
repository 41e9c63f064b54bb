"""Checkpoint / resume for long renders.

The reference renders monolithically in memory — a crash loses everything
(reference: src/render.jl:15-43; SURVEY.md §5 'Checkpoint: None'). Here the
sample dimension is chunked: after every chunk the accumulated *radiance sum*
and the number of completed samples are snapshotted to ``.npz``; resuming
continues the spp loop from the next chunk. Because global sample indices key
the RNG streams (render.py) and passes start at multiples of
``samples_per_pass``, a resumed render is sample-exact: interrupt at any chunk
boundary and — for the same ``spp_chunk``/``rays_per_pass`` — the final image
is identical to an uninterrupted chunked run.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..camera import Camera
from ..render import (render_tile_sum, pixel_coords, image_height_for,
                      pick_samples_per_pass)
from ..scene import Scene
from .metrics import PhaseTimer


@dataclass
class RenderState:
    """Accumulated render progress: sum of per-sample radiance + count."""

    radiance_sum: np.ndarray  # [H, W, 3] float64 accumulation on host
    samples_done: int
    image_width: int
    image_height: int
    seed: int

    @property
    def image(self) -> np.ndarray:
        """Current mean-radiance estimate (linear)."""
        return self.radiance_sum / max(self.samples_done, 1)


def save_state(state: RenderState, path: str) -> None:
    tmp = path + ".tmp"
    np.savez(tmp if tmp.endswith(".npz") else tmp,
             radiance_sum=state.radiance_sum,
             samples_done=state.samples_done,
             image_width=state.image_width,
             image_height=state.image_height,
             seed=state.seed)
    # numpy appends .npz to names without it
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def load_state(path: str) -> RenderState:
    z = np.load(path)
    return RenderState(radiance_sum=z["radiance_sum"],
                       samples_done=int(z["samples_done"]),
                       image_width=int(z["image_width"]),
                       image_height=int(z["image_height"]),
                       seed=int(z["seed"]))


def render_checkpointed(scene: Scene, cam: Camera, image_width: int,
                        n_samples: int, *, image_height: int | None = None,
                        seed: int = 0, spp_chunk: int = 50,
                        checkpoint_path: str | None = None,
                        max_depth: int = 16, tmin: float = 1e-4,
                        compact: bool = False, persistent: bool = True,
                        rays_per_pass: int = 1 << 21,
                        progress: bool = False, max_retries: int = 2,
                        timer: PhaseTimer | None = None) -> RenderState:
    """Render ``n_samples`` in chunks of ``spp_chunk``, checkpointing after each.

    If ``checkpoint_path`` exists, resumes from it. Sample-exact: chunk c
    renders global samples [c*spp_chunk, ...) with RNG keyed on the global
    sample index, so the union over chunks equals one long uninterrupted render.

    Failure handling (SURVEY.md §5: the reference has none — a crash kills the
    render): each chunk is retried up to ``max_retries`` times on transient
    device/runtime errors; committed chunks are already durable on disk, so
    the blast radius of any failure is one chunk.

    ``timer`` (per-phase observability, SURVEY.md §5): when given, trace
    dispatch, the device->host radiance fetch, and checkpoint writes are
    accumulated per phase, and each progress line carries the running totals.
    """
    H = image_height if image_height is not None else image_height_for(image_width)
    W = image_width

    if checkpoint_path and os.path.exists(checkpoint_path):
        state = load_state(checkpoint_path)
        if (state.image_width, state.image_height, state.seed) != (W, H, seed):
            raise ValueError("checkpoint does not match render configuration")
    else:
        state = RenderState(np.zeros((H, W, 3)), 0, W, H, seed)

    u, v = pixel_coords(W, H, dtype=cam.origin.dtype)
    key = jax.random.PRNGKey(seed)
    f32_w, f32_h = float(np.float32(W)), float(np.float32(H))

    tile_sum = jax.jit(render_tile_sum,
                       static_argnames=("n_samples", "max_depth", "tmin", "remat",
                                        "f32_w", "f32_h", "compact",
                                        "samples_per_pass", "persistent"))

    if timer is None:
        timer = PhaseTimer()
    # Dispatch and fetch are serial: each chunk's radiance comes back to the
    # host as f32 and is accumulated in f64 before the checkpoint is written,
    # so fetch cost per path shrinks linearly with spp_chunk.
    while state.samples_done < n_samples:
        todo = min(spp_chunk, n_samples - state.samples_done)
        spp_pass = pick_samples_per_pass(W * H, todo, rays_per_pass)
        t0 = time.time()
        for attempt in range(max_retries + 1):
            try:
                timer.start("trace")
                acc = tile_sum(scene, cam, u, v, key, n_samples=todo,
                               sample_offset=state.samples_done,
                               max_depth=max_depth, tmin=tmin, remat=False,
                               f32_w=f32_w, f32_h=f32_h, compact=compact,
                               samples_per_pass=spp_pass, persistent=persistent)
                timer.stop("trace")
                timer.start("fetch")  # host fetch = the true device sync
                acc = np.asarray(acc).astype(np.float64).reshape(H, W, 3)
                timer.stop("fetch")
                break
            except Exception as e:  # noqa: BLE001 — device faults are opaque
                for ph in ("trace", "fetch"):
                    timer.discard(ph)  # drop the failed attempt's timer
                if attempt >= max_retries:
                    raise
                if progress:
                    print(json.dumps({"retry": attempt + 1,
                                      "chunk_offset": state.samples_done,
                                      "error": repr(e)[:200]}), flush=True)
        dt = time.time() - t0
        state.radiance_sum = state.radiance_sum + acc
        state.samples_done += todo
        if checkpoint_path:
            timer.start("checkpoint")
            save_state(state, checkpoint_path)
            timer.stop("checkpoint")
        if progress:
            paths = W * H * todo
            print(json.dumps({"samples_done": state.samples_done,
                              "chunk_s": round(dt, 3),
                              "paths_per_s": round(paths / dt, 1),
                              "phases": timer.as_dict()}), flush=True)
    return state


@dataclass
class StripState:
    """Per-process accumulated progress of a SHARDED checkpointed render:
    this host's pixel strip of the radiance sum + completed sample count.
    Single-process meshes hold the whole image (start=0, stop=H*W)."""

    strip_sum: np.ndarray  # [stop-start, 3] float64 host accumulation
    start: int             # first global pixel id of the strip
    stop: int              # one past the last global pixel id
    samples_done: int
    image_width: int
    image_height: int
    seed: int
    spp_chunk: int = 0     # chunking the accumulation was made with
    tile_size: int = 0     # mesh tile size (strip layout depends on it)

    @property
    def strip_image(self) -> np.ndarray:
        """This host's strip of the current mean-radiance estimate."""
        return self.strip_sum / max(self.samples_done, 1)

    @property
    def image(self) -> np.ndarray:
        """Full [H, W, 3] mean radiance — only when this process holds the
        whole image (single-process mesh)."""
        n_pix = self.image_height * self.image_width
        if (self.start, self.stop) != (0, n_pix):
            raise ValueError(
                f"process holds pixels [{self.start}, {self.stop}) of "
                f"{n_pix}; assemble per-host strips instead (see "
                "parallel.multihost.write_host_strip/assemble_strips)")
        return (self.strip_sum / max(self.samples_done, 1)).reshape(
            self.image_height, self.image_width, 3)


def _strip_ckpt_path(path: str) -> str:
    """Per-process checkpoint file: process 0 keeps the caller's name (the
    single-process flow stays one file); others get a .pNNNNN suffix."""
    import jax
    idx = jax.process_index()
    return path if idx == 0 else f"{path}.p{idx:05d}"


def save_strip_state(state: StripState, path: str) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, strip_sum=state.strip_sum, start=state.start,
             stop=state.stop, samples_done=state.samples_done,
             image_width=state.image_width, image_height=state.image_height,
             seed=state.seed, spp_chunk=state.spp_chunk,
             tile_size=state.tile_size)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_strip_state(path: str) -> StripState:
    z = np.load(path)
    return StripState(strip_sum=z["strip_sum"], start=int(z["start"]),
                      stop=int(z["stop"]),
                      samples_done=int(z["samples_done"]),
                      image_width=int(z["image_width"]),
                      image_height=int(z["image_height"]),
                      seed=int(z["seed"]),
                      spp_chunk=(int(z["spp_chunk"])
                                 if "spp_chunk" in z.files else 0),
                      tile_size=(int(z["tile_size"])
                                 if "tile_size" in z.files else 0))


def render_checkpointed_sharded(scene: Scene, cam: Camera, image_width: int,
                                n_samples: int, *, mesh,
                                image_height: int | None = None,
                                seed: int = 0, spp_chunk: int = 50,
                                checkpoint_path: str | None = None,
                                tile_size: int | None = None,
                                max_depth: int = 16, tmin: float = 1e-4,
                                persistent: bool = False,
                                rays_per_pass: int | None = None,
                                progress: bool = False, max_retries: int = 2,
                                timer: PhaseTimer | None = None
                                ) -> StripState:
    """Checkpoint/resume COMPOSED with the mesh-sharded driver (SURVEY.md §5
    'restartable from tile checkpoint': a large render must both shard and
    resume).

    Renders ``n_samples`` in spp chunks through
    ``parallel.shard.render_radiance_sharded`` (pixel tiles x sample shards
    over ``mesh``), accumulating each chunk's radiance SUM on the host and
    snapshotting after every chunk. Sample-exact like the single-device
    driver: chunk c renders global samples [c*spp_chunk, ...) with RNG keyed
    on the global sample index, so interrupt + resume equals one
    uninterrupted chunked run bitwise (same spp_chunk).

    Multi-process: each process accumulates and snapshots only ITS OWN
    pixel strip (host-local shard data — no cross-host gather, no image
    traffic between hosts); process 0's file keeps ``checkpoint_path``
    verbatim, process i>0 appends ``.p0000i``. Resume loads each process's own file. Every
    chunk's spp must divide the mesh's sample axis, so ``spp_chunk`` and
    the final partial chunk must both be multiples of it.
    """
    import jax
    from ..parallel.shard import render_radiance_sharded, DEFAULT_TILE
    from ..parallel.multihost import local_strip
    from ..parallel.mesh import SAMPLES_AXIS

    H = (image_height if image_height is not None
         else image_height_for(image_width))
    W = image_width
    n_pix = H * W
    tile_size = DEFAULT_TILE if tile_size is None else tile_size
    n_sample_shards = mesh.shape[SAMPLES_AXIS]
    if spp_chunk % n_sample_shards or n_samples % n_sample_shards:
        raise ValueError(
            f"spp_chunk={spp_chunk} and n_samples={n_samples} must both be "
            f"multiples of the mesh sample axis ({n_sample_shards})")

    ckpt = _strip_ckpt_path(checkpoint_path) if checkpoint_path else None
    state: StripState | None = None
    if ckpt and os.path.exists(ckpt):
        state = load_strip_state(ckpt)
        if (state.image_width, state.image_height,
                state.seed) != (W, H, seed):
            raise ValueError("checkpoint does not match render configuration")
        # The bitwise-resume contract requires the SAME chunking (RNG is
        # keyed per chunk offset) and tile layout; catching it up front
        # beats one wasted chunk + a strip-layout error.
        if state.spp_chunk and state.spp_chunk != spp_chunk:
            raise ValueError(
                f"checkpoint was written with spp_chunk="
                f"{state.spp_chunk}, resume requested {spp_chunk} — "
                "sample-exact resume requires the same chunking")
        if state.tile_size and state.tile_size != tile_size:
            raise ValueError(
                f"checkpoint was written with tile_size="
                f"{state.tile_size}, resume requested {tile_size}")
    if jax.process_count() > 1:
        # Cross-host agreement on samples_done: a job
        # killed between one host's chunk save and another's — or a lost
        # .pNNNNN file — leaves skewed counts; without this check the
        # first sharded render would run with MISMATCHED sample_offsets
        # (silently double-accumulating on the ahead host) and then hang
        # in a collective the other host never joins. Fail loudly with
        # the counts instead; the fix is deleting the ahead host's file
        # (its extra chunk cannot be subtracted).
        from jax.experimental import multihost_utils
        done0 = 0 if state is None else state.samples_done
        all_done = np.asarray(multihost_utils.process_allgather(
            jnp.asarray([done0], jnp.int32))).reshape(-1)
        if not (all_done == all_done[0]).all():
            raise ValueError(
                "per-process checkpoints disagree on samples_done: "
                f"{all_done.tolist()} — delete the ahead process's "
                "checkpoint file(s) down to the minimum and re-resume")

    if timer is None:
        timer = PhaseTimer()
    while state is None or state.samples_done < n_samples:
        done = 0 if state is None else state.samples_done
        todo = min(spp_chunk, n_samples - done)
        for attempt in range(max_retries + 1):
            try:
                timer.start("trace")
                acc = render_radiance_sharded(
                    scene, cam, W, todo, mesh=mesh, image_height=H,
                    tile_size=tile_size, max_depth=max_depth, tmin=tmin,
                    seed=seed, persistent=persistent,
                    rays_per_pass=rays_per_pass,
                    sample_offset=done, reduce_mean=False)
                timer.stop("trace")
                timer.start("fetch")  # host fetch = the true device sync
                start, stop, strip = local_strip(acc, H, W, tile_size)
                timer.stop("fetch")
                break
            except Exception as e:  # noqa: BLE001 — device faults are opaque
                for ph in ("trace", "fetch"):
                    timer.discard(ph)
                if attempt >= max_retries:
                    raise
                if progress:
                    print(json.dumps({"retry": attempt + 1,
                                      "chunk_offset": done,
                                      "error": repr(e)[:200]}), flush=True)
        if state is None:
            state = StripState(np.zeros((stop - start, 3)), start, stop,
                               0, W, H, seed, spp_chunk, tile_size)
        elif (start, stop) != (state.start, state.stop):
            raise ValueError(
                f"strip layout changed across chunks/resume: checkpoint "
                f"holds [{state.start}, {state.stop}), this chunk produced "
                f"[{start}, {stop}) — keep mesh/tile_size fixed")
        state.strip_sum = state.strip_sum + strip.astype(np.float64)
        state.samples_done = done + todo
        if ckpt:
            timer.start("checkpoint")
            save_strip_state(state, ckpt)
            timer.stop("checkpoint")
            if jax.process_count() > 1:
                # Barrier after every save: bounds cross-host checkpoint
                # skew to the (tiny) save-to-barrier window instead of a
                # whole chunk.
                from jax.experimental import multihost_utils
                multihost_utils.sync_global_devices(
                    f"rtw_ckpt_chunk_{state.samples_done}")
        if progress:
            print(json.dumps({"samples_done": state.samples_done,
                              "strip": [state.start, state.stop],
                              "proc": jax.process_index(),
                              "phases": timer.as_dict()}), flush=True)
    return state
