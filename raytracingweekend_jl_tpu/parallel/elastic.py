"""Elastic tile scheduler: concurrent per-device dispatch, retry, quarantine.

The reference dies with its process on any fault (SURVEY.md §5 "Failure
detection: None"; a crash loses the whole fork-join render,
src/render.jl:23-42). The sample-axis story here is chunk retry + durable
checkpoints (utils/checkpoint.py). This module adds the *pixel-axis* story
SURVEY §5 marks as the stretch goal: the image is decomposed into independent
pixel tiles; one worker thread per device pulls tiles from a shared queue —
so N healthy devices render N tiles concurrently (in-flight work is bounded
at one tile per device), a transient tile failure retries on whichever device
next picks it up, and a device that keeps failing is quarantined (its worker
exits; pending tiles drain through the healthy survivors). The render
completes as long as one device stays alive.

Contrast with parallel/shard.py: the shard_map driver is ONE jitted program
over the whole mesh — maximal throughput, but a single device fault kills
the step. The elastic driver trades a little dispatch overhead for fault
isolation; use it for long unattended renders on flaky capacity. RNG streams
are keyed by global tile id exactly like the shard driver, so the image is
bit-identical no matter which device ends up rendering which tile, how the
workers interleave, or how many retries happened (tests/test_elastic.py
asserts both the concurrency speedup and the bitwise invariance).
"""

from __future__ import annotations

import json
import threading
import time

import jax
import numpy as np
import jax.numpy as jnp

from .. import rng
from ..camera import Camera
from ..render import (render_tile_sum, pixel_coords, image_height_for)
from ..scene import Scene

#: Consecutive failures on one device before it is quarantined.
DEVICE_FAILURE_LIMIT = 2


def _run_tile(scene, cam, u_t, v_t, tile_key, n_samples, max_depth, tmin,
              f32_w, f32_h, device):
    """One tile on one explicit device (compute follows committed inputs)."""
    put = lambda x: jax.device_put(x, device)
    acc = render_tile_sum(jax.tree.map(put, scene), jax.tree.map(put, cam),
                          put(u_t), put(v_t), put(tile_key), n_samples, 0,
                          max_depth, tmin, False, f32_w, f32_h)
    return np.asarray(acc)  # host fetch surfaces device faults here



def _elastic_schedule(devices, n_tiles: int, run_tile, on_result,
                      max_retries: int, emit) -> None:
    """THE elastic scheduler, shared by the render and training drivers.

    One worker thread per device pulls tile ids from a shared queue;
    ``run_tile(t_id, device)`` does the work (raising on device faults),
    ``on_result(t_id, result)`` commits it (tile-indexed sinks need no
    lock). A transient failure re-queues the tile for any healthy worker;
    ``DEVICE_FAILURE_LIMIT`` consecutive failures quarantine the device
    (its worker exits, pending work drains through survivors). Raises the
    offending error when a tile exhausts ``max_retries`` on a healthy
    device, or RuntimeError when no healthy device remains.
    """
    queue = list(range(n_tiles))
    attempts: dict[int, int] = {}
    fail_streak: dict = {d: 0 for d in devices}
    fatal: list[BaseException] = []
    in_progress = 0
    cond = threading.Condition()

    def worker(dev) -> None:
        nonlocal in_progress
        while True:
            with cond:
                while not queue and in_progress > 0 and not fatal:
                    cond.wait(0.05)
                if fatal or not queue:
                    return  # done, or another worker hit a fatal error
                t_id = queue.pop(0)
                in_progress += 1
            t0 = time.time()
            try:
                result = run_tile(t_id, dev)
            except Exception as e:  # noqa: BLE001 — device faults are opaque
                with cond:
                    in_progress -= 1
                    attempts[t_id] = attempts.get(t_id, 0) + 1
                    fail_streak[dev] += 1
                    quarantined = fail_streak[dev] >= DEVICE_FAILURE_LIMIT
                    if not quarantined and attempts[t_id] > max_retries:
                        fatal.append(e)  # retries exhausted, healthy device
                    else:
                        queue.append(t_id)  # re-dispatch (any healthy worker)
                        emit({"tile": t_id, "retry": attempts[t_id],
                              "error": repr(e)[:120]})
                    cond.notify_all()
                if quarantined:
                    emit({"quarantined": str(dev)})
                    return
                if fatal:
                    return
                continue
            on_result(t_id, result)
            with cond:
                in_progress -= 1
                fail_streak[dev] = 0
                cond.notify_all()
            emit({"tile": t_id, "device": str(dev),
                  "s": round(time.time() - t0, 3)})

    threads = [threading.Thread(target=worker, args=(d,), daemon=True)
               for d in devices]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    if fatal:
        raise fatal[0]
    if queue:
        raise RuntimeError("no healthy devices left for the elastic run")


def render_radiance_elastic(scene: Scene, cam: Camera, image_width: int = 400,
                            n_samples: int = 1, *, image_height: int | None = None,
                            tile_size: int = 8192, seed: int = 0,
                            max_depth: int = 16, tmin: float = 1e-4,
                            devices=None, max_retries: int = 2,
                            progress: bool = False) -> jnp.ndarray:
    """Fault-isolated mean radiance ``[H,W,3]``, tiles fanned out over devices.

    Every tile is retried up to ``max_retries`` times; a device accumulating
    ``DEVICE_FAILURE_LIMIT`` consecutive failures is dropped and its pending
    work drains through the remaining devices. Raises only when no healthy
    device remains or a tile exhausts retries on a healthy device.
    """
    from ..scene import trim_scene
    scene = trim_scene(scene)
    H = image_height if image_height is not None else image_height_for(image_width)
    W = image_width
    n_pix = W * H
    u, v = pixel_coords(W, H, dtype=cam.origin.dtype)
    n_tiles = -(-n_pix // tile_size)
    pad = n_tiles * tile_size - n_pix
    u = jnp.pad(u, (0, pad))
    v = jnp.pad(v, (0, pad))
    key = jax.random.PRNGKey(seed)
    f32_w, f32_h = float(np.float32(W)), float(np.float32(H))

    devices = list(devices if devices is not None else jax.devices())
    out = np.zeros((n_tiles * tile_size, 3), np.float64)

    def emit(rec: dict) -> None:
        if progress:
            print(json.dumps(rec), flush=True)

    def run_tile(t_id, dev):
        sl = slice(t_id * tile_size, (t_id + 1) * tile_size)
        # Same stream derivation as parallel/shard.py: the GLOBAL tile id
        # keys the tile, so placement/interleaving/retries never change
        # the image.
        tile_key = rng.purpose_key(key, rng.PIXEL_JITTER + 0x10, t_id)
        return _run_tile(scene, cam, u[sl], v[sl], tile_key, n_samples,
                         max_depth, tmin, f32_w, f32_h, dev)

    def on_result(t_id, acc):
        sl = slice(t_id * tile_size, (t_id + 1) * tile_size)
        out[sl] = acc  # disjoint slices: no lock needed for the write

    _elastic_schedule(devices, n_tiles, run_tile, on_result, max_retries,
                      emit)
    return jnp.asarray((out[:n_pix] / n_samples).reshape(H, W, 3),
                       cam.origin.dtype)


def _run_tile_grad(scene, cam, u_t, v_t, tile_key, target_t, valid_t,
                   n_samples, max_depth, tmin, f32_w, f32_h,
                   device, grad_kwargs):
    """One tile's (SSE, scene-gradient) on one explicit device.

    Gradient integrator per tile: the XLA recorded path (ops/grad_trace.py);
    ``grad_kwargs`` overrides."""
    from ..grad import DIFF_FIELDS

    if grad_kwargs is None:
        grad_kwargs = dict(recorded=True)
    put = lambda x: jax.device_put(x, device)
    scene_d = jax.tree.map(put, scene)
    params = {f: getattr(scene_d, f) for f in DIFF_FIELDS}

    def tile_sse(p):
        s = scene_d._replace(**p)
        acc = render_tile_sum(s, jax.tree.map(put, cam), put(u_t), put(v_t),
                              put(tile_key), n_samples, 0, max_depth, tmin,
                              False, f32_w, f32_h, **grad_kwargs)
        img = acc / n_samples
        return jnp.sum(((img - put(target_t)) ** 2) * put(valid_t)[:, None])

    sse, grads = jax.value_and_grad(tile_sse)(params)
    # Host fetch surfaces device faults here (same contract as _run_tile).
    return float(np.asarray(sse)), {k: np.asarray(v) for k, v in grads.items()}


def elastic_train_step(scene: Scene, cam: Camera, target, image_width: int,
                       n_samples: int, *, lr: float = 0.01,
                       tile_size: int = 8192, seed: int = 0,
                       max_depth: int = 16, tmin: float = 1e-4,
                       devices=None, max_retries: int = 2,
                       grad_kwargs: dict | None = None,
                       progress: bool = False):
    """Fault-isolated inverse-rendering SGD step (``sharded_train_step`` is
    one jitted mesh program — any device fault kills the step).

    The image loss decomposes exactly over pixel tiles
    (``mean((img-target)^2) = sum_tiles SSE_tile / (n_pix*3)``), so each
    tile's (SSE, scene-gradient) is an independent work item on the elastic
    scheduler: per-device worker threads, transient-fault retry, device
    quarantine — the step completes as long as one device stays alive.
    Per-tile results land in tile-indexed slots and reduce in FIXED tile
    order, so loss and gradients are bit-identical regardless of placement,
    interleaving, or retries (same determinism contract as
    :func:`render_radiance_elastic`). Returns ``(loss, updated_scene)``
    exactly like ``sharded_train_step``.
    """
    from ..grad import DIFF_FIELDS
    from ..scene import trim_scene

    scene = trim_scene(scene)
    H = (image_height_for(image_width) if np.ndim(target) != 3
         else target.shape[0])
    W = image_width
    n_pix = W * H
    u, v = pixel_coords(W, H, dtype=cam.origin.dtype)
    n_tiles = -(-n_pix // tile_size)
    pad = n_tiles * tile_size - n_pix
    u = jnp.pad(u, (0, pad))
    v = jnp.pad(v, (0, pad))
    target_flat = jnp.pad(jnp.asarray(target).reshape(n_pix, 3),
                          ((0, pad), (0, 0)))
    valid = jnp.pad(jnp.ones((n_pix,), cam.origin.dtype), (0, pad))
    key = jax.random.PRNGKey(seed)
    f32_w, f32_h = float(np.float32(W)), float(np.float32(H))

    devices = list(devices if devices is not None else jax.devices())
    sse_by_tile: list = [None] * n_tiles
    grads_by_tile: list = [None] * n_tiles

    def emit(rec: dict) -> None:
        if progress:
            print(json.dumps(rec), flush=True)

    def run_tile(t_id, dev):
        sl = slice(t_id * tile_size, (t_id + 1) * tile_size)
        tile_key = rng.purpose_key(key, rng.PIXEL_JITTER + 0x10, t_id)
        return _run_tile_grad(
            scene, cam, u[sl], v[sl], tile_key, target_flat[sl],
            valid[sl], n_samples, max_depth, tmin, f32_w, f32_h,
            dev, grad_kwargs)

    def on_result(t_id, res):
        sse_by_tile[t_id], grads_by_tile[t_id] = res  # tile-indexed slots

    _elastic_schedule(devices, n_tiles, run_tile, on_result, max_retries,
                      emit)
    if any(g is None for g in grads_by_tile):
        raise RuntimeError("no healthy devices left for elastic train step")

    # FIXED-order reduction: bitwise placement invariance.
    denom = float(n_pix * 3)
    loss = np.float32(np.sum(np.asarray(sse_by_tile, np.float32)) / denom)
    grads = {f: sum(g[f] for g in grads_by_tile) / np.float32(denom)
             for f in DIFF_FIELDS}
    new_scene = scene._replace(
        **{f: getattr(scene, f) - lr * jnp.asarray(grads[f])
           for f in DIFF_FIELDS})
    return jnp.asarray(loss), new_scene
