"""On-device benchmark of the DIFFERENTIABLE path at flagship scale.

This driver times ``jax.value_and_grad`` of an image loss through the full
wavefront integrator on the flagship scene (reference analog: the role of
src/proto/proto.jl:196-234 for the backward pass, which the reference does
not have at all) and appends JSON records to ``bench_history.jsonl``.

Configurations compared:
- the recorded path (ops/grad_trace.py, the default) chunked or whole-image,
  and its staged variant;
- remat on/off (jax.checkpoint of the bounce body: recompute vs stash), with
  and without dead-tile skipping.

Throughput metric: paths/s where paths = W*H*spp per gradient step (the same
unit as the forward bench, so fwd/bwd ratios are read off directly).

Usage:  python scripts/grad_bench.py [--width 1920] [--spp 1] [--quick]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--quick", action="store_true",
                    help="only the best-known config, one repeat")
    ap.add_argument("--config", default=None,
                    help="run only this config name (fresh-process isolation:"
                         " a device left RESOURCE_EXHAUSTED by one config "
                         "poisons every later one in the same process)")
    ap.add_argument("--canary", action="store_true",
                    help="run the once-per-session twin-AD corruption canary "
                         "(recorded vs remat on a small config) and exit")
    args = ap.parse_args()

    from raytracingweekend_jl_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu.grad import render_grads
    from raytracingweekend_jl_tpu.render import image_height_for, render_radiance
    from raytracingweekend_jl_tpu.utils.metrics import append_history

    W = args.width
    H = image_height_for(W)
    spp = args.spp
    scene = rtw.scene_random_spheres(seed=1)
    cam = rtw.t_cam1()

    if args.canary:
        # Once-per-session corruption canary: the recorded integrator and
        # the remat XLA transpose must agree on a small config up to MC
        # noise. Raises (exit 3) on corruption.
        from raytracingweekend_jl_tpu.grad import (GradSanityError,
                                                   twin_ad_canary)
        try:
            twin_ad_canary(scene, cam, width=256, n_samples=8)
        except GradSanityError as e:
            print(json.dumps({"canary": "FAIL", "error": str(e)[:300]}),
                  flush=True)
            sys.exit(3)
        print(json.dumps({"canary": "PASS", "width": 256, "spp": 8,
                          "device": str(jax.devices()[0])}), flush=True)
        return

    # Fixed target: the forward render the loss compares against (kept on
    # device; not part of the timed region).
    target = render_radiance(scene, cam, W, 1, seed=123, persistent=True)
    target = jax.block_until_ready(target)
    # Perturbed scene so gradients are non-trivial.
    bad = scene._replace(albedo=jnp.clip(scene.albedo * 0.8, 0, 1))

    configs = [
        # The no-flags default render_loss resolves on its own (the XLA
        # recorded path, auto-chunked to fit device memory).
        ("default_auto", dict(remat=None)),
        ("recorded_chunk512k",
         dict(remat=False, recorded=True, pixel_chunk=1 << 19)),
        ("recorded_full",
         dict(remat=False, recorded=True, pixel_chunk=None)),
        ("staged_b4_div4_chunk1m",
         dict(remat=False, recorded=True, pixel_chunk=1 << 20,
              recorded_stage=(4, 4))),
        ("remat_chunk512k", dict(remat=True, recorded=False, pixel_chunk=1 << 19)),
        ("remat_tileskip_chunk512k",
         dict(remat=True, recorded=False, pixel_chunk=1 << 19, tile_skip=16384)),
        ("noremat_chunk256k", dict(remat=False, recorded=False, pixel_chunk=1 << 18)),
    ]
    if args.quick:
        configs = configs[:1]
    if args.config:
        configs = [c for c in configs if c[0] == args.config]
        if not configs:
            raise SystemExit(f"unknown config {args.config}")

    paths = W * H * spp
    hist_path = os.path.join(os.path.dirname(__file__), "..",
                             "bench_history.jsonl")
    from raytracingweekend_jl_tpu.grad import (render_loss, _params_of,
                                               _with_params)

    for name, kw in configs:
        remat = kw.pop("remat")
        try:
            # One jitted program per step (value_and_grad over ALL chunks +
            # loss glue). Seed is a traced argument so repeats reuse the
            # compiled program.
            def f(params, seed, kw=kw, remat=remat):
                extra = {} if remat is None else {"remat": remat}
                return render_loss(_with_params(bad, params), cam, target, W,
                                   spp, seed=seed, **extra, **kw)

            step = jax.jit(jax.value_and_grad(f))
            p0 = _params_of(bad)
            t0 = time.perf_counter()
            loss, grads = jax.block_until_ready(step(p0, jnp.int32(7)))
            warm_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            loss, grads = jax.block_until_ready(step(p0, jnp.int32(8)))
            steady_s = time.perf_counter() - t0
            g1 = float(np.asarray(grads.albedo).sum())
            # Sanity tripwire: a corrupted row (non-finite / blown
            # magnitude) must FAIL the run, not sit in the JSONL.
            from raytracingweekend_jl_tpu.grad import (GradSanityError,
                                                       check_grads_sane)
            check_grads_sane(grads, loss)

            # DEVICE per-step time via the in-dispatch slope (config_bench's
            # device_iter_s methodology): wall includes a fixed host
            # dispatch+fetch round trip, which real training amortizes
            # (fit_scene_scan). Scan K steps over distinct seeds inside one
            # program; slope (t_2K - t_K)/K is device time per step.
            def stepk(params, k):
                def body(c, seed):
                    l, g = jax.value_and_grad(f)(params, seed)
                    s = l + sum(jnp.sum(v) for v in
                                jax.tree.leaves(g)
                                if jnp.issubdtype(v.dtype, jnp.floating))
                    return c + s, None
                out, _ = jax.lax.scan(
                    body, jnp.float32(0),
                    jnp.arange(10, 10 + k, dtype=jnp.int32))
                return out

            device_step_s = None
            try:
                k1, k2 = 2, 4
                f1 = jax.jit(stepk, static_argnums=1)
                float(f1(p0, k1))
                t0 = time.time()
                float(f1(p0, k1))
                ta = time.time() - t0
                float(f1(p0, k2))
                t0 = time.time()
                float(f1(p0, k2))
                tb = time.time() - t0
                device_step_s = max(tb - ta, 1e-9) / (k2 - k1)
            except Exception:  # noqa: BLE001 — OOM at K steps: skip field
                pass

            rec = {"ts": time.time(),
                   "label": f"grad_step_{name}_{W}x{H}x{spp}",
                   "wall_s": round(steady_s, 3), "paths": paths,
                   "mpaths_per_s": round(paths / steady_s / 1e6, 3),
                   "loss": float(loss), "grad_albedo_sum": g1,
                   "warm_s": round(warm_s, 1),
                   "device": str(jax.devices()[0])}
            if device_step_s is not None:
                rec["device_step_s"] = round(device_step_s, 4)
                rec["device_mpaths_per_s"] = round(
                    paths / device_step_s / 1e6, 3)
        except Exception as e:  # noqa: BLE001 — OOM/compile faults per config
            rec = {"ts": time.time(),
                   "label": f"grad_step_{name}_{W}x{H}x{spp}",
                   "error": repr(e)[:300]}
        append_history(rec, hist_path)
        print(json.dumps(rec), flush=True)
        if "GradSanityError" in rec.get("error", ""):
            sys.exit(3)  # corrupted gradients: fail the whole run loudly


if __name__ == "__main__":
    main()
