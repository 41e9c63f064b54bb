"""One Float64 flagship throughput row (reference methodology parity).

The reference's published benchmarks are Float64 end-to-end
(reference src/proto/proto.jl:15, README.md:81) while this framework's
headline is f32 — so the headline compares f32 against the reference's f64.
This script measures OUR f64 throughput on the flagship config so the
comparison can be stated in both precisions. The sweep kernel is f32-only,
so f64 rays take the plain XLA sweep (the GPU runs f64 natively, at a
fraction of its f32 rate).

Appends a ``flagship_f64_*`` row to bench_history.jsonl.

Usage: python scripts/f64_bench.py [--spp 4] [--chunks 2]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4,
                    help="samples per chunk (throughput is per-path; a few "
                         "spp amortize the dispatch round-trip)")
    ap.add_argument("--chunks", type=int, default=2)
    args = ap.parse_args()

    from raytracingweekend_jl_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu.render import image_height_for
    from raytracingweekend_jl_tpu.utils.metrics import append_history

    from raytracingweekend_jl_tpu.render import render_radiance

    W, H = 1920, image_height_for(1920)
    scene = rtw.scene_random_spheres(seed=1, dtype=jnp.float64)
    cam = rtw.t_cam1(dtype=jnp.float64)

    def run(seed):
        # Pixel-chunked: the f64 emulation keeps per-bounce [R, N]
        # intermediates alive — the full 2.07M-ray wavefront compiles to a
        # 34 GB broadcast (measured AOT OOM); 256k-ray chunks fit.
        img = render_radiance(scene, cam, W, args.spp, image_height=H,
                              seed=seed, dtype=jnp.float64,
                              pixel_chunk=1 << 18)
        assert img.dtype == jnp.float64, img.dtype
        return float(img.sum())  # host fetch = true sync on this platform

    t0 = time.time()
    s0 = run(0)
    warm_s = time.time() - t0
    times = []
    for c in range(1, args.chunks + 1):
        t0 = time.time()
        run(c)
        times.append(time.time() - t0)

    paths = W * H * args.spp
    best = min(times)
    rec = {"ts": time.time(),
           "label": f"flagship_f64_{W}x{H}x{args.spp}",
           "wall_s": round(best, 3), "paths": paths,
           "mpaths_per_s": round(paths / best / 1e6, 3),
           "dtype": "float64", "sum": s0,
           "warm_s": round(warm_s, 1),
           "flagship_wallclock_est_s": round(W * H * 1000 / (paths / best) , 1),
           "baseline_f64_wallclock_s": 1282.4,
           "device": str(jax.devices()[0])}
    append_history(rec, os.path.join(os.path.dirname(__file__), "..",
                                     "bench_history.jsonl"))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
