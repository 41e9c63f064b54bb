"""Rays/s scaling harness over mesh sizes — the measurement the north star
asks for at 1 chip / 1 host / N hosts (BASELINE.json).

Runs the sharded renderer on meshes of 1, 2, 4, ... devices (whatever is
attached: the GPUs of a host, or the virtual CPU mesh via
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``) with
a FIXED per-device workload (weak scaling: pixels per device constant), and
reports throughput + parallel efficiency as JSON lines.

On several hosts, run under `jax.distributed` (see
parallel/multihost.initialize) — same script, every host executes it.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> None:
    import jax
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu.parallel.mesh import make_render_mesh
    from raytracingweekend_jl_tpu.parallel.shard import render_radiance_sharded

    scene = rtw.scene_random_spheres(seed=1)
    cam = rtw.t_cam1()
    n_dev = len(jax.devices())
    if jax.default_backend() == "cpu":
        # Virtual CPU "devices" share the host's cores: weak scaling then
        # measures host saturation, not interconnect scaling (measured
        # round 4: efficiency 1.0/0.72/0.52/0.27 at 1/2/4/8 — exactly the
        # shared-silicon curve). Valid numbers need real chips.
        print(json.dumps({"warning": "cpu virtual mesh — efficiency "
                          "reflects host-core saturation, NOT multi-chip "
                          "scaling"}), flush=True)
    tile = 4096
    rows_per_dev = 8          # tiles per device
    spp = 4

    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    base = None
    for n in sizes:
        mesh = make_render_mesh(n_tiles=n, devices=jax.devices()[:n])
        # Weak scaling: image grows with the mesh.
        n_pix = n * rows_per_dev * tile
        H = 256
        W = n_pix // H
        kwargs = dict(image_height=H, tile_size=tile, seed=0)

        out = render_radiance_sharded(scene, cam, W, spp, mesh=mesh, **kwargs)
        float(out.sum())  # warm + sync
        t0 = time.time()
        out = render_radiance_sharded(scene, cam, W, spp, mesh=mesh,
                                      seed=1, image_height=H, tile_size=tile)
        float(out.sum())
        dt = time.time() - t0
        mpaths = W * H * spp / dt / 1e6
        per_dev = mpaths / n
        if base is None:
            base = per_dev
        print(json.dumps({
            "devices": n, "image": f"{W}x{H}x{spp}",
            "mpaths_per_s": round(mpaths, 3),
            "mpaths_per_s_per_device": round(per_dev, 3),
            "parallel_efficiency": round(per_dev / base, 3),
            "wall_s": round(dt, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
