"""Worker for the real multi-process jax.distributed test.

Launched by tests/test_multiprocess.py as N separate Python processes, each
with 2 virtual CPU devices. Exercises the actual cross-process path the
single-process suite cannot: ``jax.distributed.initialize`` (coordinator
barrier), a global ``(tiles, samples)`` mesh spanning processes, the sharded
render (the samples-axis psum crosses the process boundary), the sharded
train step (gradient all-reduce over processes), and ``host_local_rows``
strip bookkeeping. Results are printed as one JSON line for the parent to
assert on. (SURVEY.md §2.3 multi-process row; the reference has nothing here
— src/render.jl:23 is single-process fork-join.)
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    proc_id = int(sys.argv[1])
    n_procs = int(sys.argv[2])
    coord = sys.argv[3]
    strip_dir = sys.argv[4] if len(sys.argv) > 4 else None

    import jax

    jax.config.update("jax_platforms", "cpu")
    from raytracingweekend_jl_tpu.parallel import multihost

    multihost.initialize(coordinator_address=coord, num_processes=n_procs,
                         process_id=proc_id)

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from raytracingweekend_jl_tpu import scene_2_spheres, t_default_cam
    from raytracingweekend_jl_tpu.parallel.shard import (render_radiance_sharded,
                                                         sharded_train_step)

    assert jax.process_count() == n_procs, jax.process_count()
    mesh = multihost.make_multihost_mesh(n_samples_axis=2)

    scene = scene_2_spheres()
    cam = t_default_cam()
    W, H, spp, tile = 64, 36, 2, 256

    img = render_radiance_sharded(scene, cam, W, spp, mesh=mesh,
                                  image_height=H, tile_size=tile, seed=11)
    full = np.asarray(multihost_utils.process_allgather(img, tiled=True))

    start, stop = multihost.host_local_rows(H, W, tile_size=tile)

    # Strip IO: each process writes ONLY its own shard's pixels to disk (no
    # cross-host gather); the parent reassembles and checks against the
    # allgathered image.
    if strip_dir:
        s2, p2 = multihost.write_host_strip(img, H, W, tile, strip_dir)
        assert 0 <= s2 < p2 <= H * W

    # Train step: the scalar loss is fully replicated; producing it required
    # the gradient all-reduce to cross the process boundary.
    bad = scene._replace(albedo=jnp.clip(scene.albedo * 0.5, 0, 1))
    loss, updated = sharded_train_step(bad, cam, img, W, spp, mesh=mesh,
                                       lr=1.0, tile_size=tile, seed=11)
    # Replicated outputs: every process holds a full copy on its local
    # devices — read the first addressable shard.
    loss = float(np.asarray(loss.addressable_shards[0].data))
    alb = np.asarray(updated.albedo.addressable_shards[0].data)

    # Checkpoint x multi-process composition (round-4 verdict #3): each
    # process snapshots only ITS strip; interrupt + resume must equal one
    # uninterrupted chunked run bitwise, across the real process boundary.
    ck_ok = None
    if strip_dir:
        from raytracingweekend_jl_tpu.utils.checkpoint import (
            render_checkpointed_sharded)
        ck = os.path.join(strip_dir, "ck.npz")
        full_st = render_checkpointed_sharded(
            scene, cam, W, 4, mesh=mesh, image_height=H, spp_chunk=2,
            tile_size=tile, seed=11)
        render_checkpointed_sharded(
            scene, cam, W, 2, mesh=mesh, image_height=H, spp_chunk=2,
            tile_size=tile, seed=11, checkpoint_path=ck)
        res_st = render_checkpointed_sharded(
            scene, cam, W, 4, mesh=mesh, image_height=H, spp_chunk=2,
            tile_size=tile, seed=11, checkpoint_path=ck)
        ck_ok = bool(np.array_equal(full_st.strip_sum, res_st.strip_sum)
                     and (full_st.start, full_st.stop)
                     == (res_st.start, res_st.stop)
                     and res_st.samples_done == 4)

    out = {"proc": proc_id,
           "n_devices": jax.device_count(),
           "n_local": jax.local_device_count(),
           "strip_start": start, "strip_stop": stop,
           "loss": loss,
           "ckpt_resume_bitwise": ck_ok,
           "albedo00": float(alb.reshape(-1)[0])}
    if proc_id == 0:
        out["image"] = full.reshape(H, W, 3).tolist()
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
