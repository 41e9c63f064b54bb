"""Command-line interface — the driver the reference runs as editable scripts
(reference: src/proto/proto.jl; SURVEY.md §2.2 'Benchmark driver (CLI)').

    python -m raytracingweekend_jl_tpu.cli --scene random_spheres --camera cam1 \
        --width 1920 --spp 1000 --spp-chunk 50 --checkpoint ckpt.npz -o out.png
"""

from __future__ import annotations

import argparse
import json
import time

from .utils.config import RenderConfig, CAMERA_PRESETS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracingweekend_jl_tpu",
                                description="differentiable JAX path tracer")
    from .models.scenes import ALL_SCENES
    d = RenderConfig()
    p.add_argument("--scene", default=d.scene, choices=sorted(ALL_SCENES),
                   help="scene name")
    p.add_argument("--camera", default=d.camera, choices=CAMERA_PRESETS)
    p.add_argument("--width", type=int, default=d.image_width)
    p.add_argument("--height", type=int, default=None,
                   help="default: width*9//16 (reference formula)")
    p.add_argument("--spp", type=int, default=d.n_samples)
    p.add_argument("--depth", type=int, default=d.max_depth)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--scene-seed", type=int, default=d.scene_seed)
    p.add_argument("--precision", default=d.precision, choices=("f32", "f64"))
    p.add_argument("--compact", action="store_true", default=d.compact,
                   help="enable the forward-only compacted integrator when the "
                        "persistent one is disabled (default matches "
                        "RenderConfig.compact)")
    p.add_argument("--no-compact", dest="no_compact", action="store_true",
                   help="deprecated alias (compaction is already off by "
                        "default); kept so older invocations still parse")
    p.add_argument("--no-persistent", action="store_true",
                   help="disable the persistent-wavefront integrator")
    p.add_argument("--rays-per-pass", type=int, default=d.rays_per_pass)
    p.add_argument("--mesh-tiles", type=int, default=d.mesh_tiles)
    p.add_argument("--mesh-samples", type=int, default=d.mesh_samples)
    p.add_argument("--tile-size", type=int, default=d.tile_size)
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run: auto-init jax.distributed (pod "
                        "metadata / SLURM / coordinator env), mesh over every "
                        "process's devices, per-host strip IO; all processes "
                        "run this same command")
    p.add_argument("--strip-dir", default=d.strip_dir,
                   help="directory for per-host image strips "
                        "(default: <output>.strips)")
    p.add_argument("--spp-chunk", type=int, default=d.spp_chunk,
                   help=">0 enables chunked rendering with checkpoints")
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    p.add_argument("-o", "--output", default=d.output, help=".png or .ppm")
    p.add_argument("--stats", action="store_true",
                   help="print per-bounce wavefront occupancy before rendering")
    return p


def config_from_args(args) -> RenderConfig:
    if getattr(args, "no_compact", False) and args.compact:
        raise SystemExit("--compact and --no-compact are mutually exclusive")
    return RenderConfig(
        scene=args.scene, camera=args.camera, image_width=args.width,
        image_height=args.height, n_samples=args.spp, max_depth=args.depth,
        seed=args.seed, scene_seed=args.scene_seed, precision=args.precision,
        compact=args.compact, persistent=not args.no_persistent,
        rays_per_pass=args.rays_per_pass,
        mesh_tiles=args.mesh_tiles, mesh_samples=args.mesh_samples,
        tile_size=args.tile_size, spp_chunk=args.spp_chunk,
        checkpoint_path=args.checkpoint, output=args.output,
        multihost=args.multihost, strip_dir=args.strip_dir)


def print_occupancy(cfg: RenderConfig) -> None:
    """Per-bounce live-ray / active-tile counts for this config (SURVEY.md §5
    observability: bounce occupancy + compaction ratio)."""
    import jax
    import numpy as np
    from .ops.integrator import trace_occupancy
    from .camera import get_rays
    from .render import pixel_coords, image_height_for

    scene = cfg.build_scene()
    cam = cfg.build_camera()
    H = cfg.image_height or image_height_for(cfg.image_width)
    u, v = pixel_coords(cfg.image_width, H, dtype=cam.origin.dtype)
    o, d = get_rays(cam, u, v, jax.random.PRNGKey(cfg.seed))
    counts, tiles = trace_occupancy(scene, o, d, jax.random.PRNGKey(cfg.seed),
                                    max_depth=cfg.max_depth, tmin=cfg.tmin)
    counts = np.asarray(counts); tiles = np.asarray(tiles)
    n = cfg.image_width * H
    print(json.dumps({
        "bounce_occupancy": [round(float(c) / n, 4) for c in counts],
        "active_tiles": tiles.tolist(),
        "mean_path_length": round(float(counts.sum()) / n, 3),
    }))


def run(cfg: RenderConfig) -> dict:
    import numpy as np
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from .ops.vecmath import gamma2_encode
    from .render import render_radiance, image_height_for
    from .utils.image import write_png, write_ppm
    from .utils.metrics import throughput_record, append_history

    scene = cfg.build_scene()
    cam = cfg.build_camera()
    H = cfg.image_height or image_height_for(cfg.image_width)

    t0 = time.time()
    phases = None
    if cfg.multihost or cfg.mesh_tiles * cfg.mesh_samples > 1:
        # ALL sharded renders (multihost or single-process mesh), plain or
        # spp-chunk-checkpointed — the branches COMPOSE (a large
        # render must both shard and resume).
        import jax
        from .parallel import multihost
        from .parallel.shard import render_radiance_sharded
        if cfg.multihost:
            try:
                multihost.initialize()  # auto-detect cluster; no-op 1-proc
            except (RuntimeError, ValueError) as e:
                if multihost.cluster_env_hint():
                    # A real multi-process launch that fails to connect must
                    # NOT degrade: N disconnected processes would each render
                    # the full image and race on the same output.
                    raise SystemExit(
                        "multihost init failed on a detected cluster launch: "
                        f"{e!r}") from e
                # Mis-detected metadata degrades to single-process, not die.
                print(json.dumps({"multihost_init_skipped": repr(e)[:160]}))
            mesh = multihost.make_multihost_mesh(
                n_samples_axis=cfg.mesh_samples)
        else:
            from .parallel.mesh import make_render_mesh
            n_mesh = cfg.mesh_tiles * cfg.mesh_samples
            mesh = make_render_mesh(n_tiles=cfg.mesh_tiles,
                                    n_samples=cfg.mesh_samples,
                                    devices=jax.devices()[:n_mesh])
        H2 = cfg.image_height or image_height_for(cfg.image_width)
        strip = None
        if cfg.spp_chunk > 0:
            from .utils.checkpoint import render_checkpointed_sharded
            from .utils.metrics import PhaseTimer
            timer = PhaseTimer()
            state = render_checkpointed_sharded(
                scene, cam, cfg.image_width, cfg.n_samples, mesh=mesh,
                image_height=cfg.image_height, seed=cfg.seed,
                spp_chunk=cfg.spp_chunk, checkpoint_path=cfg.checkpoint_path,
                tile_size=cfg.tile_size, max_depth=cfg.max_depth,
                tmin=cfg.tmin, persistent=cfg.persistent,
                rays_per_pass=cfg.rays_per_pass, progress=True, timer=timer)
            phases = timer.as_dict()
            strip = (state.start, state.stop,
                     state.strip_image.astype(np.float32))
            img_sharded = None
        else:
            img_sharded = render_radiance_sharded(
                scene, cam, cfg.image_width, cfg.n_samples, mesh=mesh,
                image_height=cfg.image_height, tile_size=cfg.tile_size,
                max_depth=cfg.max_depth, tmin=cfg.tmin, seed=cfg.seed)
        if jax.process_count() > 1:
            # Per-host strip IO: each process writes only its own shard.
            strip_dir = cfg.strip_dir or cfg.output + ".strips"
            multihost.write_host_strip(img_sharded, H2, cfg.image_width,
                                       cfg.tile_size, strip_dir, strip=strip)
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices("rtw_strips_written")
            if jax.process_index() != 0:
                return {"proc": jax.process_index(), "strips": strip_dir}
            linear = multihost.assemble_strips(strip_dir)
        elif strip is not None:
            linear = state.image
        else:
            linear = np.asarray(img_sharded)
    elif cfg.spp_chunk > 0:
        from .utils.checkpoint import render_checkpointed
        from .utils.metrics import PhaseTimer
        timer = PhaseTimer()
        state = render_checkpointed(
            scene, cam, cfg.image_width, cfg.n_samples, image_height=cfg.image_height,
            seed=cfg.seed, spp_chunk=cfg.spp_chunk,
            checkpoint_path=cfg.checkpoint_path, max_depth=cfg.max_depth,
            tmin=cfg.tmin, compact=cfg.compact, persistent=cfg.persistent,
            rays_per_pass=cfg.rays_per_pass, progress=True, timer=timer)
        linear = state.image
        phases = timer.as_dict()
    else:
        linear = np.asarray(render_radiance(
            scene, cam, cfg.image_width, cfg.n_samples,
            image_height=cfg.image_height, max_depth=cfg.max_depth,
            tmin=cfg.tmin, seed=cfg.seed, compact=cfg.compact,
            persistent=cfg.persistent,
            rays_per_pass=cfg.rays_per_pass, dtype=cfg.dtype()))
    wall = time.time() - t0

    img = np.sqrt(np.clip(linear, 0.0, None))  # gamma-2 (reference src/vec.jl:22)
    if cfg.output.endswith(".ppm"):
        write_ppm(img, cfg.output)
    else:
        write_png(img, cfg.output)

    extra = {"config": cfg.to_dict()}
    if phases:
        extra["phases"] = phases
    rec = throughput_record(
        f"{cfg.scene}_{cfg.image_width}x{H}x{cfg.n_samples}", wall,
        cfg.image_width * H * cfg.n_samples, extra=extra)
    append_history(rec)
    print(json.dumps(rec))
    return rec


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.stats:
        print_occupancy(cfg)
    run(cfg)


if __name__ == "__main__":
    main()
