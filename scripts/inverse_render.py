"""Inverse rendering demo: recover perturbed scene parameters by gradient
descent on an image loss — a REAL optimization trajectory, not a smoke test.

The reference has no autodiff at all (SURVEY.md §2.9 north star); this driver
demonstrates the capability the framework was built for: perturb the sphere
centers and albedos of a known scene, then run ~100+ Adam steps of
``value_and_grad(render)`` until the render matches the target. Artifacts
(target / initial / final PNGs + per-step loss JSONL) land in
``examples/inverse/`` so the trajectory is inspectable.

Per-step throughput (Mpaths/s at spp>1, forward+backward) is recorded to
``bench_history.jsonl`` — the gradient-bench coverage beyond spp=1.

Usage:
  python scripts/inverse_render.py                      # 4_spheres, device
  python scripts/inverse_render.py --steps 150 --spp 8
  python scripts/inverse_render.py --width 96 --steps 20 --cpu   # smoke
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
    ap.add_argument("--scene", default="4_spheres")
    ap.add_argument("--grid-half", type=int, default=None,
                    help="for --scene random_spheres: shrink the sphere "
                         "grid to (2N)^2 cells (e.g. 3 -> ~40 spheres)")
    ap.add_argument("--cam", default=None, choices=["default", "cam1"],
                    help="camera (default: cam1 for random_spheres, "
                         "else the default camera)")
    ap.add_argument("--width", type=int, default=200)
    ap.add_argument("--height", type=int, default=112)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=2e-2,
                    help="Adam lr for albedo")
    ap.add_argument("--lr-center", type=float, default=8e-3,
                    help="Adam lr for centers (SPSA gradients)")
    ap.add_argument("--spsa-c", type=float, default=2e-2,
                    help="SPSA perturbation scale for centers")
    ap.add_argument("--spsa-pairs", type=int, default=2,
                    help="averaged SPSA probe pairs per step")
    ap.add_argument("--center-jitter", type=float, default=0.12)
    ap.add_argument("--albedo-scale", type=float, default=0.55)
    ap.add_argument("--albedo-shift", type=float, default=0.15,
                    help="additive albedo perturbation (scale*a + shift); "
                         "scale=1 shift=0 disables it")
    ap.add_argument("--lr-fuzz", type=float, default=0.0,
                    help=">0 jointly fits metal fuzz (exact interior AD)")
    ap.add_argument("--fuzz-jitter", type=float, default=0.0,
                    help="perturb metal movables' fuzz by U(-j, j), "
                         "clipped at 0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--geom", default="spsa", choices=["spsa", "edge"],
                    help="center-gradient estimator: SPSA probes (the "
                         "measured hybrid) or pure-AD boundary-aware edge "
                         "gradients (ops/edge.py)")
    ap.add_argument("--edge-sigma", type=float, default=None,
                    help="edge band half-width in scene units (default: "
                         "per-ray pixel footprint)")
    ap.add_argument("--edge-bounces", type=int, default=1)
    ap.add_argument("--edge-sigma-px", type=float, default=1.5,
                    help="auto-sigma band width in pixel footprints")
    ap.add_argument("--edge-chunk", type=int, default=None,
                    help="pixel chunk bounding the [R,N] silhouette sweep")
    ap.add_argument("--edge-remat", action="store_true",
                    help="checkpoint each (chunk, sample) edge trace — "
                         "O(1) residual memory at ~2x forward compute")
    ap.add_argument("--cosine-decay", action="store_true",
                    help="anneal every lr to 0 over the run (freezes the "
                         "Adam random walk of noise-dominated coords)")
    ap.add_argument("--scan", action="store_true",
                    help="run the whole fit as ONE jitted lax.scan "
                         "(optimize.fit_scene_scan) — pays the host "
                         "round-trips once instead of ~5x per step")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(__file__), "..", "examples", "inverse"))
    args = ap.parse_args()

    from raytracingweekend_jl_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu.grad import render_loss
    from raytracingweekend_jl_tpu.render import render_radiance
    from raytracingweekend_jl_tpu.ops.vecmath import gamma2_encode
    from raytracingweekend_jl_tpu.utils.image import write_png
    from raytracingweekend_jl_tpu.utils.metrics import append_history

    W, H, spp = args.width, args.height, args.spp
    if args.scene == "random_spheres" and args.grid_half is not None:
        scene_true = rtw.scene_random_spheres(grid_half=args.grid_half)
    else:
        scene_true = rtw.ALL_SCENES[args.scene]()
    cam_name = args.cam or ("cam1" if args.scene == "random_spheres"
                            else "default")
    cam = rtw.t_cam1() if cam_name == "cam1" else rtw.t_default_cam()

    # Target: the TRUE scene rendered with the SAME estimator configuration
    # the optimization uses (fixed key -> deterministic loss surface). For
    # --geom edge that means the EDGE PRIMAL (bitwise the hard keyed
    # trace): its RNG streams differ from the production recorded path, and
    # at flagship sphere density (10-px spheres, spp 4) the cross-estimator
    # MC noise otherwise EXCEEDS the parameter signal — the fit then
    # "explains" noise by distorting parameters (measured: a centers-only
    # fit halved the loss while the mean center error ROSE 0.0405->0.0534).
    # With matched streams the truth is the exact global minimum.
    tkw = dict(recorded=True)
    if args.geom == "edge":
        from raytracingweekend_jl_tpu.ops.edge import render_radiance_edge
        target = render_radiance_edge(
            scene_true, cam, W, spp, image_height=H, seed=args.seed,
            sigma=1.0,  # sigma/edge_bounces do not affect the primal
            edge_bounces=0,
            pixel_chunk=args.edge_chunk if args.edge_chunk else None)
    else:
        target = render_radiance(scene_true, cam, W, spp, image_height=H,
                                 seed=args.seed, **tkw)
    target = jax.block_until_ready(target)

    # Perturb centers (not the ground plane — index 0 by convention has the
    # big ground sphere in these scenes; moving it underfoot is not the demo)
    # and darken/shift albedos. Dielectric albedo is structurally
    # UNIDENTIFIABLE — shading uses exactly (1,1,1) for glass (reference:
    # src/material.jl:42) — so it is neither perturbed nor scored: a
    # parameter with zero gradient everywhere would sit at its perturbed
    # value forever and poison the recovery metric without meaning.
    from raytracingweekend_jl_tpu.scene import DIELECTRIC
    k = jax.random.PRNGKey(7)
    r = np.asarray(scene_true.radius)
    movable = (r != 0) & (np.abs(r) < 10.0)  # spheres, not the ground
    albedo_scored = movable & (np.asarray(scene_true.mat) != DIELECTRIC)
    jit = np.array(jax.random.uniform(
        k, scene_true.center.shape, minval=-args.center_jitter,
        maxval=args.center_jitter))
    jit[~movable] = 0.0
    center0 = jnp.asarray(np.asarray(scene_true.center) + jit)
    alb = np.asarray(scene_true.albedo).copy()
    alb[albedo_scored] = np.clip(
        alb[albedo_scored] * args.albedo_scale + args.albedo_shift, 0, 1)
    scene0 = scene_true._replace(center=center0, albedo=jnp.asarray(alb))
    from raytracingweekend_jl_tpu.scene import METAL
    fuzz_scored = movable & (np.asarray(scene_true.mat) == METAL)
    if args.fuzz_jitter > 0:
        fj = np.array(jax.random.uniform(
            jax.random.fold_in(k, 99), scene_true.fuzz.shape,
            minval=-args.fuzz_jitter, maxval=args.fuzz_jitter))
        fz = np.asarray(scene_true.fuzz).copy()
        fz[fuzz_scored] = np.clip(fz[fuzz_scored] + fj[fuzz_scored], 0, None)
        scene0 = scene0._replace(fuzz=jnp.asarray(fz))

    os.makedirs(args.out_dir, exist_ok=True)

    def save(img, name):
        write_png(np.asarray(gamma2_encode(jnp.asarray(img))),
                  os.path.join(args.out_dir, name))

    save(target, "target.png")
    save(render_radiance(scene0, cam, W, spp, image_height=H,
                         seed=args.seed, **tkw), "initial.png")

    # Optimize with the package's hybrid fitter (optimize.fit_scene):
    # exact AD for albedo, SPSA for centers — see that module's docstring
    # for the measured rationale.
    from raytracingweekend_jl_tpu.optimize import fit_scene, movable_mask

    log_path = os.path.join(args.out_dir, "loss_history.jsonl")
    paths = W * H * spp
    hist_path = os.path.join(os.path.dirname(__file__), "..",
                             "bench_history.jsonl")
    lf = open(log_path, "w")

    def on_step(i, loss, params):
        lf.write(json.dumps({"step": i, "loss": loss}) + "\n")
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {loss:.6f}", flush=True)
        if i == args.steps // 2:
            save(render_radiance(
                scene0._replace(center=params["center"],
                                albedo=jnp.clip(params["albedo"], 0, 1)),
                cam, W, spp, image_height=H, seed=args.seed, **tkw),
                "midway.png")

    ekw = dict(sigma=args.edge_sigma, sigma_px=args.edge_sigma_px,
               edge_bounces=args.edge_bounces)
    fit_tkw = None if args.geom == "edge" else tkw
    if args.edge_chunk:
        ekw["pixel_chunk"] = args.edge_chunk
    if args.edge_remat:
        ekw["remat_chunks"] = True
    t_all0 = time.time()
    if args.scan:
        from raytracingweekend_jl_tpu.optimize import fit_scene_scan
        res = fit_scene_scan(scene0, cam, target, W, spp, steps=args.steps,
                             seed=args.seed, lr_albedo=args.lr,
                             lr_center=args.lr_center, lr_fuzz=args.lr_fuzz,
                             spsa_c=args.spsa_c,
                             spsa_pairs=args.spsa_pairs,
                             render_kwargs=fit_tkw,
                             geom=args.geom, edge_kwargs=ekw,
                             cosine_decay=args.cosine_decay)
        lf.write("\n".join(json.dumps({"step": i, "loss": l})
                            for i, l in enumerate(res.losses)) + "\n")
    else:
        res = fit_scene(scene0, cam, target, W, spp, steps=args.steps,
                        seed=args.seed, lr_albedo=args.lr,
                        lr_center=args.lr_center, lr_fuzz=args.lr_fuzz,
                        spsa_c=args.spsa_c,
                        spsa_pairs=args.spsa_pairs,
                        render_kwargs=fit_tkw,
                        geom=args.geom, edge_kwargs=ekw,
                        cosine_decay=args.cosine_decay,
                        on_step=on_step)
    lf.close()
    losses = res.losses
    movable = movable_mask(scene_true)

    scene_fit = res.scene
    save(render_radiance(scene_fit, cam, W, spp, image_height=H,
                         seed=args.seed, **tkw), "final.png")

    # Parameter-space recovery. Albedo is scored only where it is
    # identifiable (non-dielectric movables — glass shading ignores albedo).
    # max = worst sphere (tiny/occluded spheres are weakly constrained at
    # demo resolution); mean = the honest aggregate.
    def errs(a, b, mask):
        e = np.abs(np.asarray(a - b))[mask]
        return float(e.max()), float(e.mean())

    def err_quantiles(a, b, mask):
        # per-SPHERE error (max over components) quantiles + improved count
        e = np.abs(np.asarray(a - b))[mask]
        e = e.reshape(e.shape[0], -1).max(axis=1)
        return e

    c_err0, c_mean0 = errs(scene0.center, scene_true.center, movable)
    c_err1, c_mean1 = errs(scene_fit.center, scene_true.center, movable)
    a_err0, a_mean0 = errs(scene0.albedo, scene_true.albedo, albedo_scored)
    a_err1, a_mean1 = errs(scene_fit.albedo, scene_true.albedo,
                           albedo_scored)
    # Per-sphere improvement distribution: at flagship density many tiny/
    # occluded spheres are weakly constrained; the mean alone hides that
    # the constrained majority recovers.
    ec0 = err_quantiles(scene0.center, scene_true.center, movable)
    ec1 = err_quantiles(scene_fit.center, scene_true.center, movable)
    # Screen coverage class: projected radius in pixels. Recovery is
    # information-limited by how many pixels (and band samples) a sphere
    # gets; reporting by class separates "estimator works" from "10-px
    # spheres are under-determined at this budget".
    from raytracingweekend_jl_tpu.ops.edge import pixel_angle as _pix_angle
    from raytracingweekend_jl_tpu.ops.intersect import intersect_spheres
    from raytracingweekend_jl_tpu.camera import get_rays as _get_rays
    from raytracingweekend_jl_tpu.render import pixel_coords as _pix_coords
    pa_v = float(np.asarray(_pix_angle(cam, float(np.float32(H)))))
    dist = np.linalg.norm(np.asarray(scene_true.center)
                          - np.asarray(cam.origin), axis=1)
    px_r_all = (np.abs(np.asarray(scene_true.radius))
                / np.maximum(dist * pa_v, 1e-9))
    # PRIMARY VISIBILITY gate: the 22x22 grid extends far outside the
    # vfov-20 frustum — off-frame spheres have exactly zero gradient,
    # never move, and would poison any recovery fraction. Count each
    # sphere's winning primary pixels in the TRUE scene.
    _u, _v = _pix_coords(W, H)
    _o, _d = _get_rays(cam, _u, _v, jax.random.PRNGKey(0))
    _res = intersect_spheres(_o, _d, scene_true)
    _idx = np.asarray(_res.index)[np.asarray(_res.hit)]
    pix_count_all = np.bincount(_idx, minlength=scene_true.n_spheres)
    visible_all = pix_count_all >= 4
    px_r = px_r_all[movable]
    vis = visible_all[movable]
    big = vis & (px_r >= 15.0)
    dist_stats = {
        "center_err_p50_init": round(float(np.median(ec0)), 4),
        "center_err_p50_final": round(float(np.median(ec1)), 4),
        "center_err_p90_init": round(float(np.percentile(ec0, 90)), 4),
        "center_err_p90_final": round(float(np.percentile(ec1, 90)), 4),
        "center_improved_frac": round(float((ec1 < ec0).mean()), 3),
        "n_visible": int(vis.sum()),
        "center_improved_frac_visible": (
            round(float((ec1 < ec0)[vis].mean()), 3) if vis.any() else None),
        "center_p50_init_visible": (
            round(float(np.median(ec0[vis])), 4) if vis.any() else None),
        "center_p50_final_visible": (
            round(float(np.median(ec1[vis])), 4) if vis.any() else None),
        "center_improved_frac_ge15px": (
            round(float((ec1 < ec0)[big].mean()), 3) if big.any() else None),
        "center_p50_final_ge15px": (
            round(float(np.median(ec1[big])), 4) if big.any() else None),
        "center_p50_init_ge15px": (
            round(float(np.median(ec0[big])), 4) if big.any() else None),
        "n_ge15px": int(big.sum()),
    }
    f_stats = {}
    if args.lr_fuzz > 0 and fuzz_scored.any():
        f_err0, f_mean0 = errs(scene0.fuzz, scene_true.fuzz, fuzz_scored)
        f_err1, f_mean1 = errs(scene_fit.fuzz, scene_true.fuzz, fuzz_scored)
        f_stats = {"fuzz_err_init": round(f_err0, 4),
                   "fuzz_err_final": round(f_err1, 4),
                   "fuzz_mean_err_init": round(f_mean0, 4),
                   "fuzz_mean_err_final": round(f_mean1, 4)}
        fv = fuzz_scored & visible_all
        if fv.any():
            _, fv0 = errs(scene0.fuzz, scene_true.fuzz, fv)
            _, fv1 = errs(scene_fit.fuzz, scene_true.fuzz, fv)
            f_stats["fuzz_mean_err_init_visible"] = round(fv0, 4)
            f_stats["fuzz_mean_err_final_visible"] = round(fv1, 4)
            f_stats["n_fuzz_visible"] = int(fv.sum())
    av = albedo_scored & visible_all
    if av.any():
        _, av0 = errs(scene0.albedo, scene_true.albedo, av)
        _, av1 = errs(scene_fit.albedo, scene_true.albedo, av)
        dist_stats["albedo_mean_err_init_visible"] = round(av0, 4)
        dist_stats["albedo_mean_err_final_visible"] = round(av1, 4)
        dist_stats["n_albedo_visible"] = int(av.sum())
    steady = sorted(l for l in losses)  # noqa: E741
    mean_step_s = (time.time() - t_all0) / args.steps
    rec = {"ts": time.time(),
           "label": (f"inverse_{args.scene}"
                     + (f"_g{args.grid_half}" if args.grid_half else "")
                     + f"_{W}x{H}x{spp}_{args.steps}steps"
                     + ("_scan" if args.scan else "")
                     + ("_edge" if args.geom == "edge" else "")),
           "loss_init": round(losses[0], 6), "loss_final": round(losses[-1], 6),
           "loss_min": round(steady[0], 6),
           "center_err_init": round(c_err0, 4),
           "center_err_final": round(c_err1, 4),
           "center_mean_err_init": round(c_mean0, 4),
           "center_mean_err_final": round(c_mean1, 4),
           "albedo_err_init": round(a_err0, 4),
           "albedo_err_final": round(a_err1, 4),
           **f_stats, **dist_stats,
           "albedo_mean_err_init": round(a_mean0, 4),
           "albedo_mean_err_final": round(a_mean1, 4),
           "n_movable": int(movable.sum()),
           "mean_step_s": round(mean_step_s, 3), "paths": paths,
           "mpaths_per_s": round(paths / mean_step_s / 1e6, 3),
           "device": str(jax.devices()[0])}
    append_history(rec, hist_path)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
