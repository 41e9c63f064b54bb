"""Smoke test of the main path on NVIDIA GPUs — the quickest proof that the
path tracer still starts, renders and differentiates on the card.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --four-cards    # four cards: the mesh phase only

One process drives the card(s) (a second JAX process could not get device
memory). Each phase prints one JSON line with its compile and steady
seconds, the device's peak bytes in use so far and the card; any failed
check makes the script exit non-zero. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Phases (one card):

1. device   — JAX must see a GPU; ``nvidia-smi`` name and power limit.
2. sweep    — the Pallas sweep kernel vs the XLA sweep on 2,073,600 primary
              rays of the flagship (1920x1080, t_cam1, random_spheres seed 1,
              488 spheres) and one bounce of scattered rays; the float64
              oracle of tests/test_intersect.py decides every winner the
              two disagree on, and checks both on a 65,536-ray subset of
              each set. f32 arithmetic; the XLA side keeps
              precision=HIGHEST (no TF32).
3. forward  — the flagship at 1920x1080x16 spp through ``rtw.render`` and
              the CLI (spp-chunked, checkpointed), the six scenes against
              the CPU goldens, and the f32-vs-f64 drift anchor.
4. grad     — ``value_and_grad`` of ``grad.render_loss`` at 1920x1080x1,
              the per-sphere gradient sums at that width against float64,
              a finite-difference check of one albedo gradient, three
              ``fit_scene(geom="spsa")`` steps at 400x225x4 and one
              ``geom="edge"`` step at 960x540x8.
5. gpu_tests — the ``gpu``-marked tests, through ``pytest.main`` in this
              process.

Four cards: flagship renders at 1920x1080x8 spp on 4x1 and 2x2
``(tiles, samples)`` meshes against a 1x1 mesh, ``sharded_train_step`` on
four cards against one, and a ``render_checkpointed_sharded``
interrupt-and-resume.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, ".smoke_out")

ONE_CARD_PHASES = ("device", "sweep", "forward", "grad", "gpu_tests")
FOUR_CARD_PHASES = ("device", "mesh")

W, H = 1920, 1080          # the flagship film
FLAGSHIP_SPP = 16          # forward phase
ORACLE_RAYS = 65536        # float64-oracle subset of each ray set
FIT_SPSA = (400, 4, 3)     # (width, spp, steps) of fit_scene(geom="spsa")
FIT_EDGE = (960, 8, 1)     # ... and of geom="edge" (the capstone's size)
EDGE_CHUNK = 64800         # edge renderer pixel chunk (scan-remat)
MESH_SPP = 8               # four-card renders
MESH_TILE = 1 << 18        # pixels per shard tile for the four-card renders
TRAIN = (480, 4, 1 << 15)  # (width, spp, tile) of the sharded train step


class CheckFailed(RuntimeError):
    """A phase's check did not hold."""


# ---------------------------------------------------------------------------
# Pure helpers (tested on the CPU by tests/test_chip_smoke.py)
# ---------------------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card mesh phase")
    return p.parse_args(argv)


def select_phases(four_cards: bool) -> list[str]:
    """The phases to run, in order; the device phase comes first."""
    return list(FOUR_CARD_PHASES if four_cards else ONE_CARD_PHASES)


def require_gpu(devices, count: int) -> None:
    """Refuse to run unless JAX's devices are at least ``count`` GPUs."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU, JAX found "
                         f"platform {platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found "
                         f"{len(devices)}")


def last_line(platform: str, kind: str, count: int) -> str:
    """The final stdout line: the run's result and its device."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


#: Sweep gates, set from readings on an H100 (PERF.md). Winner agreement
#: of the kernel with the XLA sweep: the primary rays to 99.99 %; the bounce
#: rays, which leave a surface, to a looser bound, because there the
#: self-hit root lies within float32 rounding of tmin on about 0.1 % of
#: rays and the two sweeps round it differently (CHANGES.md).
PRIMARY_AGREE = 0.9999
BOUNCE_AGREE = 0.9985
#: Wherever the two sweeps disagree, the float64 oracle decides; the kernel
#: may be the wrong one on at most this share of the rays more than the XLA
#: sweep.
WINNER_MARGIN = 2.5e-4
#: On the oracle subset, rays given the oracle's winner at a distance off
#: by more than T_REL of it: the kernel may have at most this share more of
#: them than the XLA sweep.
T_REL = 1e-5
T_MARGIN = 0.025


def oracle_misses(t, index, t64, index64) -> tuple[int, int]:
    """``(winner misses, distance misses)`` of one float32 sweep against the
    float64 oracle: rays whose winner (``-1``: none) differs, and rays with
    the oracle's winner whose ``|t - t64| > T_REL * t64``."""
    import numpy as np
    wrong = np.asarray(index) != np.asarray(index64)
    right_hit = ~wrong & (np.asarray(index64) >= 0)
    with np.errstate(invalid="ignore"):
        off = np.abs(np.asarray(t, np.float64) - t64) > T_REL * np.abs(t64)
    return int(wrong.sum()), int((right_hit & off).sum())


def sweep_failures(name: str, rec: dict) -> list[str]:
    """The sweep gates on one ray set's record; empty when it passes."""
    floor = PRIMARY_AGREE if name == "primary" else BOUNCE_AGREE
    fails = []
    if rec["index_agree"] < floor:
        fails.append(f"{name}: winner agreement {rec['index_agree']} < "
                     f"{floor}")
    gap = rec["disagree_plain_right"] - rec["disagree_kernel_right"]
    if gap > WINNER_MARGIN * rec["rays"]:
        fails.append(f"{name}: of {rec['n_disagree']} disagreements the "
                     f"oracle sides with the XLA sweep on {gap} more")
    k, p = rec["oracle_t_miss_kernel"], rec["oracle_t_miss_plain"]
    if k > p * (1.0 + T_MARGIN):
        fails.append(f"{name}: kernel's distance is off the oracle's on {k} "
                     f"of {rec['oracle_rays']} rays, the XLA sweep's on {p}")
    return fails


def summation_error(index, rows, sums, n: int):
    """Float64 check of per-sphere float32 sums ``sums`` [n,F] of ``rows``
    [R,F] over ``index`` [R]: ``(exact, worst)``, the float64 sums and the
    largest ratio of an entry's error to the bound on float32 summation in
    any order, ``gamma_(k-1) * sum |x|`` for a sphere of ``k`` rays (so a
    one-ray entry must be exact). ``worst <= 1`` holds for any float32 sum;
    inputs rounded to a shorter mantissa (TF32) break it."""
    import numpy as np
    idx = np.asarray(index)
    x = np.asarray(rows, np.float64)
    exact = np.stack([np.bincount(idx, x[:, f], minlength=n)
                      for f in range(x.shape[1])], 1)
    mag = np.stack([np.bincount(idx, np.abs(x[:, f]), minlength=n)
                    for f in range(x.shape[1])], 1)
    ku = np.maximum(np.bincount(idx, minlength=n) - 1, 0)[:, None] * 2.0**-24
    bound = ku / (1.0 - ku) * mag
    err = np.abs(np.asarray(sums, np.float64) - exact)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(bound > 0, err / bound,
                         np.where(err > 0, np.inf, 0.0))
    return exact, float(ratio.max())


# ---------------------------------------------------------------------------
# Measurement plumbing
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def peak_bytes() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def emit(phase: str, **fields) -> None:
    import jax
    rec = {"phase": phase, **fields, "peak_bytes": peak_bytes(),
           "card": jax.devices()[0].device_kind}
    print(json.dumps(rec, default=float), flush=True)


def timed(fn, *args, repeats: int = 2, **kwargs):
    """(result, first-call seconds incl. compile, best steady seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    first = time.perf_counter() - t0
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, first, best


@contextlib.contextmanager
def sweep_pinned(use_kernel: bool):
    """Pin the integrators' sweep to the kernel or the XLA sweep (for the
    kernel-vs-plain timings); jit caches are cleared on both edges."""
    import jax
    from raytracingweekend_jl_tpu.utils import platform
    saved = platform.use_sweep_kernel
    platform.use_sweep_kernel = lambda backend=None: use_kernel
    jax.clear_caches()
    try:
        yield
    finally:
        platform.use_sweep_kernel = saved
        jax.clear_caches()


def flagship():
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu.scene import trim_scene
    return trim_scene(rtw.scene_random_spheres(seed=1)), rtw.t_cam1()


def scene_by_name(name):
    import raytracingweekend_jl_tpu as rtw
    return (rtw.scene_random_spheres(seed=1) if name == "random_spheres"
            else rtw.ALL_SCENES[name]())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def flagship_rays():
    """Primary rays of the flagship film, one per pixel."""
    import jax
    from raytracingweekend_jl_tpu.camera import get_rays
    from raytracingweekend_jl_tpu.render import pixel_coords
    _, cam = flagship()
    u, v = pixel_coords(W, H)
    return jax.jit(get_rays)(cam, u, v, jax.random.PRNGKey(0))


def phase_sweep() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from raytracingweekend_jl_tpu.ops.intersect import intersect_spheres
    from raytracingweekend_jl_tpu.ops.materials import scatter
    from raytracingweekend_jl_tpu.ops.pallas.intersect_kernel import (
        intersect_spheres_pallas)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_intersect import oracle_hit_batch

    scene, _ = flagship()
    o, d = flagship_rays()
    plain = jax.jit(lambda o, d: intersect_spheres(o, d, scene))
    kernel = jax.jit(lambda o, d: intersect_spheres_pallas(o, d, scene))
    ref = plain(o, d)
    sc = jax.jit(scatter)(scene, o, d, jnp.where(ref.hit, ref.t, 1.0),
                          ref.index, jax.random.PRNGKey(1))
    o2 = jnp.where(ref.hit[:, None], sc.origin, o)
    d2 = jnp.where(ref.hit[:, None], sc.direction, d)
    centers = np.asarray(scene.center, np.float64)
    radii = np.asarray(scene.radius, np.float64)
    subset = np.random.default_rng(0).choice(W * H, min(ORACLE_RAYS, W * H),
                                             replace=False)

    for name, (oo, dd) in (("primary", (o, d)), ("bounce", (o2, d2))):
        res_k, compile_k, steady_k = timed(kernel, oo, dd, repeats=3)
        res_p, compile_p, steady_p = timed(plain, oo, dd, repeats=3)
        tk = np.asarray(res_k.t, np.float64)
        tp = np.asarray(res_p.t, np.float64)
        ik = np.where(np.asarray(res_k.hit), np.asarray(res_k.index), -1)
        ip = np.where(np.asarray(res_p.hit), np.asarray(res_p.index), -1)
        same = (ik == ip) & (ik >= 0)
        rel = np.abs(tk[same] - tp[same]) / tp[same]
        o64 = np.asarray(oo, np.float64)
        d64 = np.asarray(dd, np.float64)
        # Every disagreement, at full width, decided by the float64 oracle.
        dis = np.flatnonzero(ik != ip)
        _, win = oracle_hit_batch(o64[dis], d64[dis], centers, radii)
        # Both sweeps against the oracle on a subset.
        et, ei = oracle_hit_batch(o64[subset], d64[subset], centers, radii)
        miss_k = oracle_misses(tk[subset], ik[subset], et, ei)
        miss_p = oracle_misses(tp[subset], ip[subset], et, ei)
        rec = dict(rays=int(oo.shape[0]), spheres=int(scene.n_spheres),
                   compile_s=compile_k, steady_s=steady_k,
                   plain_compile_s=compile_p, plain_steady_s=steady_p,
                   index_agree=float(1.0 - dis.size / oo.shape[0]),
                   n_disagree=int(dis.size),
                   disagree_kernel_right=int(np.sum(ik[dis] == win)),
                   disagree_plain_right=int(np.sum(ip[dis] == win)),
                   frac_rel_dt_le_1e5=float(np.mean(rel <= T_REL)),
                   max_rel_dt=float(rel.max()) if rel.size else 0.0,
                   oracle_rays=int(subset.size),
                   oracle_index_miss_kernel=miss_k[0],
                   oracle_index_miss_plain=miss_p[0],
                   oracle_t_miss_kernel=miss_k[1],
                   oracle_t_miss_plain=miss_p[1])
        emit(f"sweep/{name}", **rec)
        fails = sweep_failures(name, rec)
        check(not fails, "; ".join(fails))


GOLDEN_CAMS = {"2_spheres": "t_default_cam", "4_spheres": "t_default_cam",
               "diel_spheres": "t_default_cam",
               "diel_spheres_hollow": "hollow_glass_cam",
               "blue_red_spheres": "t_default_cam", "random_spheres": "t_cam1"}


def phase_forward() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu import cli

    scene, cam = flagship()
    spp = FLAGSHIP_SPP

    def flagship_render():
        return rtw.render(scene, cam, W, spp, persistent=True)

    times = {}
    for tag, use_kernel in (("kernel", True), ("plain", False)):
        with sweep_pinned(use_kernel):
            img, first, steady = timed(flagship_render)
        times[tag] = (first, steady, np.asarray(img))
    img = times["kernel"][2]
    check(img.shape == (H, W, 3) and np.isfinite(img).all(),
          "flagship render not finite [H,W,3]")
    mean_gap = abs(float(img.mean()) - float(times["plain"][2].mean()))
    check(mean_gap < 2e-3, f"kernel vs plain flagship mean differs {mean_gap}")
    emit("forward/flagship", size=f"{W}x{H}x{spp}", integrator="persistent",
         compile_s=times["kernel"][0], steady_s=times["kernel"][1],
         plain_sweep_compile_s=times["plain"][0],
         plain_sweep_steady_s=times["plain"][1],
         mpaths_per_s=W * H * spp / times["kernel"][1] / 1e6,
         plain_sweep_mpaths_per_s=W * H * spp / times["plain"][1] / 1e6,
         mean=float(img.mean()), kernel_vs_plain_mean_gap=mean_gap)

    # The CLI, spp-chunked and checkpointed, in this process.
    os.makedirs(OUT_DIR, exist_ok=True)
    ck = os.path.join(OUT_DIR, "flagship_ck.npz")
    png = os.path.join(OUT_DIR, "flagship.png")
    if os.path.exists(ck):
        os.remove(ck)
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(OUT_DIR)  # the CLI appends its history file to the cwd
    try:
        cli.main(["--scene", "random_spheres", "--camera", "cam1",
                  "--width", str(W), "--spp", str(spp), "--spp-chunk", "8",
                  "--checkpoint", ck, "-o", png])
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    from raytracingweekend_jl_tpu.utils.checkpoint import load_state
    state = load_state(ck)
    cli_img = np.sqrt(np.clip(state.image, 0.0, None))  # gamma 2, as render
    check(state.samples_done == spp, "CLI checkpoint incomplete")
    check(np.isfinite(cli_img).all() and os.path.getsize(png) > 0,
          "CLI render not finite or no PNG")
    cli_gap = abs(float(cli_img.mean()) - float(img.mean()))
    check(cli_gap < 0.01, f"CLI vs render mean differs {cli_gap}")
    emit("forward/cli", size=f"{W}x{H}x{spp}", spp_chunk=8, wall_s=wall,
         mean=float(cli_img.mean()), mean_gap_vs_render=cli_gap)

    # Six scenes against the CPU goldens.
    goldens = np.load(os.path.join(ROOT, "tests", "goldens",
                                   "renders_64x36_spp4.npz"))
    t0 = time.perf_counter()
    worst = {}
    for name, camf in sorted(GOLDEN_CAMS.items()):
        s = scene_by_name(name)
        c = getattr(rtw, camf)()
        for mode, kw in (("plain", {}), ("persistent", {"persistent": True})):
            got = np.asarray(rtw.render_radiance(s, c, 64, 4, seed=0, **kw))
            g = goldens[name]
            mean_diff = abs(float(got.mean() - g.mean()))
            pix = float((np.abs(got - g) > 0.05).mean())
            check(mean_diff < 0.015 and (mode == "persistent" or pix < 0.10),
                  f"golden {name}/{mode}: mean_diff {mean_diff} pix {pix}")
            worst[f"{name}/{mode}"] = [round(mean_diff, 6), round(pix, 4)]
    hires = np.load(os.path.join(ROOT, "tests", "goldens",
                                 "renders_256x144_spp64.npz"))["random_spheres"]
    s = scene_by_name("random_spheres")
    for mode, kw in (("plain", {"rays_per_pass": 1 << 21}),
                     ("persistent", {"persistent": True})):
        got = np.asarray(rtw.render_radiance(s, rtw.t_cam1(), 256, 64, seed=0,
                                             **kw))
        mean_diff = abs(float(got.mean() - hires.mean()))
        pix = float((np.abs(got - hires) > 0.05).mean())
        check(mean_diff < 0.004 and (mode == "persistent" or pix < 0.02),
              f"hires golden {mode}: mean_diff {mean_diff} pix {pix}")
        worst[f"hires_256x144x64/{mode}"] = [round(mean_diff, 6), round(pix, 4)]
    emit("forward/goldens", wall_s=time.perf_counter() - t0,
         mean_diff_and_pix_frac=worst)

    # f32 vs f64 mean drift on the card (native f64).
    img32 = np.asarray(rtw.render_radiance(
        rtw.ALL_SCENES["diel_spheres_hollow"](), rtw.hollow_glass_cam(),
        64, 16, seed=9))
    with jax.enable_x64(True):
        img64 = np.asarray(rtw.render_radiance(
            rtw.ALL_SCENES["diel_spheres_hollow"](dtype=jnp.float64),
            rtw.hollow_glass_cam(dtype=jnp.float64), 64, 16, seed=9))
    drift = abs(float(img32.mean()) - float(img64.mean()))
    check(img64.dtype == np.float64 and np.isfinite(img64).all()
          and drift < 5e-3, f"f64 anchor drift {drift}")
    emit("forward/f64_anchor", dtype=str(img64.dtype),
         mean_f32=float(img32.mean()), mean_f64=float(img64.mean()),
         mean_drift=drift)


def gather_transpose_witness(scene) -> None:
    """gather_rows' transpose (a one-hot matrix product at HIGHEST
    precision, every per-sphere sum of the recorded path) against float64
    sums at the flagship's winning indices, with the scatter-add it
    replaced alongside."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from raytracingweekend_jl_tpu.ops.intersect import intersect_spheres
    from raytracingweekend_jl_tpu.ops.materials import gather_rows
    n = scene.center.shape[0]
    o, d = flagship_rays()
    idx = jax.jit(lambda o, d: intersect_spheres(o, d, scene).index)(o, d)
    rows = jax.random.normal(jax.random.PRNGKey(5), (W * H, 9), jnp.float32)
    table = jnp.zeros((n, 9), jnp.float32)
    transpose = jax.jit(lambda i, g: jax.vjp(lambda t: gather_rows(t, i),
                                             table)[1](g)[0])
    scatter_add = jax.jit(lambda i, g: table.at[i].add(g))
    sums, _, steady_t = timed(transpose, idx, rows, repeats=3)
    sums_sa, _, steady_sa = timed(scatter_add, idx, rows, repeats=3)
    exact, worst = summation_error(idx, rows, sums, n)
    _, worst_sa = summation_error(idx, rows, sums_sa, n)
    scale = np.abs(exact).max(0)
    emit("grad/gather_transpose_witness", rays=W * H, spheres=n, fields=9,
         steady_s=steady_t, scatter_add_steady_s=steady_sa,
         err_over_f32_bound=worst, scatter_add_err_over_f32_bound=worst_sa,
         max_err_rel_field_max=float(
             (np.abs(np.asarray(sums) - exact).max(0) / scale).max()),
         scatter_add_max_err_rel_field_max=float(
             (np.abs(np.asarray(sums_sa) - exact).max(0) / scale).max()))
    check(worst <= 1.0, f"gather_rows transpose off its float64 sums by "
          f"{worst} of the float32 summation bound")


def phase_grad() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu.grad import (render_loss, render_grads,
                                               check_grads_sane, _params_of,
                                               _with_params)
    from raytracingweekend_jl_tpu.optimize import fit_scene, movable_mask

    scene, cam = flagship()
    target = rtw.render_radiance(scene, cam, W, 1, seed=1, persistent=True)
    bad = scene._replace(albedo=jnp.clip(scene.albedo * 0.8, 0.0, 1.0))

    @jax.jit
    def step(params):
        return jax.value_and_grad(
            lambda p: render_loss(_with_params(bad, p), cam, target, W, 1,
                                  seed=3))(params)

    times = {}
    for tag, use_kernel in (("kernel", True), ("plain", False)):
        with sweep_pinned(use_kernel):
            (loss, grads), first, steady = timed(step, _params_of(bad))
        check_grads_sane(grads, loss)
        times[tag] = (first, steady, float(loss))
    emit("grad/flagship_value_and_grad", size=f"{W}x{H}x1", path="recorded",
         compile_s=times["kernel"][0], steady_s=times["kernel"][1],
         plain_sweep_compile_s=times["plain"][0],
         plain_sweep_steady_s=times["plain"][1],
         mpaths_per_s=W * H / times["kernel"][1] / 1e6,
         plain_sweep_mpaths_per_s=W * H / times["plain"][1] / 1e6,
         loss=times["kernel"][2], loss_plain_sweep=times["plain"][2])

    gather_transpose_witness(scene)

    # Central finite difference of one albedo gradient.
    s2 = rtw.scene_2_spheres()
    c2 = rtw.t_default_cam()
    tgt = jnp.zeros((18, 32, 3), jnp.float32)
    loss2, g2 = render_grads(s2, c2, tgt, image_width=32, n_samples=2, seed=7)
    g_ad = float(np.asarray(g2.albedo)[0, 0])
    eps = 1e-3
    a = np.asarray(s2.albedo).copy()
    a[0, 0] += eps
    lp = float(render_loss(s2._replace(albedo=jnp.asarray(a)), c2, tgt, 32, 2,
                           seed=7))
    a[0, 0] -= 2 * eps
    lm = float(render_loss(s2._replace(albedo=jnp.asarray(a)), c2, tgt, 32, 2,
                           seed=7))
    g_fd = (lp - lm) / (2 * eps)
    rel = abs(g_ad - g_fd) / max(abs(g_fd), 1e-8)
    check(np.isfinite(float(loss2)) and rel < 0.05, f"albedo FD rel {rel}")
    emit("grad/albedo_fd", ad=g_ad, fd=g_fd, rel_err=rel)

    # Training: SPSA hybrid and the boundary-aware edge estimator.
    full = rtw.scene_random_spheres(seed=1)
    mov = movable_mask(full)
    rng = np.random.default_rng(0)
    jitter = rng.uniform(-0.04, 0.04, np.asarray(full.center).shape)
    start = full._replace(
        center=jnp.asarray(np.asarray(full.center) + jitter * mov[:, None],
                           jnp.float32),
        albedo=jnp.clip(full.albedo * 0.75 + 0.1, 0.0, 1.0))
    for geom, (w, spp, steps), kw in (
            ("spsa", FIT_SPSA, {}),
            ("edge", FIT_EDGE, dict(edge_kwargs=dict(
                edge_bounces=2, pixel_chunk=EDGE_CHUNK, remat_chunks=True,
                sigma_px=3.0)))):
        tgt = rtw.render_radiance(full, cam, w, spp, seed=0)
        t0 = time.perf_counter()
        res = fit_scene(start, cam, tgt, w, spp, steps=steps, geom=geom, **kw)
        wall = time.perf_counter() - t0
        check(len(res.losses) == steps and np.isfinite(res.losses).all(),
              f"fit_scene({geom}) losses {res.losses}")
        check(np.isfinite(np.asarray(res.scene.center)).all(),
              f"fit_scene({geom}) non-finite centers")
        emit(f"grad/fit_scene_{geom}", size=f"{w}x{w * 9 // 16}x{spp}",
             steps=steps, wall_s=wall, step_s=res.step_seconds,
             losses=res.losses)


def phase_gpu_tests() -> None:
    import pytest
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")
    emit("gpu_tests", wall_s=time.perf_counter() - t0, pytest_exit=int(rc))


def phase_mesh() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu.parallel.mesh import make_render_mesh
    from raytracingweekend_jl_tpu.parallel.shard import (
        render_radiance_sharded, sharded_train_step)
    from raytracingweekend_jl_tpu.utils.checkpoint import (
        render_checkpointed_sharded)

    devs = jax.devices()
    scene, cam = flagship()
    tile = MESH_TILE
    mesh1 = make_render_mesh(1, 1, devs[:1])
    meshes = {"1x1": mesh1, "4x1": make_render_mesh(4, 1, devs[:4]),
              "2x2": make_render_mesh(2, 2, devs[:4])}
    imgs = {}
    for name, mesh in meshes.items():
        img, first, steady = timed(
            lambda m=mesh: render_radiance_sharded(
                scene, cam, W, MESH_SPP, mesh=m, tile_size=tile, seed=0,
                persistent=True), repeats=1)
        imgs[name] = np.asarray(img)
        check(np.isfinite(imgs[name]).all(), f"mesh {name} render not finite")
        emit(f"mesh/render_{name}", size=f"{W}x{H}x{MESH_SPP}",
             tile_size=tile, compile_s=first, steady_s=steady,
             mpaths_per_s=W * H * MESH_SPP / steady / 1e6)
    check(np.array_equal(imgs["4x1"], imgs["1x1"]),
          "4x1 mesh image not bitwise the 1x1 image")
    gap = float(np.abs(imgs["2x2"] - imgs["1x1"]).max())
    check(gap <= 1e-6, f"2x2 mesh image off by {gap}")
    emit("mesh/render_compare", bitwise_4x1=True, max_abs_2x2=gap)

    # Sharded training step: 4 cards vs 1 card.
    w, spp, tile_g = TRAIN
    target = rtw.render_radiance(scene, cam, w, spp, seed=1)
    bad = scene._replace(albedo=jnp.clip(scene.albedo * 0.8, 0.0, 1.0))
    out = {}
    for name in ("1x1", "2x2"):
        (loss, upd), first, steady = timed(
            lambda m=meshes[name]: sharded_train_step(
                bad, cam, target, w, spp, mesh=m, lr=1.0, tile_size=tile_g,
                seed=2), repeats=1)
        out[name] = (float(loss), {f: np.asarray(getattr(bad, f))
                                   - np.asarray(getattr(upd, f))
                                   for f in ("center", "radius", "albedo",
                                             "fuzz", "ir")})
        emit(f"mesh/train_step_{name}", size=f"{w}x{w * 9 // 16}x{spp}",
             tile_size=tile_g, compile_s=first, steady_s=steady,
             loss=float(loss))
    (l1, g1), (l4, g4) = out["1x1"], out["2x2"]
    check(abs(l4 - l1) <= 1e-5 * abs(l1), f"loss 4 cards {l4} vs 1 {l1}")
    worst = {}
    for f in g1:
        scale = float(np.abs(g1[f]).max())
        err = float(np.abs(g4[f] - g1[f]).max())
        worst[f] = err / max(scale, 1e-30)
        check(err <= 1e-5 * max(scale, 1e-30),
              f"grad[{f}] 4 cards vs 1: {err} of {scale}")
    emit("mesh/train_step_compare", loss_1=l1, loss_4=l4,
         max_rel_grad_gap=worst)

    # Interrupt-and-resume under the 4x1 mesh must be bitwise one run.
    os.makedirs(OUT_DIR, exist_ok=True)
    ck = os.path.join(OUT_DIR, "mesh_ck.npz")
    if os.path.exists(ck):
        os.remove(ck)
    kw = dict(mesh=meshes["4x1"], spp_chunk=2, tile_size=tile, seed=3)
    t0 = time.perf_counter()
    whole = render_checkpointed_sharded(scene, cam, W, 4, **kw)
    render_checkpointed_sharded(scene, cam, W, 2, checkpoint_path=ck, **kw)
    resumed = render_checkpointed_sharded(scene, cam, W, 4,
                                          checkpoint_path=ck, **kw)
    check(resumed.samples_done == 4, "resume did not finish")
    check(np.array_equal(whole.image, resumed.image),
          "resumed sharded render not bitwise the uninterrupted one")
    emit("mesh/checkpoint_resume", size=f"{W}x{H}x4", spp_chunk=2,
         wall_s=time.perf_counter() - t0, bitwise=True)


PHASES = {"sweep": phase_sweep, "forward": phase_forward, "grad": phase_grad,
          "gpu_tests": phase_gpu_tests, "mesh": phase_mesh}


def main(argv=None) -> int:
    args = parse_args(argv)
    phases = select_phases(args.four_cards)
    count = 4 if args.four_cards else 1
    # Import the package before touching the card: alone, without the
    # repository, this fails here and prints nothing.
    sys.path.insert(0, ROOT)
    import raytracingweekend_jl_tpu  # noqa: F401
    from raytracingweekend_jl_tpu.utils.cache import enable_compilation_cache
    import jax

    require_gpu(jax.devices(), count)
    enable_compilation_cache()
    devices = jax.devices()[:count]
    dev = devices[0]
    t_start = time.perf_counter()
    print(card_line(), flush=True)
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(devices), jax=jax.__version__)
    for name in phases:
        if name == "device":
            continue
        t0 = time.perf_counter()
        PHASES[name]()
        print(json.dumps({"phase_done": name,
                          "wall_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"total_s": time.perf_counter() - t_start}), flush=True)
    print(last_line(dev.platform, dev.device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
