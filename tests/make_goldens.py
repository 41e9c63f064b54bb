"""Golden-fixture generator (run deliberately, on the CPU backend):

    python tests/make_goldens.py [base|persistent|hires|all]

- base: renders_64x36_spp4.npz — the plain-path goldens (all six scenes).
- persistent: persistent_64x36_spp4.npz — PER-PIXEL goldens for the
  persistent-wavefront integrator (ops/integrator.persistent_render_sum) on
  all six scenes. Its RNG is counter-based threefry, so these pin its
  shading and in-place regeneration math exactly.
- hires: renders_256x144_spp64.npz — a 16x-resolution / 16x-spp golden of the
  flagship scene. Low Monte-Carlo noise => tight on-device thresholds in
  chip_smoke.py (mismatch fraction <= 2%).

Regenerating overwrites fixtures: only do it when a change is SUPPOSED to
alter images, and say so in the commit message.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import raytracingweekend_jl_tpu as rtw  # noqa: E402
from raytracingweekend_jl_tpu.render import pixel_coords  # noqa: E402
from raytracingweekend_jl_tpu.ops.integrator import (  # noqa: E402
    persistent_render_sum)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

CAMS = {"2_spheres": rtw.t_default_cam, "4_spheres": rtw.t_default_cam,
        "diel_spheres": rtw.t_default_cam,
        "diel_spheres_hollow": rtw.hollow_glass_cam,
        "blue_red_spheres": rtw.t_default_cam, "random_spheres": rtw.t_cam1}


def scene_of(name):
    return (rtw.scene_random_spheres(seed=1) if name == "random_spheres"
            else rtw.ALL_SCENES[name]())


def gen_base():
    out = {}
    for name in sorted(CAMS):
        out[name] = np.asarray(rtw.render_radiance(
            scene_of(name), CAMS[name](), 64, 4, seed=0))
        print("base", name, flush=True)
    np.savez(os.path.join(GOLDEN_DIR, "renders_64x36_spp4.npz"), **out)


def gen_persistent():
    key = jax.random.PRNGKey(0)
    W, H, spp = 64, 36, 4
    u, v = pixel_coords(W, H)
    fw, fh = float(np.float32(W)), float(np.float32(H))
    out = {}
    for name in sorted(CAMS):
        out[name] = np.asarray(persistent_render_sum(
            scene_of(name), CAMS[name](), u, v, key, spp, 0, 16, 1e-4,
            fw, fh))
        print("persistent", name, flush=True)
    np.savez(os.path.join(GOLDEN_DIR, "persistent_64x36_spp4.npz"), **out)


def gen_hires():
    img = np.asarray(rtw.render_radiance(
        scene_of("random_spheres"), rtw.t_cam1(), 256, 64, seed=0,
        rays_per_pass=1 << 21))
    np.savez(os.path.join(GOLDEN_DIR, "renders_256x144_spp64.npz"),
             random_spheres=img)
    print("hires random_spheres", flush=True)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("base", "all"):
        gen_base()
    if which in ("persistent", "all"):
        gen_persistent()
    if which in ("hires", "all"):
        gen_hires()
