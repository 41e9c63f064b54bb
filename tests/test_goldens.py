"""Golden-image regression tests — the image-content safety net SURVEY.md §4
says the reference lacks ('no image content is asserted'). Fixtures are linear
radiance renders (64x36, 4 spp, seed 0) produced by this package on the CPU
backend; any change to camera math, intersection, materials, integrator, or
RNG streams shows up here immediately.

Regenerate deliberately with tests/make_goldens (see repo README) when a
change is *supposed* to alter images.
"""

import os

import numpy as np
import pytest

import raytracingweekend_jl_tpu as rtw

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "renders_64x36_spp4.npz")

CAMS = {"2_spheres": rtw.t_default_cam, "4_spheres": rtw.t_default_cam,
        "diel_spheres": rtw.t_default_cam,
        "diel_spheres_hollow": rtw.hollow_glass_cam,
        "blue_red_spheres": rtw.t_default_cam, "random_spheres": rtw.t_cam1}


@pytest.mark.parametrize("name", sorted(CAMS))
def test_golden_render(name):
    goldens = np.load(GOLDEN_PATH)
    scene = (rtw.scene_random_spheres(seed=1) if name == "random_spheres"
             else rtw.ALL_SCENES[name]())
    img = np.asarray(rtw.render_radiance(scene, CAMS[name](), 64, 4, seed=0))
    # Same backend + same code => tight; fusion-order drift tolerated at 1e-5.
    np.testing.assert_allclose(img, goldens[name], atol=1e-5,
                               err_msg=f"golden drift in {name}")


PERSISTENT_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                                 "persistent_64x36_spp4.npz")


@pytest.mark.parametrize("name", sorted(CAMS))
def test_persistent_golden(name):
    # PER-PIXEL goldens for the persistent-wavefront integrator (the
    # production forward): its threefry streams are counter-based, so any
    # drift in its shading or in-place regeneration math — not just its
    # mean — fails here.
    import jax
    from raytracingweekend_jl_tpu.render import pixel_coords
    from raytracingweekend_jl_tpu.ops.integrator import persistent_render_sum

    goldens = np.load(PERSISTENT_GOLDEN)
    scene = (rtw.scene_random_spheres(seed=1) if name == "random_spheres"
             else rtw.ALL_SCENES[name]())
    W, H = 64, 36
    u, v = pixel_coords(W, H)
    fw, fh = float(np.float32(W)), float(np.float32(H))
    img = persistent_render_sum(scene, CAMS[name](), u, v,
                                jax.random.PRNGKey(0), 4, 0, 16, 1e-4, fw, fh)
    np.testing.assert_allclose(np.asarray(img), goldens[name], atol=1e-5,
                               err_msg=f"persistent golden drift in {name}")
