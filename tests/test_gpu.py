"""Tests that need an NVIDIA GPU: the sweep kernel compiled for the card (no
interpret mode) and the integrators that call it. They skip elsewhere;
``python chip_smoke.py`` runs them on the card."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytracingweekend_jl_tpu as rtw
from raytracingweekend_jl_tpu.camera import get_rays
from raytracingweekend_jl_tpu.ops.intersect import intersect_spheres
from raytracingweekend_jl_tpu.ops.pallas.intersect_kernel import (
    intersect_spheres_pallas)
from raytracingweekend_jl_tpu.render import pixel_coords
from raytracingweekend_jl_tpu.scene import trim_scene

pytestmark = pytest.mark.gpu

KEY = jax.random.PRNGKey(0)


def _camera_rays(w=256, h=144):
    scene = trim_scene(rtw.scene_random_spheres(seed=1))
    u, v = pixel_coords(w, h)
    o, d = get_rays(rtw.t_cam1(), u, v, KEY)
    return scene, o, d


def test_sweep_kernel_compiles_and_matches_xla():
    scene, o, d = _camera_rays()
    out = jax.jit(lambda o, d: intersect_spheres_pallas(o, d, scene))(o, d)
    ref = intersect_spheres(o, d, scene)
    assert out.t.shape == ref.t.shape and out.index.dtype == jnp.int32
    # Different product rounding (cuBLAS vs the kernel) may flip a grazing
    # ray; the flagship measures ~1e-5 of primary rays (chip_smoke.py).
    agree = np.asarray(out.index) == np.asarray(ref.index)
    assert agree.mean() >= 0.999
    both = agree & np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(out.t)[both],
                               np.asarray(ref.t)[both], rtol=1e-3, atol=1e-3)


def test_integrators_call_the_kernel_on_the_card():
    from raytracingweekend_jl_tpu.utils.platform import use_sweep_kernel
    assert use_sweep_kernel()
    scene, o, d = _camera_rays(32, 18)
    text = jax.jit(rtw.trace, static_argnames=("max_depth",)).lower(
        scene, o, d, KEY, max_depth=2).as_text()
    assert "sphere_sweep" in text


def test_gradient_through_the_kernel_matches_xla():
    scene, o, d = _camera_rays(64, 36)

    def loss(albedo, use_pallas):
        s = scene._replace(albedo=albedo)
        return jnp.mean(rtw.trace(s, o, d, KEY, max_depth=4, remat=True,
                                  use_pallas=use_pallas))

    g_k = np.asarray(jax.grad(loss)(scene.albedo, True))
    g_x = np.asarray(jax.grad(loss)(scene.albedo, False))
    assert np.isfinite(g_k).all()
    scale = np.abs(g_x).max()
    assert np.abs(g_k - g_x).max() <= 0.05 * scale


def test_persistent_render_on_the_card_matches_cpu_golden():
    goldens = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                   "renders_64x36_spp4.npz"))
    img = np.asarray(rtw.render_radiance(rtw.scene_random_spheres(seed=1),
                                         rtw.t_cam1(), 64, 4, seed=0,
                                         persistent=True))
    assert np.isfinite(img).all()
    assert abs(float(img.mean()) - float(goldens["random_spheres"].mean())) \
        < 0.015
