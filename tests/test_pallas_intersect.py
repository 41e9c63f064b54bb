"""Pallas sweep kernel (``backend="triton"``, interpret mode on the CPU) vs
the XLA intersection path and the float64 oracle, its padding and tie rules,
and the analytic custom-VJP against autodiff of the XLA sweep."""

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytracingweekend_jl_tpu as rtw
from raytracingweekend_jl_tpu import (make_scene, lambertian, scene_random_spheres,
                                      intersect_spheres, t_cam1)
from raytracingweekend_jl_tpu.camera import get_rays
from raytracingweekend_jl_tpu.ops import integrator
from raytracingweekend_jl_tpu.ops.intersect import BIG
from raytracingweekend_jl_tpu.ops.pallas import intersect_kernel
from raytracingweekend_jl_tpu.ops.pallas.intersect_kernel import (
    intersect_spheres_pallas, _sweep, sweep_forward, sphere_table)
from raytracingweekend_jl_tpu.render import pixel_coords
from raytracingweekend_jl_tpu.scene import trim_scene

sys.path.insert(0, os.path.dirname(__file__))
from test_intersect import oracle_hit_batch  # noqa: E402

KEY = jax.random.PRNGKey(0)

CAMS = {"2_spheres": rtw.t_default_cam, "4_spheres": rtw.t_default_cam,
        "diel_spheres": rtw.t_default_cam,
        "diel_spheres_hollow": rtw.hollow_glass_cam,
        "blue_red_spheres": rtw.t_default_cam, "random_spheres": rtw.t_cam1}


def scene_of(name):
    s = (rtw.scene_random_spheres(seed=1) if name == "random_spheres"
         else rtw.ALL_SCENES[name]())
    return trim_scene(s)


def camera_and_bounce_rays(name, n):
    """``n`` rays of a scene: camera rays from a 64x36 film, then one
    scattered bounce for those that hit (secondary rays start on surfaces,
    the hard case for tmin and the near root)."""
    scene = scene_of(name)
    u, v = pixel_coords(64, 36)
    o, d = get_rays(CAMS[name](), u, v, KEY)
    res = intersect_spheres(o, d, scene)
    sc = rtw.scatter(scene, o, d, jnp.where(res.hit, res.t, 1.0), res.index,
                     jax.random.PRNGKey(1))
    o2 = jnp.where(res.hit[:, None], sc.origin, o)
    d2 = jnp.where(res.hit[:, None], sc.direction, d)
    o = jnp.concatenate([o, o2])[:n]
    d = jnp.concatenate([d, d2])[:n]
    return scene, o, d


def random_rays(n, seed=0, box=3.0):
    g = np.random.default_rng(seed)
    o = g.uniform(-box, box, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_kernel_matches_xla_random_scene():
    scene = scene_random_spheres(seed=1)
    o, d = random_rays(1024, seed=3, box=6.0)
    ref = intersect_spheres(o, d, scene)
    out = intersect_spheres_pallas(o, d, scene, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(out.hit))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(ref.index)[hit],
                                  np.asarray(out.index)[hit])
    np.testing.assert_allclose(np.asarray(ref.t)[hit], np.asarray(out.t)[hit],
                               rtol=1e-3, atol=1e-3)


def test_kernel_camera_rays():
    scene = scene_random_spheres(seed=1)
    u, v = pixel_coords(64, 36)
    o, d = get_rays(t_cam1(), u, v, KEY)
    ref = intersect_spheres(o, d, scene)
    out = intersect_spheres_pallas(o, d, scene, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(out.hit))
    hit = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(ref.t)[hit], np.asarray(out.t)[hit],
                               rtol=1e-3, atol=1e-3)


def test_kernel_nonmultiple_ray_count():
    scene = make_scene([lambertian((0, 0, -1), 0.5, (1, 1, 1))])
    o, d = random_rays(1000, seed=1)  # not a multiple of 128 or 4096
    ref = intersect_spheres(o, d, scene)
    out = intersect_spheres_pallas(o, d, scene, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(out.hit))


def test_custom_vjp_matches_xla_grads():
    scene = make_scene([
        lambertian((0, 0, -2), 0.6, (1, 1, 1)),
        lambertian((1.5, 0, -3), 0.8, (1, 1, 1)),
    ], pad_to=4)
    o, d = random_rays(256, seed=5, box=1.0)

    def loss_pallas(centers, radius, o, d):
        t, idx = _sweep(o, d, (centers, radius), 1e-4, True)
        return jnp.sum(jnp.where(t < 1e30, t, 0.0))

    def loss_xla(centers, radius, o, d):
        s2 = scene._replace(center=centers, radius=radius)
        res = intersect_spheres(o, d, s2)
        return jnp.sum(jnp.where(res.hit, res.t, 0.0))

    args = (scene.center, scene.radius, o, d)
    g_p = jax.grad(loss_pallas, argnums=(0, 1, 2, 3))(*args)
    g_x = jax.grad(loss_xla, argnums=(0, 1, 2, 3))(*args)
    for a, b, name in zip(g_p[:3], g_x[:3], ("centers", "radius", "origin")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-4, err_msg=name)
    # The direction gradients agree only in the tangent space of the unit
    # sphere: the XLA path freezes a == 1 (valid on |d| = 1) so its d-gradient
    # omits the radial da/dd term, while the implicit-diff backward gives the
    # unconstrained geometric gradient. Both are correct end-to-end because
    # upstream `normalize` projects out the radial component in its VJP.
    dv = np.asarray(d)
    proj = lambda g: g - (np.sum(g * dv, -1, keepdims=True)) * dv
    np.testing.assert_allclose(proj(np.asarray(g_p[3])), proj(np.asarray(g_x[3])),
                               rtol=2e-3, atol=2e-4, err_msg="dir (tangential)")


def test_custom_vjp_finite_diff():
    # Analytic implicit-differentiation backward vs central differences (f64).
    with jax.enable_x64(True):
        centers = jnp.asarray([[0.0, 0.0, -2.0]], jnp.float64)
        radius = jnp.asarray([0.6], jnp.float64)
        o = jnp.asarray([[0.1, -0.2, 0.0]], jnp.float64)
        d_raw = np.array([0.05, 0.02, -1.0])
        d = jnp.asarray([d_raw / np.linalg.norm(d_raw)], jnp.float64)

        # Use the XLA path as the function (same t), grads via the SAME
        # analytic formulas evaluated in f64 through the pallas wrapper is not
        # f64-capable; instead check the f32 analytic grad against f64 FD of
        # the XLA t.
        def t_of(c0z):
            c = centers.at[0, 2].set(c0z)
            s = make_scene([lambertian((0, 0, -2), 0.6, (1, 1, 1))], pad_to=1,
                           dtype=jnp.float64)
            s = s._replace(center=c, radius=radius)
            return float(intersect_spheres(o, d, s).t[0])

        eps = 1e-6
        fd = (t_of(-2.0 + eps) - t_of(-2.0 - eps)) / (2 * eps)

    s32 = make_scene([lambertian((0, 0, -2), 0.6, (1, 1, 1))], pad_to=1)

    def loss(c):
        t, _ = _sweep(jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
                      (c, s32.radius), 1e-4, True)
        return t[0]

    g = jax.grad(loss)(s32.center)
    np.testing.assert_allclose(float(g[0, 2]), fd, rtol=1e-3)




# Ray counts that are and are not multiples of the kernel's ray block.
RAY_COUNTS = [2 * intersect_kernel.BLOCK_RAYS, 2 * intersect_kernel.BLOCK_RAYS + 37]


@pytest.mark.parametrize("n_rays", RAY_COUNTS)
@pytest.mark.parametrize("name", sorted(CAMS))
def test_kernel_matches_xla_scenes(name, n_rays):
    scene, o, d = camera_and_bounce_rays(name, n_rays)
    ref = intersect_spheres(o, d, scene)
    out = intersect_spheres_pallas(o, d, scene, interpret=True)
    assert out.t.shape == (n_rays,) and out.index.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(out.hit))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(ref.index)[hit],
                                  np.asarray(out.index)[hit])
    np.testing.assert_allclose(np.asarray(ref.t)[hit], np.asarray(out.t)[hit],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", sorted(CAMS))
def test_kernel_matches_f64_oracle(name):
    scene, o, d = camera_and_bounce_rays(name, 300)
    out = intersect_spheres_pallas(o, d, scene, interpret=True)
    et, ei = oracle_hit_batch(np.asarray(o), np.asarray(d),
                              np.asarray(scene.center), np.asarray(scene.radius))
    hit = np.asarray(out.hit)
    np.testing.assert_array_equal(hit, ei >= 0)
    np.testing.assert_array_equal(np.asarray(out.index)[hit], ei[hit])
    np.testing.assert_allclose(np.asarray(out.t)[hit], et[hit],
                               rtol=1e-3, atol=1e-3)


def test_padding_spheres_never_win():
    # Three spheres pad to a multiple of the unroll factor with ck = BIG
    # entries centred at the origin; rays from the origin must not hit them.
    scene = make_scene([lambertian((0, 0, -3), 0.5, (1, 1, 1)),
                        lambertian((0, 5, 0), 0.5, (1, 1, 1)),
                        lambertian((7, 0, 0), 0.5, (1, 1, 1))], pad_to=1)
    assert scene.n_spheres % intersect_kernel.UNROLL != 0
    planes = sphere_table(scene.center, jnp.zeros((3,)))
    assert planes[0].shape[0] % intersect_kernel.UNROLL == 0
    assert float(planes[3][-1]) == np.float32(BIG)
    o, d = random_rays(300, seed=11, box=0.0)  # every ray starts at 0
    out = intersect_spheres_pallas(o, d, scene, interpret=True)
    ref = intersect_spheres(o, d, scene)
    np.testing.assert_array_equal(np.asarray(out.hit), np.asarray(ref.hit))
    assert int(np.asarray(out.index).max()) < 3


def test_ties_pick_lowest_index():
    # Identical spheres tie exactly: jnp.argmin's rule is the lowest index,
    # also across the unroll boundary (indices 1 and 6).
    spheres = [lambertian((0, 0, 9), 0.5, (1, 1, 1))] * 8
    spheres[1] = spheres[6] = lambertian((0, 0, -2), 0.5, (1, 1, 1))
    scene = make_scene(spheres, pad_to=1)
    o = jnp.zeros((5, 3), jnp.float32)
    d = jnp.asarray([[0, 0, -1.0]] * 5, jnp.float32)
    out = intersect_spheres_pallas(o, d, scene, interpret=True)
    ref = intersect_spheres(o, d, scene)
    assert np.asarray(out.index).tolist() == [1] * 5
    np.testing.assert_array_equal(np.asarray(out.index), np.asarray(ref.index))


def test_all_miss_gives_big_and_index_zero():
    scene = make_scene([lambertian((0, 0, -2), 0.5, (1, 1, 1))])
    o = jnp.zeros((7, 3), jnp.float32)
    d = jnp.asarray([[0, 1.0, 0]] * 7, jnp.float32)
    out = intersect_spheres_pallas(o, d, scene, interpret=True)
    assert not np.asarray(out.hit).any()
    assert (np.asarray(out.t) == np.float32(BIG)).all()
    assert (np.asarray(out.index) == 0).all()


@pytest.mark.parametrize("block", [32, 64, 512])
def test_block_size_does_not_change_results(block):
    scene = scene_random_spheres(seed=1)
    o, d = random_rays(777, seed=4, box=6.0)
    ck = jnp.sum(scene.center ** 2, -1) - scene.radius ** 2
    a = sweep_forward(o, d, scene.center, ck, 1e-4, interpret=True)
    b = sweep_forward(o, d, scene.center, ck, 1e-4, interpret=True,
                      block=block)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


@pytest.mark.parametrize("name", ["4_spheres", "diel_spheres_hollow",
                                  "random_spheres"])
def test_vjp_matches_autodiff_of_xla_sweep(name):
    scene, o, d = camera_and_bounce_rays(name, 256)
    w = jax.random.uniform(jax.random.PRNGKey(5), (256,))

    def loss_kernel(centers, radius, o):
        t, _ = _sweep(o, d, (centers, radius), 1e-4, True)
        return jnp.sum(w * jnp.where(t < 1e30, t, 0.0))

    def loss_xla(centers, radius, o):
        res = intersect_spheres(o, d, scene._replace(center=centers,
                                                     radius=radius))
        return jnp.sum(w * jnp.where(res.hit, res.t, 0.0))

    args = (scene.center, scene.radius, o)
    g_k = jax.grad(loss_kernel, argnums=(0, 1, 2))(*args)
    g_x = jax.grad(loss_xla, argnums=(0, 1, 2))(*args)
    for a, b, field in zip(g_k, g_x, ("centers", "radius", "origin")):
        scale = float(np.abs(np.asarray(b)).max()) + 1e-6
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3 * scale,
                                   err_msg=f"{name}/{field}")


def _interpreted_kernel(monkeypatch):
    """Route the integrators' kernel path through the Pallas interpreter."""
    monkeypatch.setattr(intersect_kernel, "intersect_spheres_pallas",
                        partial(intersect_spheres_pallas, interpret=True))


def test_trace_through_kernel_matches_xla(monkeypatch):
    _interpreted_kernel(monkeypatch)
    scene = scene_random_spheres(seed=1)
    u, v = pixel_coords(24, 12)
    o, d = get_rays(t_cam1(), u, v, KEY)
    a = np.asarray(rtw.trace(scene, o, d, KEY, max_depth=6, use_pallas=True))
    b = np.asarray(rtw.trace(scene, o, d, KEY, max_depth=6, use_pallas=False))
    assert np.isfinite(a).all()
    # Same RNG stream; paths diverge only where f32 rounding flips a
    # decision, which is rare on 288 rays.
    assert np.mean(np.all(np.abs(a - b) < 1e-4, axis=-1)) > 0.95


def test_f64_rays_take_the_xla_sweep():
    # The kernel is f32-only: f64 rays route to ops/intersect.py, a dtype
    # route that needs no kernel (no interpret flag is set here).
    with jax.enable_x64(True):
        scene = make_scene([lambertian((0, 0, -2), 0.5, (1, 1, 1))],
                           dtype=jnp.float64)
        o = jnp.zeros((3, 3), jnp.float64)
        d = jnp.asarray([[0, 0, -1.0]] * 3, jnp.float64)
        res, attrs = integrator._pick_intersector(True)(o, d, scene, 1e-4)
        assert res.t.dtype == jnp.float64 and attrs is None
        np.testing.assert_allclose(np.asarray(res.t), 1.5, atol=1e-12)


@pytest.mark.parametrize("backend,expected", [("gpu", True), ("cpu", False)])
def test_use_sweep_kernel_decision(backend, expected):
    from raytracingweekend_jl_tpu.utils.platform import use_sweep_kernel
    assert use_sweep_kernel(backend) is expected


def test_default_intersector_on_cpu_is_xla():
    from raytracingweekend_jl_tpu.utils.platform import use_sweep_kernel
    assert use_sweep_kernel() is False  # this suite pins the CPU
    isect = integrator._pick_intersector()
    scene = make_scene([lambertian((0, 0, -2), 0.5, (1, 1, 1))])
    o, d = random_rays(64, seed=2, box=0.5)
    res, _ = isect(o, d, scene, 1e-4)
    ref = intersect_spheres(o, d, scene)
    np.testing.assert_array_equal(np.asarray(res.t), np.asarray(ref.t))
