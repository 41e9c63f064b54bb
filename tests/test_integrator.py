"""Integrator semantics tests — the wavefront loop must reproduce the
reference's recursive ray_color contract (reference: src/ray_color.jl:14-38)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingweekend_jl_tpu import (make_scene, lambertian, metal, dielectric,
                                      trace, skycolor, scene_2_spheres)
from raytracingweekend_jl_tpu.ops.materials import scatter
from raytracingweekend_jl_tpu.ops.intersect import intersect_spheres

KEY = jax.random.PRNGKey(0)


def unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def ray(d):
    return (jnp.zeros((1, 3), jnp.float32),
            jnp.asarray([unit(d)], jnp.float32))


def test_all_miss_is_skycolor():
    # Empty scene (padding only) → radiance == skycolor exactly
    # (reference: src/ray_color.jl:35-37).
    scene = make_scene([])
    dirs = np.stack([unit([0, 1, 0]), unit([0, -1, 0]), unit([1, 0.3, -1])])
    o = jnp.zeros((3, 3), jnp.float32)
    d = jnp.asarray(dirs, jnp.float32)
    rad = np.asarray(trace(scene, o, d, KEY))
    expect = np.asarray(skycolor(d))
    np.testing.assert_allclose(rad, expect, atol=1e-6)
    # Spot-check the lerp itself: dir.y=1 → skyblue, dir.y=-1 → white
    # (reference: src/ray_color.jl:1-6).
    np.testing.assert_allclose(rad[0], [0.5, 0.7, 1.0], atol=1e-6)
    np.testing.assert_allclose(rad[1], [1.0, 1.0, 1.0], atol=1e-6)


def test_depth_zero_black():
    scene = make_scene([])
    o, d = ray([0, 0, -1])
    rad = np.asarray(trace(scene, o, d, KEY, max_depth=0))
    np.testing.assert_array_equal(rad, 0.0)


def test_depth_exhaustion_black():
    # Ray trapped hitting a lambertian with max_depth=1: one scatter then the
    # loop ends with the ray alive → black (reference: depth-1 recursion
    # bottoming out at src/ray_color.jl:15-17).
    scene = make_scene([lambertian((0, 0, -1), 0.5, (1.0, 1.0, 1.0))])
    o, d = ray([0, 0, -1])
    rad = np.asarray(trace(scene, o, d, KEY, max_depth=1))
    np.testing.assert_array_equal(rad, 0.0)


def test_perfect_mirror_deterministic():
    # Fuzz-0 metal floor: ray down 45° reflects up 45° into the sky; radiance
    # must equal albedo * skycolor(reflected_dir) exactly (no randomness used
    # in the taken branch).
    albedo = np.array([0.8, 0.6, 0.4])
    center = np.array([0.0, -100.0, 0.0])
    radius = 99.0
    scene = make_scene([metal(center, radius, albedo, 0.0)])
    d_in = unit([1, -1, 0])
    o_np = np.array([0.0, 2.0, 0.0])
    rad = np.asarray(trace(scene, jnp.asarray([o_np], jnp.float32),
                           jnp.asarray([d_in], jnp.float32), KEY))
    # Float64 oracle: quadratic hit, curved-surface normal, mirror reflect,
    # then the sky lerp (reference: src/hit.jl, src/light.jl:6,
    # src/ray_color.jl:1-6).
    oc = o_np - center
    half_b = oc @ d_in
    cc = oc @ oc - radius ** 2
    t_hit = -half_b - np.sqrt(half_b ** 2 - cc)
    p = o_np + t_hit * d_in
    n = (p - center) / radius
    d_out = d_in - 2 * (d_in @ n) * n
    sky_t = 0.5 * (d_out[1] + 1.0)
    sky = (1 - sky_t) * np.array([1.0, 1.0, 1.0]) + sky_t * np.array([0.5, 0.7, 1.0])
    np.testing.assert_allclose(rad[0], albedo * sky, rtol=1e-3)


def test_glass_straight_through():
    # Normal incidence on glass: refraction keeps the direction, ray passes
    # through both surfaces and reaches the sky with attenuation (1,1,1)
    # — unless the Schlick coin reflects; at normal incidence for ir=1.5 the
    # reflectance is 0.04, so with many rays ≥90% go through identically.
    scene = make_scene([dielectric((0, 0, -2), 0.5, 1.5)])
    R = 256
    o = jnp.zeros((R, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (R, 1))
    rad = np.asarray(trace(scene, o, d, KEY))
    sky_fwd = np.asarray(skycolor(d))[0]
    through = np.isclose(rad, sky_fwd, atol=1e-5).all(axis=-1).mean()
    assert through > 0.85, through


def test_lambertian_energy_bounds():
    scene = scene_2_spheres()
    rng = np.random.default_rng(3)
    d = rng.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rad = np.asarray(trace(scene, jnp.zeros((512, 3), jnp.float32),
                           jnp.asarray(d, jnp.float32), KEY))
    assert np.all(rad >= 0.0)
    assert np.all(rad <= 1.0 + 1e-5)  # sky max is 1, albedos < 1
    assert np.isfinite(rad).all()


def test_scatter_normal_orientation():
    # front_face logic: hitting a sphere from outside → normal opposes ray
    # (reference: src/hit.jl:6-10); metal reflection then has positive
    # outgoing component along the normal.
    scene = make_scene([metal((0, 0, -1), 0.5, (1, 1, 1), 0.0)])
    o = jnp.zeros((1, 3), jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    res = intersect_spheres(o, d, scene)
    s = scatter(scene, o, d, res.t, res.index, KEY)
    np.testing.assert_allclose(np.asarray(s.origin)[0], [0, 0, -0.5], atol=1e-5)
    np.testing.assert_allclose(np.asarray(s.direction)[0], [0, 0, 1], atol=1e-5)


def test_trace_remat_matches():
    scene = scene_2_spheres()
    rng = np.random.default_rng(4)
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.zeros((64, 3), jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    a = np.asarray(trace(scene, o, d, KEY, remat=False))
    b = np.asarray(trace(scene, o, d, KEY, remat=True))
    np.testing.assert_allclose(a, b, atol=1e-6)


def _onehot_rows(index, attr, n):
    """``attr[index]`` as a one-hot [R,N] @ [N,F] product with the float32
    table split into three exact bf16 parts (hi + mid + lo == attr) — the
    matrix-unit form of the attribute fetch, kept here as an independent
    formulation of the gather."""
    hi = attr.astype(jnp.bfloat16)
    rem = attr - hi.astype(jnp.float32)
    mid = rem.astype(jnp.bfloat16)
    lo = (rem - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    f = attr.shape[1]
    onehot = (index[:, None] == jnp.arange(n)[None, :]).astype(jnp.bfloat16)
    rows3 = jnp.dot(onehot, jnp.concatenate([hi, mid, lo], axis=1),
                    preferred_element_type=jnp.float32)
    return rows3[:, :f] + rows3[:, f:2 * f] + rows3[:, 2 * f:]


def _attr_table(scene):
    return jnp.concatenate([scene.center, scene.radius[:, None], scene.albedo,
                            scene.fuzz[:, None], scene.ir[:, None],
                            scene.mat[:, None].astype(jnp.float32)], axis=1)


@pytest.mark.parametrize("name", ["2_spheres", "4_spheres", "diel_spheres",
                                  "diel_spheres_hollow", "blue_red_spheres",
                                  "random_spheres"])
def test_onehot_rows_exact_matches_gather(name):
    # The gather the shading stage uses must equal the exact one-hot
    # contraction bitwise, so replacing one with the other moves no image.
    from raytracingweekend_jl_tpu import ALL_SCENES, scene_random_spheres
    from raytracingweekend_jl_tpu.ops.materials import gather_sphere_attrs
    scene = (scene_random_spheres(seed=1) if name == "random_spheres"
             else ALL_SCENES[name]())
    idx = jax.random.randint(jax.random.PRNGKey(0), (4096,), 0, scene.n_spheres)
    rows = np.asarray(_onehot_rows(idx, _attr_table(scene), scene.n_spheres))
    c, r, a, f, ir, m = (np.asarray(x) for x in
                         gather_sphere_attrs(scene, idx, jnp.float32))
    np.testing.assert_array_equal(rows[:, 0:3], c)
    np.testing.assert_array_equal(rows[:, 3], r)
    np.testing.assert_array_equal(rows[:, 4:7], a)
    np.testing.assert_array_equal(rows[:, 7], f)
    np.testing.assert_array_equal(rows[:, 8], ir)
    np.testing.assert_array_equal(rows[:, 9].astype(np.int32), m)


def test_onehot_cols_exact_matches_gather():
    # The transposed one-hot form ([F,N] @ [N,R]) is the same gather.
    from raytracingweekend_jl_tpu import scene_random_spheres
    scene = scene_random_spheres(seed=1)
    attr = _attr_table(scene)
    idx = jax.random.randint(jax.random.PRNGKey(0), (4096,), 0, scene.n_spheres)
    cols = np.asarray(_onehot_rows(idx, attr, scene.n_spheres)).T
    np.testing.assert_array_equal(cols, np.asarray(attr)[np.asarray(idx)].T)


@pytest.mark.parametrize("skew", [False, True])
def test_gather_rows_vjp_matches_scatter_add(skew):
    # gather_rows sums its cotangents with a one-hot matrix product; the
    # result must be the scatter-add autodiff of a plain gather, including
    # when most rays pick the same row (the ground sphere).
    from raytracingweekend_jl_tpu.ops.materials import gather_rows
    table = jax.random.normal(jax.random.PRNGKey(1), (37, 9))
    idx = jax.random.randint(jax.random.PRNGKey(2), (5000,), 0, 37)
    if skew:
        idx = jnp.where(jnp.arange(5000) % 5 == 0, idx, 3)
    w = jax.random.normal(jax.random.PRNGKey(3), (5000, 9))
    np.testing.assert_array_equal(np.asarray(gather_rows(table, idx)),
                                  np.asarray(table[idx]))
    g = jax.grad(lambda t: jnp.sum(gather_rows(t, idx) * w))(table)
    g_ref = jax.grad(lambda t: jnp.sum(t[idx] * w))(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,f", [(1, 1), (37, 4), (488, 9)])
def test_sum_rows_matches_float64_sums(n, f):
    # sum_rows' per-sphere sums against float64 sums; spheres no ray picks
    # stay exactly zero.
    from raytracingweekend_jl_tpu.ops.materials import sum_rows
    idx = jax.random.randint(jax.random.PRNGKey(4), (3000,), 0, max(n // 2, 1))
    rows = jax.random.normal(jax.random.PRNGKey(5), (3000, f))
    got = np.asarray(sum_rows(idx, rows, n))
    ref = np.zeros((n, f))
    np.add.at(ref, np.asarray(idx), np.asarray(rows, np.float64))
    assert got.shape == (n, f) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[max(n // 2, 1):], 0.0)


def test_total_internal_reflection():
    # A ray inside glass beyond the critical angle must mirror-reflect
    # deterministically (cannot_refract, reference: src/material.jl:45-48).
    # Unit glass sphere; exit point p=(0,0,1); direction at 60 deg from the
    # outward normal (critical angle for ir=1.5 is ~41.8 deg).
    from raytracingweekend_jl_tpu.ops.materials import scatter as scat
    scene = make_scene([dielectric((0, 0, 0), 1.0, 1.5)])
    n = np.array([0.0, 0.0, 1.0])
    d = np.array([np.sin(np.deg2rad(60.0)), 0.0, np.cos(np.deg2rad(60.0))])
    o = n - 0.9 * d                       # inside the sphere (|o| ~ 0.954)
    o_j = jnp.asarray([o], jnp.float32)
    d_j = jnp.asarray([d], jnp.float32)
    res = intersect_spheres(o_j, d_j, scene)
    assert bool(res.hit[0])
    np.testing.assert_allclose(float(res.t[0]), 0.9, atol=1e-5)
    s_out = scat(scene, o_j, d_j, res.t, res.index, KEY)
    d_out = np.asarray(s_out.direction)[0]
    # TIR is deterministic (no Schlick coin): exact mirror about the normal,
    # outgoing ray stays inside (negative outward component).
    expect = d - 2 * (d @ n) * n
    np.testing.assert_allclose(d_out, expect, atol=1e-5)
    assert d_out @ n < 0
