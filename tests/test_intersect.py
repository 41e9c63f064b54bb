"""Intersection sweep vs. a NumPy float64 oracle that transcribes the
reference's per-ray/per-sphere algorithm literally (reference: src/hit.jl:12-50):
half-b quadratic with a == 1, near-root-then-far-root selection in
[tmin, closest], shrinking-closest linear scan."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracingweekend_jl_tpu import (Scene, make_scene, lambertian, dielectric,
                                      intersect_spheres, scene_diel_spheres_hollow)
from raytracingweekend_jl_tpu.ops.intersect import BIG


def oracle_hit(origin, direction, centers, radii, tmin=1e-4):
    """Reference hit(HittableList,...) in float64 (src/hit.jl:38-50)."""
    best_t, best_i = np.inf, -1
    for i, (c, r) in enumerate(zip(centers, radii)):
        if r == 0:
            continue
        oc = origin - c
        half_b = oc @ direction
        cc = oc @ oc - r * r
        disc = half_b * half_b - cc
        if disc < 0:
            continue
        sq = np.sqrt(disc)
        root = -half_b - sq
        if root < tmin or root > best_t:
            root = -half_b + sq
            if root < tmin or root > best_t:
                continue
        best_t, best_i = root, i
    return best_t, best_i


def oracle_hit_batch(origins, dirs, centers, radii, tmin=1e-4):
    """:func:`oracle_hit` vectorised over rays, float64: the same
    shrinking-closest scan, one sphere at a time in list order. Returns
    ``(t [R], index [R])`` with ``inf``/``-1`` for misses."""
    o = np.asarray(origins, np.float64)
    d = np.asarray(dirs, np.float64)
    best_t = np.full(len(o), np.inf)
    best_i = np.full(len(o), -1, np.int64)
    for i, (c, r) in enumerate(zip(np.asarray(centers, np.float64),
                                   np.asarray(radii, np.float64))):
        if r == 0:
            continue
        oc = o - c
        half_b = np.einsum("ij,ij->i", oc, d)
        cc = np.einsum("ij,ij->i", oc, oc) - r * r
        disc = half_b * half_b - cc
        sq = np.sqrt(np.maximum(disc, 0.0))
        near = -half_b - sq
        far = -half_b + sq
        near_bad = (near < tmin) | (near > best_t)
        far_bad = (far < tmin) | (far > best_t)
        root = np.where(near_bad, far, near)
        take = (disc >= 0) & ~(near_bad & far_bad)
        best_t = np.where(take, root, best_t)
        best_i = np.where(take, i, best_i)
    return best_t, best_i


def random_scene_arrays(rng, n):
    centers = rng.uniform(-5, 5, (n, 3))
    radii = rng.uniform(0.2, 2.0, n) * rng.choice([1.0, -1.0], n)  # signed radii
    return centers, radii


def run_compare(centers, radii, origins, dirs, tmin=1e-4, atol=1e-3):
    scene = make_scene(
        [lambertian(c, r, (0.5, 0.5, 0.5)) for c, r in zip(centers, radii)],
        dtype=jnp.float32)
    res = intersect_spheres(jnp.asarray(origins, jnp.float32),
                            jnp.asarray(dirs, jnp.float32), scene, tmin=tmin)
    t = np.asarray(res.t)
    idx = np.asarray(res.index)
    hit = np.asarray(res.hit)
    for k in range(len(origins)):
        et, ei = oracle_hit(origins[k], dirs[k], centers, radii, tmin)
        if ei < 0:
            assert not hit[k], f"ray {k}: oracle miss but sweep hit t={t[k]}"
        else:
            assert hit[k], f"ray {k}: oracle hit t={et} but sweep missed"
            assert abs(t[k] - et) < atol * max(1.0, abs(et)), (k, t[k], et)
            assert idx[k] == ei, (k, idx[k], ei, t[k], et)


def test_single_sphere_basic():
    # Ray straight at sphere (0,0,-1) r=0.5 → t = 0.5; inside → far root.
    centers = np.array([[0.0, 0.0, -1.0]])
    radii = np.array([0.5])
    origins = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
    dirs = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    scene = make_scene([lambertian(centers[0], radii[0], (1, 1, 1))])
    res = intersect_spheres(jnp.asarray(origins, jnp.float32),
                            jnp.asarray(dirs, jnp.float32), scene)
    np.testing.assert_allclose(np.asarray(res.t), [0.5, 0.5], atol=1e-5)
    assert np.asarray(res.hit).all()


def test_miss_returns_nohit():
    scene = make_scene([lambertian((0, 0, -1), 0.5, (1, 1, 1))])
    res = intersect_spheres(jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32),
                            jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), scene)
    assert not bool(res.hit[0])
    assert float(res.t[0]) == float(np.float32(BIG))


def test_tmin_rejects_self_intersection():
    # Origin on sphere surface, pointing away: near root ~0 rejected by tmin,
    # far root negative → miss.
    scene = make_scene([lambertian((0, 0, -1), 0.5, (1, 1, 1))])
    res = intersect_spheres(jnp.asarray([[0.0, 0.0, -0.5]], jnp.float32),
                            jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), scene)
    assert not bool(res.hit[0])


def test_negative_radius_hits_like_positive():
    # |r| identical ⇒ same intersection t (only the normal flips,
    # reference: src/hit.jl:33).
    for r in (0.5, -0.5):
        scene = make_scene([dielectric((0, 0, -1), r, 1.5)])
        res = intersect_spheres(jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32),
                                jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), scene)
        assert np.isclose(float(res.t[0]), 0.5, atol=1e-5), r


def test_random_rays_vs_oracle():
    rng = np.random.default_rng(0)
    centers, radii = random_scene_arrays(rng, 20)
    origins = rng.uniform(-6, 6, (64, 3))
    dirs = rng.normal(size=(64, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    run_compare(centers, radii, origins, dirs)


def test_huge_ground_sphere_float32_stability():
    # The r=1000 ground sphere stresses the |oc|^2 expansion
    # (reference flagship scene, src/scenes.jl:53-54).
    centers = np.array([[0.0, -1000.0, -1.0], [0.0, 1.0, 0.0]])
    radii = np.array([1000.0, 1.0])
    rng = np.random.default_rng(1)
    origins = np.array([[13.0, 2.0, 3.0]]).repeat(32, 0)
    dirs = rng.normal(size=(32, 3))
    dirs[:, 1] = -np.abs(dirs[:, 1])  # aim downward → ground hits
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    run_compare(centers, radii, origins, dirs, atol=5e-3)


def test_secondary_ray_off_ground_no_acne():
    # A ray leaving the ground sphere surface upward must NOT re-hit the ground
    # (shadow-acne contract of tmin=1e-4, reference: src/ray_color.jl:19).
    centers = np.array([[0.0, -1000.0, -1.0]])
    radii = np.array([1000.0])
    # A point exactly on the sphere: top pole.
    p = np.array([[0.0, 0.0, -1.0]])
    up = np.array([[0.0, 1.0, 0.0]])
    scene = make_scene([lambertian(centers[0], radii[0], (1, 1, 1))])
    res = intersect_spheres(jnp.asarray(p, jnp.float32),
                            jnp.asarray(up, jnp.float32), scene)
    assert not bool(res.hit[0]), float(res.t[0])


def test_hollow_glass_scene_shell_selection():
    # In the hollow-glass scene a ray into the left sphere must first hit the
    # outer shell (r=0.5) not the inner negative shell (r=-0.45).
    scene = scene_diel_spheres_hollow()
    res = intersect_spheres(jnp.asarray([[-1.0, 0.0, 1.0]], jnp.float32),
                            jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), scene)
    assert bool(res.hit[0])
    assert np.isclose(float(res.t[0]), 1.5, atol=1e-5)  # 2.0 - 0.5
    assert int(res.index[0]) == 2  # outer glass shell


def test_batch_oracle_matches_scalar_oracle():
    rng = np.random.default_rng(7)
    centers, radii = random_scene_arrays(rng, 16)
    radii[3] = 0.0  # padding sphere: skipped by both
    origins = rng.uniform(-6, 6, (200, 3))
    dirs = rng.normal(size=(200, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    bt, bi = oracle_hit_batch(origins, dirs, centers, radii)
    for k in range(len(origins)):
        et, ei = oracle_hit(origins[k], dirs[k], centers, radii)
        assert bi[k] == ei, k
        if ei >= 0:
            assert abs(bt[k] - et) <= 1e-12 * max(1.0, abs(et)), k
