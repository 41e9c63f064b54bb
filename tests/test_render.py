"""Render-driver tests: smoke renders of every reference scene plus content
assertions the reference never had (SURVEY.md §4: its smokes assert nothing)."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracingweekend_jl_tpu import (render, render_radiance, image_height_for,
                                      pixel_coords, t_default_cam, t_cam1, t_cam2,
                                      hollow_glass_cam, ALL_SCENES,
                                      scene_2_spheres, scene_random_spheres)


def test_image_height_formula():
    # reference: image_width ÷ (16//9) (src/render.jl:11-12)
    assert image_height_for(1920) == 1080
    assert image_height_for(400) == 225
    assert image_height_for(96) == 54
    assert image_height_for(200) == 112


def test_pixel_coords_convention():
    u, v = pixel_coords(4, 2)
    u = np.asarray(u).reshape(2, 4)
    v = np.asarray(v).reshape(2, 4)
    # u = (j+1)/W; v = (H-1-i)/H, row 0 is top (reference: src/render.jl:26-27).
    np.testing.assert_allclose(u[0], [0.25, 0.5, 0.75, 1.0])
    np.testing.assert_allclose(v[:, 0], [0.5, 0.0])


@pytest.mark.parametrize("name", sorted(ALL_SCENES))
def test_scene_smoke_renders(name):
    scene = ALL_SCENES[name]()
    cam = t_default_cam() if name != "random_spheres" else t_cam1()
    img = np.asarray(render(scene, cam, 64, 2))
    assert img.shape == (36, 64, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-5


def test_render_2_spheres_content():
    # reference smoke config: render(scene_2_spheres, t_default_cam, 96, 16)
    # (test/runtests.jl:194) — with actual content assertions.
    img = np.asarray(render(scene_2_spheres(), t_default_cam(), 96, 16))
    H, W, _ = img.shape
    # Top row: sky gradient (blueish, b > r).
    assert (img[0, :, 2] > img[0, :, 0]).all()
    # Center: red-dominant diffuse sphere (albedo 0.7,0.3,0.3).
    c = img[H // 2, W // 2]
    assert c[0] > c[1] and c[0] > c[2]
    # Lower third: yellow-green ground (albedo 0.8,0.8,0) → blue channel lowest.
    g = img[-2, W // 2]
    assert g[2] < g[0] and g[2] < g[1]


def test_determinism_same_seed():
    scene = scene_2_spheres()
    a = np.asarray(render(scene, t_default_cam(), 64, 4, seed=123))
    b = np.asarray(render(scene, t_default_cam(), 64, 4, seed=123))
    np.testing.assert_array_equal(a, b)


def test_different_seed_differs():
    scene = scene_2_spheres()
    a = np.asarray(render(scene, t_default_cam(), 64, 4, seed=1))
    b = np.asarray(render(scene, t_default_cam(), 64, 4, seed=2))
    assert not np.array_equal(a, b)


def test_spp1_centered_no_jitter_randomness():
    # spp=1 uses only the centered sample; with aperture 0 the whole render is
    # seed-independent (reference deterministic path, SURVEY.md §2.5).
    scene = scene_2_spheres()
    a = np.asarray(render(scene, t_default_cam(), 64, 1, seed=1))
    b = np.asarray(render(scene, t_default_cam(), 64, 1, seed=99))
    # Lambertian bounce dirs still consume RNG; only pure-specular/miss pixels
    # are exactly equal. Sky rows must match bit-exactly:
    np.testing.assert_array_equal(a[0], b[0])


def test_pixel_chunking_matches_unchunked_shape_and_stats():
    scene = scene_2_spheres()
    full = np.asarray(render_radiance(scene, t_default_cam(), 64, 2, seed=5))
    chunked = np.asarray(render_radiance(scene, t_default_cam(), 64, 2, seed=5,
                                         pixel_chunk=512))
    assert full.shape == chunked.shape
    # Different chunk→key mapping ⇒ statistically equal, not bitwise.
    assert abs(full.mean() - chunked.mean()) < 0.01


def test_explicit_height():
    img = np.asarray(render(scene_2_spheres(), t_default_cam(), 64, 1,
                            image_height=32))
    assert img.shape == (32, 64, 3)


def test_defocus_blurs_background():
    # t_cam2 (aperture 2): with defocus the out-of-focus ground has higher
    # local variance across seeds than an aperture-0 render. Cheap proxy:
    # renders with different seeds differ substantially at spp=1 due to the
    # lens sample (vs. bit-equal rows for aperture 0 sky).
    from raytracingweekend_jl_tpu import scene_diel_spheres
    scene = scene_diel_spheres()
    a = np.asarray(render(scene, t_cam2(), 64, 1, seed=1))
    b = np.asarray(render(scene, t_cam2(), 64, 1, seed=2))
    assert not np.array_equal(a, b)


def test_random_spheres_scene_shape():
    scene = scene_random_spheres(seed=1)
    # ~480 spheres + padding to multiple of 128 (SURVEY: ~480, src/scenes.jl:49-84)
    n_real = int(np.sum(np.asarray(scene.radius) != 0))
    assert 440 <= n_real <= 500
    assert scene.n_spheres % 128 == 0


def test_random_spheres_grid_half():
    # grid_half shrinks the grid; the default (11) is bit-identical to the
    # unparameterized builder (same RNG consumption order).
    small = scene_random_spheres(seed=1, grid_half=3)
    n_small = int(np.sum(np.asarray(small.radius) != 0))
    assert 30 <= n_small <= 44  # 6x6 cells + ground + 3 heroes, minus skips
    full_a = scene_random_spheres(seed=1)
    full_b = scene_random_spheres(seed=1, grid_half=11)
    np.testing.assert_array_equal(np.asarray(full_a.center),
                                  np.asarray(full_b.center))
    img = np.asarray(render(small, t_cam1(), 64, 1, seed=0))
    assert np.isfinite(img).all()


def test_hollow_glass_renders():
    from raytracingweekend_jl_tpu import scene_diel_spheres_hollow
    img = np.asarray(render(scene_diel_spheres_hollow(), hollow_glass_cam(), 96, 8))
    assert np.isfinite(img).all()
    assert img.max() <= 1.0 + 1e-5


def test_no_recompile_across_identical_renders():
    # The accelerator analog of the reference's zero-allocation contract tests
    # (test/runtests.jl:129-158): repeated renders of the same configuration
    # must not grow the compile cache (no per-call retraces).
    from raytracingweekend_jl_tpu.render import _render_chunk
    scene = scene_2_spheres()
    cam = t_default_cam()
    render_radiance(scene, cam, 48, 2, seed=1)
    before = _render_chunk._cache_size()
    render_radiance(scene, cam, 48, 2, seed=2)  # new seed = new key VALUE only
    render_radiance(scene, cam, 48, 2, seed=3)
    assert _render_chunk._cache_size() == before


def test_f32_matches_f64_oracle_bounded():
    # Precision contract: the reference benchmarks in Float64 end-to-end
    # (src/proto/proto.jl:15); the production path is f32. Two-part
    # contract, since threefry consumes different bits per
    # dtype (draw VALUES differ, so per-pixel comparison is only meaningful
    # where draws cannot steer the path):
    #
    # 1. Deterministic sub-path (fuzz-0 metal chains, aperture 0, centered
    #    sample): per-pixel f32-vs-f64 divergence is pure float error through
    #    up to 16 bounces — tight bound.
    # 2. Full stochastic scene (hollow glass): mean-radiance agreement at
    #    matched spp — the estimators target the same integral.
    import jax
    from raytracingweekend_jl_tpu import (make_scene, metal, default_camera,
                                          scene_diel_spheres_hollow,
                                          hollow_glass_cam)

    def mirror_scene(dtype):
        return make_scene([metal((0, -100.0, 0), 99.0, (0.8, 0.6, 0.4), 0.0),
                           metal((2, 1, -2), 1.0, (0.9, 0.9, 0.9), 0.0)],
                          dtype=dtype)

    with jax.enable_x64(True):
        d64 = np.asarray(render_radiance(
            mirror_scene(jnp.float64),
            default_camera((0, 2, 0), (1, 1, 0), dtype=jnp.float64), 64, 1,
            seed=9))
        h64 = np.asarray(render_radiance(
            scene_diel_spheres_hollow(dtype=jnp.float64),
            hollow_glass_cam(dtype=jnp.float64), 64, 16, seed=9))
    d32 = np.asarray(render_radiance(
        mirror_scene(jnp.float32),
        default_camera((0, 2, 0), (1, 1, 0), dtype=jnp.float32), 64, 1,
        seed=9))
    h32 = np.asarray(render_radiance(
        scene_diel_spheres_hollow(dtype=jnp.float32),
        hollow_glass_cam(dtype=jnp.float32), 64, 16, seed=9))

    det = np.abs(d32.astype(np.float64) - d64)
    assert det.max() < 2e-4, det.max()          # deterministic: float error only
    assert abs(h32.mean() - h64.mean()) < 5e-3  # stochastic: same integral


@pytest.mark.parametrize("n_samples", [1, 4, 6])
def test_persistent_render_matches_plain_statistically(n_samples):
    # The persistent integrator (the production forward) estimates the same
    # image as the plain wavefront: same mean radiance within Monte-Carlo
    # noise (the two draw different streams).
    scene = scene_2_spheres()
    cam = t_default_cam()
    a = np.asarray(render_radiance(scene, cam, 64, n_samples, seed=5,
                                   persistent=True))
    b = np.asarray(render_radiance(scene, cam, 64, n_samples, seed=5))
    assert a.shape == b.shape == (36, 64, 3) and np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) < 0.03


@pytest.mark.parametrize("env,expect", [
    ({}, "default"),
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/jax"}, "/cache/jax"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, "default"),
    ({"RTW_NO_CACHE": "1"}, ""),
    ({"RTW_NO_CACHE": "1", "JAX_COMPILATION_CACHE_DIR": "/c"}, ""),
])
def test_cache_dir_rule(env, expect):
    import os
    from raytracingweekend_jl_tpu.utils import cache
    want = cache.DEFAULT_DIR if expect == "default" else expect
    assert cache.cache_dir(env) == want
    # The default is fixed inside the checkout: no temp, PID or time part.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.DEFAULT_DIR == os.path.join(root, ".jax_cache")


def test_compilation_cache_helper(tmp_path, monkeypatch):
    import jax
    from raytracingweekend_jl_tpu.utils import cache
    monkeypatch.delenv("RTW_NO_CACHE", raising=False)
    # An environment-provided directory is used as it is (JAX reads the
    # variable itself); the code sets no other.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    before = jax.config.jax_compilation_cache_dir
    path = cache.enable_compilation_cache()
    assert path == str(tmp_path / "xla")
    assert jax.config.jax_compilation_cache_dir == before
    assert cache.enable_compilation_cache() == path  # idempotent
    monkeypatch.setenv("RTW_NO_CACHE", "1")
    assert cache.enable_compilation_cache() == ""  # opt-out
