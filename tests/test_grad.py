"""Autodiff vs finite-difference gradient tests — the north-star capability the
reference lacks entirely (SURVEY.md §2.9, BASELINE.json north_star: "finite
difference pixel gradients must match the autodiff gradients").

Run in float64 (CPU x64 context) so central differences are trustworthy; the
RNG key is fixed so the sampled light paths are identical across perturbations
(interior gradients; silhouette boundary terms are intentionally not estimated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingweekend_jl_tpu import (make_scene, lambertian, metal, default_camera,
                                      render_radiance, scene_2_spheres, t_default_cam)
from raytracingweekend_jl_tpu.grad import (render_grads, render_loss, sgd_inverse_render_step,
                                           _params_of, _with_params)


def small_scene(dtype):
    return make_scene([
        lambertian((0, 0, -1), 0.5, (0.7, 0.3, 0.3)),
        lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
        metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.0),
    ], dtype=dtype, pad_to=4)


def fd_check(field, coord, eps, rtol, atol):
    with jax.enable_x64(True):
        dtype = jnp.float64
        scene = small_scene(dtype)
        cam = default_camera(dtype=dtype)
        target = jnp.zeros((18, 32, 3), dtype)
        kwargs = dict(image_width=32, n_samples=2, seed=7)

        loss, grads = render_grads(scene, cam, target, **kwargs)
        g_ad = np.asarray(getattr(grads, field))[coord]

        def loss_at(delta):
            arr = np.asarray(getattr(scene, field)).copy()
            arr[coord] += delta
            s2 = scene._replace(**{field: jnp.asarray(arr, dtype)})
            return float(render_loss(s2, cam, target, **kwargs))

        g_fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        assert np.isfinite(g_ad)
        np.testing.assert_allclose(g_ad, g_fd, rtol=rtol, atol=atol), (field, coord)


def test_grad_albedo_matches_fd():
    # Radiance is polynomial in albedo → FD matches tightly.
    fd_check("albedo", (0, 0), eps=1e-4, rtol=1e-4, atol=1e-9)
    fd_check("albedo", (1, 2), eps=1e-4, rtol=1e-4, atol=1e-9)


def test_grad_center_matches_fd():
    fd_check("center", (0, 2), eps=1e-5, rtol=2e-2, atol=1e-7)


def test_grad_radius_matches_fd():
    fd_check("radius", (0,), eps=1e-5, rtol=2e-2, atol=1e-7)


def test_grad_fuzz_matches_fd():
    fd_check("fuzz", (2,), eps=1e-5, rtol=2e-2, atol=1e-7)


def test_grads_finite_on_full_scene():
    scene = scene_2_spheres()
    cam = t_default_cam()
    target = jnp.zeros((18, 32, 3), jnp.float32)
    loss, grads = render_grads(scene, cam, target, image_width=32, n_samples=2)
    assert np.isfinite(float(loss))
    for f in grads._fields:
        g = np.asarray(getattr(grads, f))
        assert np.isfinite(g).all(), f
    # Albedo grad of the visible sphere must be nonzero.
    assert np.abs(np.asarray(grads.albedo)[0]).max() > 0


def test_inverse_render_step_reduces_loss():
    # Fit albedo of a scene towards a target rendered with different albedo.
    with jax.enable_x64(True):
        dtype = jnp.float64
        cam = default_camera(dtype=dtype)
        target_scene = make_scene([lambertian((0, 0, -1), 0.5, (0.2, 0.8, 0.3)),
                                   lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0))],
                                  dtype=dtype, pad_to=4)
        target = render_radiance(target_scene, cam, 32, 4, image_height=18, seed=3)
        scene = make_scene([lambertian((0, 0, -1), 0.5, (0.5, 0.5, 0.5)),
                            lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0))],
                           dtype=dtype, pad_to=4)
        losses = []
        for i in range(5):
            loss, scene = sgd_inverse_render_step(scene, cam, target, 32, 4,
                                                  lr=2.0, seed=3)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.7, losses


def test_grad_tile_skip_matches_fd():
    # The dead-tile-skipping differentiable trace (tile_skip>0): lax.cond
    # transposes correctly, so FD must still match AD through the guarded
    # bounce bodies.
    with jax.enable_x64(True):
        dtype = jnp.float64
        scene = small_scene(dtype)
        cam = default_camera(dtype=dtype)
        target = jnp.zeros((18, 32, 3), dtype)
        kwargs = dict(image_width=32, n_samples=2, seed=7, tile_skip=128)

        loss, grads = render_grads(scene, cam, target, **kwargs)
        g_ad = np.asarray(grads.albedo)[0, 0]

        def loss_at(delta):
            arr = np.asarray(scene.albedo).copy()
            arr[0, 0] += delta
            s2 = scene._replace(albedo=jnp.asarray(arr, dtype))
            return float(render_loss(s2, cam, target, **kwargs))

        eps = 1e-4
        g_fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        np.testing.assert_allclose(g_ad, g_fd, rtol=1e-4, atol=1e-9)


def test_tile_skip_statistical_equivalence():
    # tile_skip changes only the RNG stream layout (per-tile folded keys):
    # images agree statistically with the plain trace, and tiles whose rays
    # all die at bounce 1 (sky) contribute identically.
    scene = scene_2_spheres()
    cam = t_default_cam()
    a = np.asarray(render_radiance(scene, cam, 64, 8, seed=3))
    b = np.asarray(render_radiance(scene, cam, 64, 8, seed=3, tile_skip=256))
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < 0.01
    assert np.abs(a - b).mean() < 0.05


def test_grad_recorded_matches_fd():
    # Recorded-path custom VJP (ops/grad_trace.py): gradients through the
    # replayed bounce chain + implicit-t closed form must match finite
    # differences exactly like the remat path does.
    with jax.enable_x64(True):
        dtype = jnp.float64
        scene = small_scene(dtype)
        cam = default_camera(dtype=dtype)
        target = jnp.zeros((18, 32, 3), dtype)
        kwargs = dict(image_width=32, n_samples=2, seed=7, recorded=True,
                      remat=False)

        loss, grads = render_grads(scene, cam, target, **kwargs)
        g_ad = np.asarray(grads.albedo)[0, 0]

        def loss_at(delta):
            arr = np.asarray(scene.albedo).copy()
            arr[0, 0] += delta
            s2 = scene._replace(albedo=jnp.asarray(arr, dtype))
            return float(render_loss(s2, cam, target, **kwargs))

        eps = 1e-4
        g_fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        np.testing.assert_allclose(g_ad, g_fd, rtol=1e-4, atol=1e-9)


def test_recorded_matches_remat_gradients():
    # Same bounce math, same RNG replay => gradients agree with the default
    # checkpointed path to float32 tolerance on every differentiable field.
    scene = scene_2_spheres()
    cam = t_default_cam()
    target = jnp.zeros((27, 48, 3), jnp.float32)
    _, g_rec = render_grads(scene, cam, target, image_width=48, n_samples=2,
                            seed=5, recorded=True, remat=False)
    _, g_rem = render_grads(scene, cam, target, image_width=48, n_samples=2,
                            seed=5, recorded=False, remat=True)
    for f in ("center", "radius", "albedo", "fuzz", "ir"):
        a, b = np.asarray(getattr(g_rec, f)), np.asarray(getattr(g_rem, f))
        scale = max(np.abs(b).max(), 1e-6)
        # float32 replay linearizes at recorded states that differ from the
        # sweep's by ulps; allow small absolute noise on tiny gradients.
        np.testing.assert_allclose(a, b, atol=2e-6 + 1e-3 * scale, err_msg=f)


def test_grad_recorded_staged_matches_fd():
    # Staged recorded path (compacted tail bounces, ops/grad_trace.py): FD of
    # the SAME program must match AD — the tail stream differs from the
    # unstaged path (valid estimator), but fwd and bwd are self-consistent.
    with jax.enable_x64(True):
        dtype = jnp.float64
        scene = small_scene(dtype)
        cam = default_camera(dtype=dtype)
        target = jnp.zeros((18, 32, 3), dtype)
        kwargs = dict(image_width=32, n_samples=2, seed=7, recorded=True,
                      remat=False, recorded_stage=(4, 4))

        loss, grads = render_grads(scene, cam, target, **kwargs)
        g_ad = np.asarray(grads.albedo)[0, 0]

        def loss_at(delta):
            arr = np.asarray(scene.albedo).copy()
            arr[0, 0] += delta
            s2 = scene._replace(albedo=jnp.asarray(arr, dtype))
            return float(render_loss(s2, cam, target, **kwargs))

        eps = 1e-4
        g_fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        np.testing.assert_allclose(g_ad, g_fd, rtol=1e-4, atol=1e-9)


def test_recorded_staged_radiance_statistical():
    # Staged vs unstaged recorded primal: different tail streams, same
    # integral.
    scene = scene_2_spheres()
    cam = t_default_cam()
    a = np.asarray(render_radiance(scene, cam, 64, 8, seed=3, recorded=True))
    b = np.asarray(render_radiance(scene, cam, 64, 8, seed=3, recorded=True,
                                   recorded_stage=(4, 4)))
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < 0.01
    assert np.abs(a - b).mean() < 0.05


def test_recorded_staged_budget_contract():
    # Over-budget tail stage (stage width < alive count at B): overflow lanes
    # truncate at B per the documented contract — no crash, radiance only
    # loses the truncated tails, and the returned count exposes the overflow.
    import jax
    from raytracingweekend_jl_tpu.render import pixel_coords
    from raytracingweekend_jl_tpu.camera import get_rays
    from raytracingweekend_jl_tpu.ops.grad_trace import trace_recorded_staged, trace_recorded
    from raytracingweekend_jl_tpu import rng as rngmod, scene_diel_spheres_hollow, hollow_glass_cam

    scene = scene_diel_spheres_hollow()  # glass => long paths, high alive@B
    cam = hollow_glass_cam()
    u, v = pixel_coords(48, 27)
    key = jax.random.PRNGKey(1)
    o, d = get_rays(cam, u, v, rngmod.purpose_key(key, rngmod.LENS))
    tk = rngmod.purpose_key(key, rngmod.SCATTER_DIR)

    full = np.asarray(trace_recorded(scene, o, d, tk))
    rad, count = trace_recorded_staged(scene, o, d, tk, 16, 1e-4, None, 2, 64)
    rad = np.asarray(rad)
    assert int(count) > 64  # the budget IS exceeded in this configuration
    assert np.isfinite(rad).all()
    # Truncation only removes light: nowhere brighter beyond float noise, and
    # mean strictly below the untruncated render.
    # Truncation removes the overflow lanes' tail light: mean strictly below
    # the untruncated render. (Per-pixel comparison is not meaningful — the
    # tail stage draws a different positional stream than the unstaged path.)
    assert rad.mean() < full.mean()


@pytest.mark.parametrize("flags,recorded,remat", [
    ({}, True, False),                                  # default: recorded
    ({"recorded": True}, True, False),
    ({"remat": True}, False, True),                     # remat implies XLA transpose
    ({"recorded": False}, False, True),
    ({"recorded": False, "remat": True}, False, True),
    ({"recorded_stage": (4, 4)}, True, False),          # staged recorded variant
])
def test_resolve_grad_path_decision_table(flags, recorded, remat):
    from raytracingweekend_jl_tpu.grad import resolve_grad_path
    kw = resolve_grad_path(dict(flags))
    assert kw["recorded"] is recorded and kw["remat"] is remat
    for k, v in flags.items():
        assert kw[k] == v  # explicit flags are kept verbatim


def test_render_loss_rejects_forward_only_flags():
    from raytracingweekend_jl_tpu.grad import resolve_grad_path
    with pytest.raises(ValueError, match="forward-only"):
        resolve_grad_path({"persistent": True})
    with pytest.raises(ValueError, match="forward-only"):
        resolve_grad_path({"compact": True})


def test_remat_passes_auto_and_fd():
    # High-spp gradients would keep every pass's path records alive (55 GB
    # at flagship spp=16); render_loss auto-checkpoints the pass loop when
    # the total record footprint exceeds the budget, and the checkpointed
    # program must stay FD-consistent.
    from raytracingweekend_jl_tpu.grad import render_grads
    from raytracingweekend_jl_tpu.render import render_radiance
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu import grad as gradmod

    # Decision: flagship spp=16 -> remat; spp=1 -> not (CPU budget 8 GiB).
    kw = gradmod.plan_pass_memory(dict(recorded=True), 1920 * 1080, 16)
    assert kw["remat_passes"] is True
    kw = gradmod.plan_pass_memory(dict(recorded=True), 1920 * 1080, 1)
    assert "remat_passes" not in kw

    # FD consistency of the checkpointed pass loop (spp=4, CPU).
    scene = rtw.scene_4_spheres()
    cam = rtw.t_default_cam()
    target = render_radiance(scene, cam, 48, 4, image_height=27, seed=3)
    bad = scene._replace(albedo=jnp.clip(scene.albedo * 0.8, 0, 1))
    kw = dict(recorded=True, remat_passes=True)
    loss, g = render_grads(bad, cam, target, 48, 4, **kw)
    g_ad = float(np.asarray(g.albedo)[1, 0])

    def loss_at(dl):
        arr = np.asarray(bad.albedo).copy()
        arr[1, 0] += dl
        l, _ = render_grads(bad._replace(albedo=jnp.asarray(arr)), cam,
                            target, 48, 4, **kw)
        return float(l)

    eps = 1e-2
    g_fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(g_ad, g_fd, rtol=3e-2, atol=1e-6)


@pytest.mark.parametrize("n_samples,budget_gib,expect", [
    (1, 8, None),        # one pass: nothing to plan
    (4, 8, True),        # flagship x4 spp: 13.8 GB of records > 8 GiB
    (4, 45, False),      # fits a 45 GiB budget (an 80 GB card's share)
    (16, 45, True),      # 55.2 GB of records > 45 GiB
])
def test_plan_pass_memory_escalation(monkeypatch, n_samples, budget_gib,
                                     expect):
    """Pass remat turns on exactly when all passes' records exceed the
    budget; explicit choices and non-recorded paths are left alone."""
    from raytracingweekend_jl_tpu import grad as gradmod
    monkeypatch.setattr(gradmod, "RECORD_HBM_BUDGET", budget_gib * 2**30)
    n_pix = 1920 * 1080
    kw = gradmod.plan_pass_memory(dict(recorded=True), n_pix, n_samples)
    assert kw.get("remat_passes") is expect
    kw = gradmod.plan_pass_memory(dict(recorded=True, remat_passes=False),
                                  n_pix, n_samples)
    assert kw["remat_passes"] is False
    kw = gradmod.plan_pass_memory(dict(recorded=False), n_pix, n_samples)
    assert "remat_passes" not in kw


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,stats,expect", [
    ("gpu", {"bytes_limit": 60 * 2**30}, 45 * 2**30),
    ("gpu", {"bytes_limit": 8 * 2**30, "peak_bytes_in_use": 1}, 6 * 2**30),
    ("cpu", None, 8 * 2**30),
])
def test_record_hbm_budget_from_memory_stats(monkeypatch, platform, stats,
                                             expect):
    from raytracingweekend_jl_tpu import grad as gradmod
    monkeypatch.setattr(gradmod, "RECORD_HBM_BUDGET", None)
    monkeypatch.setattr(gradmod, "_RESOLVED_HBM_BUDGET", None)
    monkeypatch.setattr(gradmod.jax, "local_devices",
                        lambda: [_FakeDevice(platform, stats)])
    assert gradmod.record_hbm_budget() == expect


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_record_hbm_budget_requires_a_limit(monkeypatch, stats):
    # An accelerator that reports no limit is an error, not a table lookup.
    from raytracingweekend_jl_tpu import grad as gradmod
    monkeypatch.setattr(gradmod, "RECORD_HBM_BUDGET", None)
    monkeypatch.setattr(gradmod, "_RESOLVED_HBM_BUDGET", None)
    monkeypatch.setattr(gradmod.jax, "local_devices",
                        lambda: [_FakeDevice("gpu", stats)])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        gradmod.record_hbm_budget()


def test_record_hbm_budget_explicit_pin_wins(monkeypatch):
    from raytracingweekend_jl_tpu import grad as gradmod
    monkeypatch.setattr(gradmod, "RECORD_HBM_BUDGET", 123)
    monkeypatch.setattr(gradmod.jax, "local_devices",
                        lambda: [_FakeDevice("gpu", None)])
    assert gradmod.record_hbm_budget() == 123
