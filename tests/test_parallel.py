"""Multi-device sharding tests on the fake 8-device CPU mesh
(SURVEY.md §4: the distributed tests the reference never had)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingweekend_jl_tpu import scene_2_spheres, scene_4_spheres, t_default_cam
from raytracingweekend_jl_tpu.parallel.mesh import make_render_mesh
from raytracingweekend_jl_tpu.parallel.shard import (render_radiance_sharded,
                                                     sharded_train_step)
from raytracingweekend_jl_tpu.render import render_radiance

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")


def test_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_render_device_count_invariant():
    # Same tile size ⇒ bit-identical image on a 1-device and an 8-device mesh.
    scene = scene_2_spheres()
    cam = t_default_cam()
    kwargs = dict(image_width=64, n_samples=2, tile_size=256, seed=11)
    mesh1 = make_render_mesh(n_tiles=1, devices=jax.devices()[:1])
    mesh8 = make_render_mesh(n_tiles=8)
    a = np.asarray(render_radiance_sharded(scene, cam, mesh=mesh1, **kwargs))
    b = np.asarray(render_radiance_sharded(scene, cam, mesh=mesh8, **kwargs))
    np.testing.assert_array_equal(a, b)


def test_sample_axis_psum_matches_tiles_only():
    # (4 tiles x 2 samples) must equal (8 tiles x 1 sample): the sample-shard
    # split changes only which device computes which global sample index.
    scene = scene_4_spheres()
    cam = t_default_cam()
    kwargs = dict(image_width=64, n_samples=4, tile_size=256, seed=5)
    mesh_t = make_render_mesh(n_tiles=8, n_samples=1)
    mesh_ts = make_render_mesh(n_tiles=4, n_samples=2)
    a = np.asarray(render_radiance_sharded(scene, cam, mesh=mesh_t, **kwargs))
    b = np.asarray(render_radiance_sharded(scene, cam, mesh=mesh_ts, **kwargs))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_sharded_close_to_unsharded_stats():
    # Different tile→key mapping than the single-chunk path ⇒ statistical
    # agreement, not bitwise.
    scene = scene_2_spheres()
    cam = t_default_cam()
    mesh = make_render_mesh(n_tiles=8)
    a = np.asarray(render_radiance_sharded(scene, cam, 64, 8, mesh=mesh,
                                           tile_size=256, seed=1))
    b = np.asarray(render_radiance(scene, cam, 64, 8, seed=1))
    assert a.shape == b.shape
    assert abs(a.mean() - b.mean()) < 0.01
    assert np.abs(a - b).mean() < 0.05


def test_sharded_spp_indivisible_raises():
    scene = scene_2_spheres()
    mesh = make_render_mesh(n_tiles=4, n_samples=2)
    with pytest.raises(ValueError, match="divide evenly"):
        render_radiance_sharded(scene, t_default_cam(), 64, 3, mesh=mesh,
                                tile_size=256)


def test_sharded_train_step_runs_and_reduces():
    scene = scene_2_spheres()
    cam = t_default_cam()
    mesh = make_render_mesh(n_tiles=4, n_samples=2)
    target = render_radiance(scene, cam, 64, 2, seed=3)
    # Perturb albedo away from the target scene.
    bad = scene._replace(albedo=jnp.clip(scene.albedo * 0.5, 0, 1))
    losses = []
    s = bad
    for _ in range(3):
        loss, s = sharded_train_step(s, cam, target, 64, 2, mesh=mesh,
                                     lr=2.0, tile_size=256, seed=3)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_render_mesh(n_tiles=3, n_samples=2)  # 6 != 8


def test_multihost_helpers_single_process():
    from raytracingweekend_jl_tpu.parallel import multihost
    # Single-process: initialize is a no-op; mesh spans local devices.
    multihost.initialize()
    mesh = multihost.make_multihost_mesh(n_samples_axis=2)
    assert mesh.shape["tiles"] * mesh.shape["samples"] == len(jax.devices())
    start, stop = multihost.host_local_rows(36, 64, tile_size=256)
    assert start == 0 and stop == 36 * 64
    with pytest.raises(ValueError):
        multihost.make_multihost_mesh(n_samples_axis=3)


def test_sharded_persistent_render():
    # persistent integrator inside shard_map shards (CPU fallback body).
    scene = scene_2_spheres()
    cam = t_default_cam()
    mesh = make_render_mesh(n_tiles=8)
    img = np.asarray(render_radiance_sharded(scene, cam, 64, 4, mesh=mesh,
                                             tile_size=256, seed=2,
                                             persistent=True))
    ref = np.asarray(render_radiance(scene, cam, 64, 4, seed=2))
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 0.02


@pytest.mark.parametrize("tiles,samples,exact", [(4, 1, True), (2, 2, False)])
def test_sharded_persistent_matches_one_device(tiles, samples, exact):
    # Global tile ids key the streams, so a tiles-only mesh is bitwise the
    # 1x1 image; a samples axis only reorders the psum.
    scene = scene_2_spheres()
    cam = t_default_cam()
    kw = dict(tile_size=256, seed=2, persistent=True)
    one = np.asarray(render_radiance_sharded(
        scene, cam, 48, 8, mesh=make_render_mesh(1, 1, jax.devices()[:1]),
        **kw))
    many = np.asarray(render_radiance_sharded(
        scene, cam, 48, 8,
        mesh=make_render_mesh(tiles, samples, jax.devices()[:tiles * samples]),
        **kw))
    assert np.isfinite(many).all()
    if exact:
        np.testing.assert_array_equal(many, one)
    else:
        np.testing.assert_allclose(many, one, atol=1e-6)


def test_sharded_train_step_recorded_grad_mode():
    # The recorded gradient integrator under shard_map: loss finite and
    # gradients update the scene — covers the shard_map transpose
    # composition with the recorded custom VJP.
    scene = scene_4_spheres()
    cam = t_default_cam()
    mesh = make_render_mesh(n_tiles=4, n_samples=2)
    target = render_radiance(scene, cam, 64, 2, seed=3)
    bad = scene._replace(albedo=jnp.clip(scene.albedo * 0.7, 0, 1))
    loss, updated = sharded_train_step(bad, cam, target, 64, 2, mesh=mesh,
                                       lr=0.05, tile_size=256, seed=3,
                                       grad_mode="recorded")
    assert np.isfinite(float(loss))
    assert not np.allclose(np.asarray(updated.albedo), np.asarray(bad.albedo))


@pytest.mark.parametrize("mode", ["fused", "persist", None])
def test_sharded_train_step_rejects_unknown_grad_mode(mode):
    """The XLA recorded path is the only sharded gradient integrator."""
    scene = scene_2_spheres()
    cam = t_default_cam()
    with pytest.raises(ValueError, match="grad_mode"):
        sharded_train_step(scene, cam, jnp.zeros((9, 16, 3)), 16, 1,
                           mesh=make_render_mesh(1, 1, jax.devices()[:1]),
                           grad_mode=mode)
