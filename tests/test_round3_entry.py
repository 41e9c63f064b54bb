"""Contract tests: multihost auto-init decision table, strip IO, the
recorded-path memory guard, and gradient flag semantics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytracingweekend_jl_tpu.grad as gradmod
from raytracingweekend_jl_tpu import scene_2_spheres, t_default_cam
from raytracingweekend_jl_tpu.grad import auto_pixel_chunk, render_loss
from raytracingweekend_jl_tpu.parallel import multihost


# ---------------------------------------------------------------------------
# multihost.initialize decision table (the wrapper must not silently no-op
# on a real cluster launch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,expect", [
    ({}, False),
    ({"HOME": "/home/user", "SLURM_NTASKS": "1"}, False),
    ({"OMPI_COMM_WORLD_SIZE": "1"}, False),
    ({"SLURM_NTASKS": "garbage"}, False),
    # Any coordinator marker => cluster.
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234"}, True),
    ({"JAX_COORDINATOR_ADDRESS": "h:1"}, True),
    # Multi-task launchers.
    ({"SLURM_NTASKS": "4"}, True),
    ({"OMPI_COMM_WORLD_SIZE": "2"}, True),
])
def test_cluster_env_hint_table(env, expect):
    assert multihost.cluster_env_hint(env) is expect


def test_initialize_single_process_noop(monkeypatch):
    # No cluster markers, no explicit count: must not touch jax.distributed.
    for var in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    called = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **k: called.append((a, k)))
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    assert called == []


def test_initialize_autodetects_cluster(monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:9999")
    called = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **k: called.append((a, k)))
    # Argless call + cluster env => argless jax.distributed.initialize().
    assert multihost.initialize() is True
    assert called == [((), {})]
    # Explicit args always win over detection.
    assert multihost.initialize(coordinator_address="h:1", num_processes=2,
                                process_id=0) is True
    assert called[1][1]["num_processes"] == 2


# ---------------------------------------------------------------------------
# Strip IO (host-local image shards)
# ---------------------------------------------------------------------------

def test_write_and_assemble_strips_single_process(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((12, 16, 3)).astype(np.float32)
    d = str(tmp_path / "strips")
    start, stop = multihost.write_host_strip(img, 12, 16, 64, d)
    assert (start, stop) == (0, 12 * 16)
    out = multihost.assemble_strips(d)
    np.testing.assert_array_equal(out, img)


def test_assemble_strips_detects_gap(tmp_path):
    d = tmp_path / "strips"
    d.mkdir()
    np.savez(d / "strip_00000.npz", start=0, stop=64,
             strip=np.zeros((64, 3), np.float32), image_height=8,
             image_width=16)
    # Missing [64, 128) strip — must raise, not produce a black band.
    with pytest.raises(ValueError, match="gap|cover"):
        multihost.assemble_strips(str(d))


def test_assemble_strips_empty_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        multihost.assemble_strips(str(tmp_path))


# ---------------------------------------------------------------------------
# Recorded-path memory guard (VERDICT r2 next #7)
# ---------------------------------------------------------------------------

def test_auto_pixel_chunk_table():
    # Small images fit: no chunking.
    assert auto_pixel_chunk(64 * 36, 16) is None
    # Flagship at depth 16 fits the 8 GB budget but trips the ~1M-ray soft
    # cap: two balanced 8192-aligned chunks.
    c = auto_pixel_chunk(1920 * 1080, 16)
    assert c == 1040384 and 2 * c >= 1920 * 1080, c
    # A 4x-flagship image does not: chunks must engage, lane-aligned.
    c = auto_pixel_chunk(4 * 1920 * 1080, 16)
    assert c is not None and c % 8192 == 0
    # Tight explicit budget: floors at 8192 rays.
    assert auto_pixel_chunk(10_000_000, 16, budget=1 << 20) == 8192
    # Budget scales with depth.
    assert auto_pixel_chunk(1920 * 1080, 64, budget=1 << 30) is not None


def test_render_loss_auto_chunk_plumbs_through(monkeypatch):
    seen = {}

    def fake_render(scene, cam, w, n, **kwargs):
        seen.update(kwargs)
        return jnp.zeros((kwargs["image_height"], w, 3))

    monkeypatch.setattr(gradmod, "render_radiance", fake_render)
    scene, cam = scene_2_spheres(), t_default_cam()
    target = jnp.zeros((36, 64, 3))

    render_loss(scene, cam, target, 64, 1)
    assert seen["recorded"] is True and seen["pixel_chunk"] is None

    # Tiny budget on a tiny image: the 8192-ray floor exceeds the whole
    # image, so chunking correctly stays off (grad.py auto_pixel_chunk).
    monkeypatch.setattr(gradmod, "RECORD_HBM_BUDGET", 1 << 20)
    seen.clear()
    render_loss(scene, cam, target, 64, 1)
    assert seen["pixel_chunk"] is None

    # Tiny budget on an image larger than the floor: chunking engages
    # without the caller asking, floored at 8192 rays.
    seen.clear()
    big_target = jnp.zeros((144, 256, 3))
    render_loss(scene, cam, big_target, 256, 1)
    assert seen["pixel_chunk"] == 8192

    # Explicit pixel_chunk wins over the auto pick.
    seen.clear()
    render_loss(scene, cam, target, 64, 1, pixel_chunk=123)
    assert seen["pixel_chunk"] == 123

    # Explicit remat=True (without recorded=) selects the XLA-transpose
    # path, not the recorded integrator.
    seen.clear()
    render_loss(scene, cam, target, 64, 1, remat=True)
    assert seen["recorded"] is False and seen["remat"] is True


def test_staged_stage_width_validated():
    from raytracingweekend_jl_tpu.ops.grad_trace import trace_recorded_staged
    scene = scene_2_spheres()
    org = jnp.zeros((8, 3))
    d = jnp.tile(jnp.asarray([0.0, 0.0, -1.0]), (8, 1))
    key = jax.random.PRNGKey(0)
    with pytest.raises(ValueError, match="stage_width"):
        trace_recorded_staged(scene, org, d, key, 4, 1e-4, False, 2, 9)


# ---------------------------------------------------------------------------
# ADVICE hygiene: PhaseTimer.discard, CLI --no-compact alias
# ---------------------------------------------------------------------------

def test_phase_timer_discard():
    from raytracingweekend_jl_tpu.utils.metrics import PhaseTimer
    t = PhaseTimer()
    t.start("trace")
    t.discard("trace")
    t.discard("never_started")  # no-op, no KeyError
    assert t.as_dict() == {}
    t.start("fetch")
    t.stop("fetch")
    assert "fetch" in t.as_dict()


def test_cli_multihost_single_process(tmp_path):
    # Single-process --multihost: auto-init no-ops, the mesh spans all local
    # (virtual) devices, and the render completes through the sharded driver.
    import os
    from raytracingweekend_jl_tpu.cli import main
    if len(jax.devices()) % 2:
        pytest.skip("needs an even virtual device count")
    out = str(tmp_path / "mh.png")
    os.chdir(tmp_path)  # bench_history.jsonl lands here
    main(["--scene", "2_spheres", "--camera", "default", "--width", "64",
          "--spp", "2", "--multihost", "--mesh-samples", "2",
          "--tile-size", "256", "-o", out])
    assert os.path.exists(out)


def test_cli_no_compact_alias_parses():
    from raytracingweekend_jl_tpu.cli import build_parser, config_from_args
    args = build_parser().parse_args(["--no-compact", "--width", "32"])
    cfg = config_from_args(args)
    assert cfg.compact is False
    with pytest.raises(SystemExit):
        config_from_args(build_parser().parse_args(["--no-compact", "--compact"]))
