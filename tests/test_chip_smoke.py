"""chip_smoke.py's pure helpers: phase selection, the sweep gates, the
float32 summation check, the last-line format, and its refusal to run
without a GPU (the card-only phases run on the card)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("four_cards,expect", [
    (False, ["device", "sweep", "forward", "grad", "gpu_tests"]),
    (True, ["device", "mesh"]),
])
def test_select_phases(four_cards, expect):
    assert chip_smoke.select_phases(four_cards) == expect


def test_parse_args_defaults_to_one_card():
    assert chip_smoke.parse_args([]).four_cards is False
    assert chip_smoke.parse_args(["--four-cards"]).four_cards is True


def test_parse_args_has_no_phase_subset():
    # The one-card run always runs every phase.
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--phases", "sweep"])


def test_oracle_misses_counts_winners_and_distances():
    t64 = np.array([1.0, 2.0, np.inf, 4.0, 5.0])
    i64 = np.array([3, 1, -1, 0, 2])
    t = np.array([1.0, 2.0 * (1 + 3e-5), 1e30, 4.0, 5.0 * (1 + 5e-6)],
                 np.float32)
    i = np.array([3, 1, -1, 7, 2])
    # Ray 3 has the wrong winner; ray 1 the right one at a distance off by
    # 3e-5 of t; ray 4 is within T_REL; ray 2 misses as the oracle does.
    assert chip_smoke.oracle_misses(t, i, t64, i64) == (1, 1)


def _sweep_rec(**over):
    rec = dict(rays=2_000_000, n_disagree=100, index_agree=0.99999,
               disagree_kernel_right=50, disagree_plain_right=50,
               oracle_rays=65536, oracle_index_miss_kernel=9,
               oracle_index_miss_plain=9, oracle_t_miss_kernel=100,
               oracle_t_miss_plain=100)
    rec.update(over)
    return rec


@pytest.mark.parametrize("name,over,failing", [
    ("primary", {}, None),
    ("bounce", {"index_agree": 0.999}, None),
    ("primary", {"oracle_index_miss_kernel": 40}, None),  # full width decides
    ("primary", {"index_agree": 0.999}, "winner agreement"),
    ("bounce", {"index_agree": 0.998}, "winner agreement"),
    ("bounce", {"disagree_kernel_right": 0, "disagree_plain_right": 600},
     "oracle sides with the XLA sweep"),
    ("primary", {"oracle_t_miss_kernel": 103}, "distance is off"),
])
def test_sweep_failures(name, over, failing):
    fails = chip_smoke.sweep_failures(name, _sweep_rec(**over))
    if failing is None:
        assert fails == []
    else:
        assert len(fails) == 1 and failing in fails[0]


@pytest.mark.parametrize("skew", [False, True])
def test_summation_error_passes_sum_rows(skew):
    # sum_rows (the one-hot product) is a float32 sum: within the bound.
    import jax
    import jax.numpy as jnp
    from raytracingweekend_jl_tpu.ops.materials import sum_rows
    idx = jax.random.randint(jax.random.PRNGKey(0), (20000,), 0, 61)
    if skew:  # most rays on one sphere, as the ground sphere takes them
        idx = jnp.where(jnp.arange(20000) % 7 == 0, idx, 5)
    rows = jax.random.normal(jax.random.PRNGKey(1), (20000, 9))
    exact, worst = chip_smoke.summation_error(idx, rows,
                                              sum_rows(idx, rows, 61), 61)
    assert exact.shape == (61, 9)
    assert worst <= 1.0


def test_summation_error_catches_short_mantissa_inputs():
    # Inputs rounded to TF32's 10-bit mantissa before an exact sum break
    # the float32 bound, and a one-ray sphere must come out exact.
    rng = np.random.default_rng(0)
    idx = np.concatenate([np.zeros(3000, np.int64), [1]])
    rows = rng.normal(size=(3001, 4)).astype(np.float32)
    bits = rows.view(np.uint32)
    tf32 = ((bits + np.uint32(1 << 12)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    sums = np.stack([np.bincount(idx, tf32[:, f].astype(np.float64), 2)
                     for f in range(4)], 1)
    _, worst = chip_smoke.summation_error(idx, rows, sums, 2)
    assert worst > 1.0
    _, worst_exact = chip_smoke.summation_error(
        idx, rows, np.stack([np.bincount(idx, rows[:, f].astype(np.float64),
                                         2) for f in range(4)], 1), 2)
    assert worst_exact <= 1.0


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_format(count):
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("devices,count", [
    ([_Dev("cpu")], 1),
    ([], 1),
    ([_Dev("gpu")], 4),
])
def test_require_gpu_refuses(devices, count):
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(devices, count)


def test_require_gpu_accepts_enough_gpus():
    chip_smoke.require_gpu([_Dev("gpu")] * 4, 4)
    chip_smoke.require_gpu([_Dev("gpu")], 1)


def test_check_raises_with_message():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.CheckFailed, match="broken"):
        chip_smoke.check(False, "broken")


def test_refuses_on_cpu_and_prints_no_result():
    # This suite runs on the CPU: the script must exit non-zero with nothing
    # on stdout.
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, chip_smoke.__file__], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "needs an NVIDIA GPU" in proc.stderr


def test_fails_alone_without_the_repository(tmp_path):
    # A directory holding chip_smoke.py and nothing else of the repository.
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(chip_smoke.__file__).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
