"""Test configuration: the CPU backend with 8 virtual devices by default.

The multi-device sharding path is validated on a fake 8-device CPU mesh
(``xla_force_host_platform_device_count``), the strategy SURVEY.md §4 calls for
in place of the reference's (absent) distributed tests. ``JAX_PLATFORMS``
picks the backend when it is set; unset, the suite runs on the CPU. Tests
marked ``gpu`` need an NVIDIA card and skip elsewhere; ``chip_smoke.py`` runs
them inside its own process on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

import pytest

#: Tests measured >4.5 s on the CPU backend (full-suite --durations run,
#: round 4: 613 s total for 242 tests). The default profile (pyproject
#: addopts -m "not slow") skips them for a <5-minute iteration loop; CI and
#: pre-release runs use the FULL suite: pytest -m "slow or not slow".
#: Two cheap sentinels stay fast on purpose so the default profile still
#: exercises an FD gradient check and the boundary (edge) estimator:
#: test_grad_albedo_matches_fd, test_edge_center_gradient_matches_fd.
SLOW_TESTS = {
    "test_edge_signed_radius_hollow_glass",
    "test_edge_remat_chunks_matches_plain",
    "test_fit_scene_fuzz_channel_descends",
    "test_elastic_train_step_survives_device_fault",
    "test_elastic_train_step_descends",
    "test_elastic_train_step_bitwise_placement_invariance",
    "test_fit_scene_edge_ad_descends_geometry",
    "test_edge_primal_bitwise_matches_keyed_trace",
    "test_edge_handles_metal_and_auto_sigma",
    "test_edge_radius_gradient_sign",
    "test_elastic_survives_persistent_device_fault",
    "test_remat_passes_auto_and_fd",
    "test_elastic_concurrent_scaling_and_bitwise_invariance",
    "test_two_process_distributed_render_and_train",
    "test_elastic_transient_fault_retries_in_place",
    "test_sharded_train_step_runs_and_reduces",
    "test_twin_ad_canary_agrees",
    "test_fit_scene_descends_and_recovers",
    "test_recorded_matches_remat_gradients",
    "test_elastic_clean_run_matches_plain",
    "test_grad_recorded_staged_matches_fd",
    "test_fit_scene_scan_descends",
}


def pytest_collection_modifyitems(config, items):
    # Tests requested explicitly by node ID must RUN even under the default
    # `-m "not slow"` profile — otherwise `pytest tests/x.py::test_slow`
    # reports "1 deselected" and exits green without running anything
    # (round-4 review finding). Skip marking exactly those.
    # Normalize args to rootdir-relative node IDs so invoking pytest from a
    # subdirectory or with an absolute path still matches item.nodeid
    # (ADVICE r4: verbatim comparison silently deselected the requested
    # test whenever the arg spelling differed from the nodeid).
    explicit = set()
    for a in config.args:
        if "::" not in a:
            continue
        path, sep, rest = a.partition("::")
        try:
            rel = os.path.relpath(os.path.abspath(path),
                                  str(config.rootpath))
        except ValueError:  # different drive on Windows
            rel = path
        explicit.add(rel.replace(os.sep, "/") + sep + rest)

    def explicitly_requested(item):
        nid = item.nodeid
        return any(nid == e or nid.startswith(e + "[") for e in explicit)

    for item in items:
        if item.name.split("[")[0] in SLOW_TESTS \
                and not explicitly_requested(item):
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Full-suite runs (232+ tests, one process) reproducibly segfault the
    XLA CPU compiler around the ~136th test (backend_compile_and_load, both
    round-4 attempts, same site) while every half-prefix passes — an
    accumulation failure, not a specific-test bug. Dropping the compiled-
    program caches between modules keeps the per-process compiler state
    bounded; per-module recompiles cost little since tests rarely share
    programs across files."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _gpu_tests_need_a_card(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU.
    Decided per test, never at import: pytest-xdist workers must all collect
    the same tests."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs it on the card")
