"""Test config: run everything on an 8-virtual-device CPU mesh.

Multi-chip behavior is tested without a pod by forcing the host platform to
expose 8 devices (the reference only ever tested multi-tile behavior on real
hardware, SURVEY.md §4 — we do better). Must run before jax is imported.
"""

import os

# CPU run (the default): 8 virtual devices. Tests marked `gpu` need the
# card; `NTT_AIE_TEST_DEVICE=gpu` leaves the platform to JAX so they run
# there (chip_smoke.py does this).
if os.environ.get("NTT_AIE_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """For tests marked `gpu`: skip unless JAX runs on an NVIDIA GPU
    (decided here, at run time, never at import or collection)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py on the card)")


# ---------------------------------------------------------------------------
# Fast/slow tiers. `pytest -m "not slow"` = the core correctness suite
# (kernel/oracle/plan coverage incl. every reduction strategy and one
# distributed shard_map path) in ~2 min; the unmarked full run stays the CI
# gate. Tiering lives here (one place) instead of per-test decorators.
# ---------------------------------------------------------------------------

# Whole modules that are integration-heavy; everything in them is slow
# except the explicit keeps below.
_SLOW_MODULES = {
    "test_distributed.py",
    "test_fuzz_configs.py",
    "test_rns.py",
    "test_dilithium.py",
    "test_kyber.py",
    "test_profiling.py",
    "test_goldilocks_plan.py",
}

# Smoke tests the fast tier retains from slow modules (module::name).
_FAST_KEEP = {
    "test_distributed.py::test_distributed_matches_single_chip",
    "test_distributed.py::test_distributed_nested_depth_matches_single_chip",
    "test_goldilocks_plan.py::test_auto_reduction_dispatch",
    "test_goldilocks_plan.py::test_flat_forward_matches_oracle",
    "test_rns.py::test_rns_input_validation",
    "test_rns.py::test_rns_modulus_and_basis",
    "test_rns.py::test_rns_rejects_wide_primes",
    "test_kyber.py::test_ntt_matches_fips_scalar",
    "test_kyber.py::test_polymul_matches_schoolbook_negacyclic",
    "test_dilithium.py::test_polymul_matches_schoolbook_negacyclic",
    "test_profiling.py::test_butterfly_and_op_models",
    "test_profiling.py::test_efficiency_report_known_device",
    "test_profiling.py::test_efficiency_report_unknown_device",
    "test_profiling.py::test_cli_field_aliases",
    "test_fuzz_configs.py::test_config_json_roundtrip",
}

# Heavy tests living in otherwise-fast modules.
_SLOW_TESTS = {
    "test_plan.py::test_pallas_batched_batch_one",
    "test_plan.py::test_pallas_batched_honors_natural_ordering",
    "test_plan.py::test_pallas_batched_polymul_natural_ordering",
    "test_plan.py::test_negacyclic_fused_pallas",
    "test_plan.py::test_negacyclic_batched_pallas",
    "test_plan.py::test_flat_batched_lane_layout",
    "test_plan.py::test_flat_batched_honors_natural_ordering",
    "test_plan.py::test_reference_parity_partial_depth",
    "test_plan.py::test_colpass_fuse_levels_match",
    "test_plan.py::test_polymul_large_fourstep",
    "test_plan.py::test_unbatched_matrix_form_twins",
    "test_crt.py::test_rns_batched_polymul",
}


def pytest_collection_modifyitems(config, items):
    slow = pytest.mark.slow
    for item in items:
        mod = os.path.basename(str(item.fspath))
        key = f"{mod}::{item.originalname or item.name}"
        if key in _SLOW_TESTS or (mod in _SLOW_MODULES
                                  and key not in _FAST_KEEP):
            item.add_marker(slow)
