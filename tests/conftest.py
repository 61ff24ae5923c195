"""Test configuration: the CPU, with an 8-device virtual mesh.

Multi-device tests run on virtual CPU devices via
`--xla_force_host_platform_device_count` (SURVEY.md §4). Pallas kernels run
in interpret mode: tests pass `interpret=True` explicitly. Code that needs
the GPU is exercised by `chip_smoke.py` on the card.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


# ---------------------------------------------------------------------------
# Suite tiers: tests measured >= ~10 s on CPU are marked
# `slow` centrally here, so `pytest -m "not slow"` is a <3 min smoke tier
# and the full suite stays the pre-commit bar. Measured via --durations.
# ---------------------------------------------------------------------------
_SLOW_TESTS = {
    "test_remat_gradients_match",
    "test_ratio_tracking_unbiased_vs_dense_integral",
    "test_ratio_estimator_selectable_through_config",
    "test_gradient_through_disney",
    "test_in_scatter_positive_with_light",
    "test_cornell_vs_reference",
    "test_density_gradient_matches_fd",
    "test_restir_unbiased_combine_cluttered",
    "test_env_gradient",
    "test_textured_gradient_still_flows",
    "test_beer_law_slab_analytic_ratio",
    "test_cli_end_to_end",
    "test_restir_reduces_variance_vs_single_candidate_nee",
    "test_e2e_textured_render_mip_vs_brute_mean",
    "test_nan_free_long_render",
    "test_restir_spatial_cluttered_bounded_darkening",
    "test_restir_volumetric_shadow_attenuation",
    "test_profile_stages_fills_frame_stats",
    "test_restir_ris_only_unbiased",
    "test_sharded_render_matches_single_device",
    "test_denoise_frame_on_render",
    "test_restir_spatial_open_scene_near_exact",
    "test_gradient_through_production_tiled_pallas",
    "test_train_converges_on_emission",
    "test_graft_entry",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
