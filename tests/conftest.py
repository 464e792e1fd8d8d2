"""Test configuration.

By default the tests run on the CPU backend with an 8-device virtual mesh,
so batched and multi-device sharding logic is exercised without an
accelerator (SURVEY.md section 4).  Tests marked ``gpu`` exercise the
CUDA kernels, which have no CPU form: they skip unless the backend is a
GPU.  ``chip_smoke.py`` runs them on the card; it sets
``LIFEAPI_TEST_PLATFORM=gpu`` so that this file leaves the backend alone.
"""

import os

if os.environ.get("LIFEAPI_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("LIFEAPI_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU (decided per
    test, never at import, so every worker collects the same tests)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these)")
