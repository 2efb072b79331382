"""Test configuration: run on a virtual 8-device CPU mesh.

Mirrors the reference's 1-vs-N-thread testing strategy (SURVEY.md §4.7):
tests compare single-device vs sharded execution on
xla_force_host_platform_device_count=8 virtual CPU devices. If jax was
imported before this file runs, the env var alone is too late, so the
already-imported config is flipped as well.

Device mode (the analog of the reference's CUDA-vs-CPU equivalence
tests, cuda_dense_cholesky_test.cc / cuda_vector_test.cc): set
``CERES_DEVICE_TESTS=1`` to leave the accelerator platform active and
run the curated device subset in ONE process (each JAX process reserves
most of a GPU's memory, so pytest-xdist workers would starve each other):

    CERES_DEVICE_TESTS=1 python -m pytest tests/ -q -m device -p no:xdist

Tests that require the 8-device virtual CPU mesh are marked
``needs_mesh`` and auto-skip in device mode.
"""

import os

_DEVICE_MODE = os.environ.get("CERES_DEVICE_TESTS", "") == "1"

if not _DEVICE_MODE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _DEVICE_MODE:
    jax.config.update("jax_platforms", "cpu")
else:
    from ceres_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()


import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "device: curated subset meant to run on the accelerator "
        "(CERES_DEVICE_TESTS=1 pytest -m device -p no:xdist)")
    config.addinivalue_line(
        "markers", "needs_mesh: requires the 8-device virtual CPU mesh; "
        "skipped in device mode")
    config.addinivalue_line(
        "markers", "slow: long-running tier (torture/fuzz/large-scale); "
        "skipped by default, run with --runslow or CERES_RUN_SLOW=1")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (the full tier; default run <5 min)")


def pytest_collection_modifyitems(config, items):
    if _DEVICE_MODE:
        skip_mesh = pytest.mark.skip(
            reason="needs 8-device virtual CPU mesh; running on the device")
        for item in items:
            if "needs_mesh" in item.keywords:
                item.add_marker(skip_mesh)
    run_slow = (
        config.getoption("--runslow")
        or os.environ.get("CERES_RUN_SLOW", "") == "1"
    )
    if not run_slow:
        skip_slow = pytest.mark.skip(
            reason="slow tier; use --runslow (or CERES_RUN_SLOW=1)")
        for item in items:
            if "slow" in item.keywords:
                item.add_marker(skip_slow)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables at module boundaries.

    A full-suite run accumulates ~1500 XLA:CPU executables in one
    process and deterministically segfaults inside
    backend_compile_and_load near the end (reproduced twice at the same
    collection index; every module passes in isolation). Dropping the
    executable caches between modules keeps the compiler state bounded.
    """
    yield
    jax.clear_caches()
