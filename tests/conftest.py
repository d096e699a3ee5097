"""Test configuration: JAX on the CPU with 8 virtual devices by default.

The reference has no CI-friendly backend at all (tests are a single gtest on
Windows); here every test runs on CPU JAX unless JAX_PLATFORMS says
otherwise, and the 8-virtual-device mesh stands in for multi-card sharding
tests (SURVEY.md §4).  Tests of code that runs only on the card carry the
`gpu` marker and the `gpu` fixture, which skips them without a CUDA device;
run them on the card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import os
import pathlib
import sys

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

# JAX reads these when it is first imported, so they are set before the
# package (which imports JAX) is
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
# repeat suite runs load their compiles from a repo-local cache
# (NR_TEST_NO_CACHE=1 disables it, e.g. when timing cold compiles)
if os.environ.get("NR_TEST_NO_CACHE") != "1":
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          str(REPO_ROOT / ".jax_test_cache"))
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2.0")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

from nrenderer_tpu.resources import RESOURCE_DIR  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (MLT statistics/golden "
                          "renders; adds ~30-60 min of compiles)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a CUDA device (decided here, at run time)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device: JAX_PLATFORMS=cuda pytest -m gpu")


@pytest.fixture(scope="session")
def resource_dir() -> pathlib.Path:
    return RESOURCE_DIR


@pytest.fixture(scope="session")
def cornel_scene():
    from nrenderer_tpu import load_scn
    return load_scn(str(RESOURCE_DIR / "path_tracing_cornel.scn"))
