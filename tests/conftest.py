import os
import sys

# Device tests run on a virtual 8-device CPU mesh; must be set before jax
# import anywhere in the test process.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Tests run on a virtual 8-device CPU mesh whatever accelerator the
# machine has; jax.config.update is the reliable override regardless of
# env inheritance order.
try:
    import jax

    jax.config.update("jax_platforms", "cpu")
    # XLA compile time dominates the device-kernel tests on CPU; a
    # persistent compilation cache makes re-runs near-instant. Where
    # JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself.
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _cache_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache",
        )
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
except ImportError:
    pass

sys.setrecursionlimit(100_000)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (XLA:CPU kernel compiles, full "
        "circomlib interop suite: adds ~30+ minutes)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or config.getoption("markexpr"):
        return
    skip = pytest.mark.skip(reason="slow: run with --runslow (or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu_backend():
    """Skip unless JAX runs on a GPU (decided here, never at import:
    xdist workers must collect identical test lists).  The suite pins
    the CPU backend, so these tests run through chip_smoke.py."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on "
                    "the card")
