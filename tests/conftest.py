"""Test harness: run everything on a virtual 8-device CPU mesh.

Must set the XLA flags before jax is imported anywhere.
"""

import os

# Tests always run on a virtual 8-device CPU mesh, whatever accelerator
# the machine has, so force-override.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # CPU parity tests use f64

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run tests marked slow (long e2e lanes; also PMV_SLOW=1)",
    )


def pytest_collection_modifyitems(config, items):
    """Default lane skips @pytest.mark.slow so `pytest -q` stays under the
    CI/judge budget (~15 min); the full lane (--runslow / PMV_SLOW=1) must
    stay green and is exercised before perf-affecting commits."""
    if config.getoption("--runslow") or os.environ.get("PMV_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow lane: pass --runslow or PMV_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
