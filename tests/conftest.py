"""Test harness: run everything on a virtual 8-device CPU mesh.

Must set env before jax initializes (SURVEY.md §4.5 — the JAX-native way to
fake a multi-chip mesh without a pod).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from pathlib import Path

import jax
import numpy as np
import pytest

# Allow f64 oracle tests; production code passes explicit dtypes throughout.
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    """Unit tests run on the CPU backend, with f64 and a virtual 8-device
    mesh. Only `-m gpu` (the tests marked gpu, run on the card) keeps JAX's
    default platform; those tests skip by fixture where there is no GPU."""
    if config.getoption("markexpr", "") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")

REFERENCE_DATA = Path("/root/reference/PS_AIS_Simplification/data")


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same deterministic stream
    # regardless of execution order.
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def reference_data_dir():
    if not REFERENCE_DATA.exists():
        pytest.skip("reference data not available")
    return REFERENCE_DATA
