"""Test configuration.

Forces an 8-virtual-device CPU platform before jax initialises, so sharding
and collective tests run on any machine (the multi-chip dry-run validation
path; see SURVEY.md §4: XLA_FLAGS=--xla_force_host_platform_device_count=N).
"""

import os

# The tests run on the CPU backend, whatever accelerator the machine has:
# the config update below must run before the first backend initialisation
# (i.e. before any test imports trigger device use).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
