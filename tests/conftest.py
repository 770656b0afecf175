"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding tests use
``--xla_force_host_platform_device_count=8`` exactly as recommended for
single-host multi-device JAX testing.  Must run before jax is imported.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(seed=3939)
