"""Test harness configuration.

Tests run on CPU with 8 virtual devices so multi-card sharding paths
(packet data-parallel, slab FFT) execute without accelerators. A run that
sets ``JAX_PLATFORMS`` keeps that choice: the ``gpu``-marked tests need
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on a GPU host and
skip elsewhere (``gpu`` fixture below).
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, so every test worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
