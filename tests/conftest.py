"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``): the device kernels run
in Pallas interpret mode, and an 8-device virtual CPU mesh stands in for
several cards.  Tests marked ``gpu`` need an NVIDIA GPU: they skip here,
and run on the card with ``python -m pytest -m gpu tests/``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import random  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def rng():
    return random.Random(0x124)


@pytest.fixture
def gpu():
    """The first GPU; the test skips where JAX's backend is not the GPU
    (decided here, when the test runs, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU "
                    "(run on the card: python -m pytest -m gpu tests/)")
    return jax.devices()[0]
