"""Test set-up: the CPU platform with 8 virtual devices, so mesh and sharding
code paths run without accelerators (SURVEY.md §4).

``JAX_PLATFORMS`` defaults to ``cpu`` here.  Tests marked ``gpu`` need an
NVIDIA GPU; they skip unless the platform is set to one, as in
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on a machine with a card.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is {dev.platform!r})")
    return dev
