"""Test harness config.

With ``JAX_PLATFORMS`` unset the tests run on the CPU backend with 8
virtual devices, so sharding tests run without several cards. Set
``JAX_PLATFORMS`` to pick another backend: ``JAX_PLATFORMS=cuda python -m
pytest tests -m gpu`` runs the tests marked ``gpu`` on the card. Must run
before jax initializes a backend."""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise. Tests
    marked ``gpu`` take this fixture, so the choice is made when the test
    runs, never while modules are collected."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev
