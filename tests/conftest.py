"""Test harness config: the CPU with 8 virtual devices by default.

The suite runs the plain blockwise path, the Pallas kernel in interpret
mode, and the sharding tests on the 8-device virtual mesh.  Tests marked
``gpu`` take the ``gpu`` fixture and skip unless JAX runs on a GPU; run
them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)
# XLA:CPU's default matmul precision is bf16-grade; golden comparisons need
# exact fp32 accumulation.
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda on the card)")
