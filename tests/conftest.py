"""Test harness configuration.

Tests run on the CPU: a virtual 8-device mesh (multi-device sharding is
validated without cards) with float64 enabled so golden-value comparisons
against the sympy/scipy oracles are meaningful.  Pallas kernels run in
interpret mode.  What only a GPU can run is a phase of chip_smoke.py; a
test that needs the card carries the ``gpu`` marker and is skipped, from the
fixture below, where JAX sees no GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU; run chip_smoke.py on the card")
