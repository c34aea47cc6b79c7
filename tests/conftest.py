"""Test configuration: force an 8-device virtual CPU mesh.

The tests run on the CPU: the standard JAX trick splits the host CPU into 8
virtual devices so every sharding/collective path compiles and runs as it
would on a multi-device mesh.  Pallas kernels run in interpret mode.  Tests
that need the GPU carry the ``gpu`` marker and skip here (``gpu`` fixture).
"""

import os

import pytest

# the platform is fixed both in the environment and, after import, in the
# config, so an installed accelerator plugin cannot take over
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """The first device, for tests marked ``gpu``; skips without a GPU.

    Decided here, at run time, never at import: the test workers must all
    collect the same tests."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {device.platform})")
    return device
