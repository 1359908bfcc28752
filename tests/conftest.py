"""Test configuration.

Forces 8 virtual CPU devices and routes all computation to the CPU backend
so the suite is fast and multi-device sharding paths run without several
GPUs.  Tests marked ``gpu`` need an NVIDIA GPU; they take the ``gpu``
fixture, which skips when JAX sees none and otherwise runs the test with
the GPU as the default device:

    python -m pytest -m gpu tests/ -p no:xdist
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

# XLA:CPU compile times dominate the suite; the persistent cache makes
# reruns cheap.
from spllt_tpu.utils.jaxconfig import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips when JAX sees none)")


@pytest.fixture
def gpu():
    """The first GPU device, made the default for the test; skips when
    JAX has no GPU backend (decided here, never at import time)."""
    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
    with jax.default_device(dev):
        yield dev
