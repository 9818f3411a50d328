import os
import sys

import pytest

# Make the repo root importable without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The suite runs on the CPU: sharding tests use a virtual 8-device mesh and
# Pallas kernels run in interpret mode.  Tests marked ``gpu`` need the card
# and are run there by ``chip_smoke.py`` (see README "Testing").
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
if os.environ.get("GT4PY_TPU_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"


@pytest.fixture
def all_kernel_classes(monkeypatch):
    """Send every stencil class to the column kernel (the default rule
    leaves all-PARALLEL stencils to XLA), so kernel numerics are tested
    for every class."""
    from gt4py_tpu.cartesian.backend import pallas_backend

    monkeypatch.setattr(pallas_backend, "KERNEL_CLASSES", pallas_backend.ALL_CLASSES)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")
