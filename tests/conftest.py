import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding is
# exercised without a GPU (replaces the reference's `mpiexec -n 8`).  When
# a process that already drives a GPU runs the suite (chip_smoke.py runs
# the tests marked `gpu` in-process), its backends are initialized and
# are left as they are.
import jax
from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX reports none.
    Decided here, at run time, so every worker collects the same tests."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip("needs a GPU; JAX reports platform %r" % d.platform)
    return d
