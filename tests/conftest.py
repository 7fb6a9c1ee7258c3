"""Test harness: the CPU with 8 virtual devices, so sharding and collective
code paths run without accelerators (SURVEY.md §4).

JAX_PLATFORMS defaults to "cpu". On a machine with a card, the tests marked
`gpu` run with `JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/`: the
CPU stays the default device and the `gpu_device` fixture hands out the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compile cache: the suite is compile-heavy (each jitted program
# is shape-specialized); caching across runs keeps the suite fast.
enable_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none. Decided here, at
    run time, never at import or collection."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: run with JAX_PLATFORMS=cpu,cuda "
                    "on a machine with the card")
