"""Test configuration: a virtual multi-device CPU mesh by default.

Must run before any jax import (pytest imports conftest first), so the
multi-device sharding paths are testable on any host — the strategy
SURVEY.md §4 calls out as the gap to add over the reference's test
suite.  ``JAX_PLATFORMS`` defaults to ``cpu``; set it to ``cuda`` to run
the ``gpu``-marked tests on a card (see README.md).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Virtual device count: 2 by default (XLA CPU compile time scales with the
# device count and this box has 2 cores; 2 devices already exercise every
# sharding/collective path).  Set GRAMPLE_TEST_DEVICES=8 for thorough runs.
_ndev = os.environ.get("GRAMPLE_TEST_DEVICES", "2")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + f" --xla_force_host_platform_device_count={_ndev}"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# UAI benchmark instances: read from the reference checkout when present
# (read-only data files, never code), else skip the golden-data tests.
RES_DIR = os.environ.get("GRAMPLE_RES", "/root/reference/res")


def res_path(name: str) -> str:
    p = os.path.join(RES_DIR, name)
    if not os.path.exists(p):
        pytest.skip(f"benchmark data {name} not available (set GRAMPLE_RES)")
    return p


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none.

    Decided here, at run time, never at import or collection: every
    xdist worker must collect the same tests."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return devs[0]
