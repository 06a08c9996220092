"""Test configuration.

Tier-1 tests run on the CPU with 8 virtual devices, so the sharding
tests work without several accelerators (SURVEY.md §4e), and with x64
enabled so the solver can be exercised in the reference's double
precision.  Framework code specifies dtypes explicitly, so enabling x64
does not change f32 paths.  Tests marked `chip` need a GPU and skip here;
`python chip_smoke.py` runs the same checks on the card.
"""

import os

# Must happen before the first backend use.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
# the repo root: bench.py and chip_smoke.py live there
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The GPU for tests marked `chip`; skips anywhere else.  Decided
    here, at run time, never while modules are imported: tier-1 runs pin
    the CPU, and `python chip_smoke.py` runs the same phases on the card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return dev
