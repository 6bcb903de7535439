"""Test configuration: the CPU tier on 8 virtual CPU devices.

The CPU tier runs on 8 virtual CPU devices so the multi-device sharding
paths are exercised without a multi-GPU host (SURVEY.md §4). JAX_PLATFORMS
defaults to ``cpu`` here; tests marked ``gpu`` take the ``gpu`` fixture,
which skips them unless the default device is a CUDA GPU. Run those on the
card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA GPU (decided when the
    test runs, never at import or collection)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (the compiled Triton kernel has no "
                    "CPU form; chip_smoke.py runs the same checks on the card)")


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: tests listed in slow_tests.txt
    (>= 15 s measured on the CI rig) get the `slow` marker, so the default
    CI tier `-m "not slow"` finishes in minutes while covering every
    subsystem at toy size. Exceptions kept fast for sole-coverage reasons
    are simply absent from the list (two-process multihost, scheduled
    solve, one bf16-coefficient pin). The full suite runs everything.
    """
    import pytest as _pytest

    listed = set()
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    try:
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if ln and not ln.startswith("#"):
                    listed.add(ln)
    except OSError:
        return
    for item in items:
        nodeid = item.nodeid.replace("\\", "/")
        if not nodeid.startswith("tests/"):
            nodeid = "tests/" + nodeid.split("tests/")[-1]
        if nodeid in listed:
            item.add_marker(_pytest.mark.slow)
