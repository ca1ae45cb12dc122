"""Test configuration: force the CPU backend with 8 virtual devices.

Mirrors the survey's test strategy (SURVEY.md §4): multi-device behavior is
validated on a simulated 8-device CPU mesh so CI needs no accelerator.
Tests that need the GPU take the `gpu` fixture, which skips them here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"

# Quick tier: whole modules whose tests trace the full-size scene or chain
# full engine frames are marked `slow`; `pytest -m "not slow"` runs the
# fast unit/parity tier.
_SLOW_MODULES = {
    "test_parity_at_scale",
    "test_parallel",
    "test_bench_configs",
    "test_emissive_temporal",
    "test_engine",
}


@pytest.fixture(scope="session")
def gpu():
    """Skips the test unless JAX sees a GPU. This process stays pinned to
    the CPU, so the probe runs in a child without the pin."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip() != "gpu":
        pytest.skip("needs a GPU; JAX found "
                    f"{probe.stdout.strip() or probe.stderr[-200:]!r}")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
