"""Test configuration: run on CPU with 8 virtual devices.

Tests must be hermetic and fast, and the multi-device sharding tests need
several devices, so we force the host platform with 8 virtual CPU devices
before JAX initialises. Checks that need a GPU live in chip_smoke.py.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running (interpret-mode kernel sweeps, "
        "full fit loops); excluded from the quick gate")
    config.addinivalue_line(
        "markers", "fast: quick gate (auto-applied to anything not slow); "
        "run with `pytest -m fast` (< 5 min on one CPU)")


def pytest_collection_modifyitems(config, items):
    # every test is exactly one of {fast, slow}: `-m fast` == `-m "not slow"`
    for item in items:
        if item.get_closest_marker("slow") is None:
            item.add_marker(pytest.mark.fast)
