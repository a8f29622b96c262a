"""Shared fixtures.  NOTE: no XLA_FLAGS here -- smoke tests and benches see
1 CPU device; distributed tests spawn subprocesses that set their own
--xla_force_host_platform_device_count (tests/test_distributed.py)."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")
