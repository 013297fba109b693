"""Shared fixtures. NOTE: no XLA_FLAGS here by design — unit/smoke tests
must see the real single CPU device; multi-device behaviour is tested via
subprocesses (test_multidevice.py) so the device count is per-process."""

import pytest

try:  # the container image has no hypothesis wheel; use the local fallback
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_fallback

    _hypothesis_fallback.install()


@pytest.fixture(scope="session")
def spark_lines():
    from repro.data.loggen import generate_lines

    return list(generate_lines("Spark", 2500, seed=7))


@pytest.fixture(scope="session")
def hdfs_lines():
    from repro.data.loggen import generate_lines

    return list(generate_lines("HDFS", 2500, seed=11))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of repro_torch); skips without one")
