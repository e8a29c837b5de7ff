"""Markers of the benchmark's own tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skipped "
        "without one")
