"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU with nvcc (the port's CUDA kernels); "
        "skipped with a reason on hosts without one")
