"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips with a reason where there is none")
