"""Pytest settings of the benchmark's own tests (``python -m pytest bench_h100``)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA card; skipped where there is none")
