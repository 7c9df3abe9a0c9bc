"""The benchmark's own tests: CPU tests of the harness, and tests marked
`gpu` that run a cell on the card and skip without one. Run them from
the repository's root: `python -m pytest bench_port/tests -q`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the benchmark's cells run there")
    return torch.device("cuda")
