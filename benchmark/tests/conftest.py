"""Tests of the benchmark harness (``python -m pytest benchmark/tests``).

Tests marked ``card`` need an NVIDIA GPU; each decides inside the test
whether one is there and skips otherwise.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
