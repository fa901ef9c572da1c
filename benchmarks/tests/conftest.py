"""Tests of the benchmark harness, on the CPU at tiny sizes; those marked
`cuda` need a card and skip without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)
