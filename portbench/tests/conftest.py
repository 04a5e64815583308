"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Tests marked ``card`` need CUDA and skip elsewhere; whether there is a
card is decided inside the ``card`` fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
