"""The benchmark's CPU tests and its card tests (marker ``card``: they skip
here and run on a machine with an NVIDIA card)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")
