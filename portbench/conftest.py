"""pytest settings of the benchmark's own tests (``python -m pytest
portbench -q``): the ``cuda`` marker, and the ``card`` fixture, which
skips a test without a CUDA card (decided when the test runs, never at
import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return "cuda"
