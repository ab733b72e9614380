"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the root of a checkout. Tests that need a CUDA card carry the ``cuda``
marker and skip without one, deciding inside the test."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card")
    return torch.device("cuda")
