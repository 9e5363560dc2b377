"""The benchmark's own tests. They import no JAX and run here on the CPU
(`python -m pytest gpubench/tests -q`); those marked `cuda` need the card
and skip without one (`python -m pytest gpubench/tests -q -m cuda` on
the card)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where CUDA is absent)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
