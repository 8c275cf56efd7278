"""Tests of the benchmark's own parts, on the CPU at small sizes; tests
marked ``cuda`` need the card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The first CUDA device; skips the test without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
