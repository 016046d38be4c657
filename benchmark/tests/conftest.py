"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

Tests marked ``cuda`` need a CUDA device and skip where there is none;
the decision is taken inside the ``cuda_device`` fixture."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
