"""Tests of the benchmark harness. Those that need a CUDA card carry the
`chip` marker and skip here, deciding inside the test; run them on the card
with `python3 -m pytest benchmark/tests -m chip`."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
