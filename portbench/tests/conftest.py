"""Tests of the benchmark harness.  CPU tests run anywhere (tiny cells,
`--device cpu`); tests marked `cuda` need a card and skip without one.

    python3 -m pytest portbench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with a reason elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
