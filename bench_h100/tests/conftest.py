"""The benchmark's tests: CPU tests at tiny sizes, and tests marked
``chip`` that need a CUDA card and skip without one (decided inside the
``card`` fixture, never while a module is imported).  On the card:

    python3 -m pytest -q bench_h100/tests -m chip
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
