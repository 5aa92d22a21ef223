"""The benchmark's own tests: `python3 -m pytest portbench/tests -q` from the
root of the checkout. Tests marked `card` need a CUDA card; each decides in
the `card` fixture whether there is one, and skips without."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return "cuda"
