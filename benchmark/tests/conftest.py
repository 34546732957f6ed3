"""The benchmark's tests: on the CPU, and marked ``card`` where they need
an NVIDIA card (they skip without one, decided inside the ``card``
fixture, never at import).  Run with ``python -m pytest benchmark/tests``
from the repository's root; on the card's machine the ``card`` tests run
too."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: no CUDA device here")
    return torch.device("cuda", 0)
